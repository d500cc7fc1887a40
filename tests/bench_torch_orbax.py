"""Throughput of the port's zstd decoder (``checkpoint/zstd.py``) on the
chunks of a real checkpoint, beside the ``zstandard`` module.

Saves the d512 seed (``checkpoints/r5_d512x12_seed/asr.npz``) with the JAX
package's ``save_checkpoint`` (Orbax, zstd chunks) into a temporary
directory, then times the port's decoder alone on every chunk, the same
chunks through ``zstandard``, and the port's ``orbax.read_flat`` of the
whole checkpoint. Prints one JSON line. A CPU script, not a test:

    JAX_PLATFORMS=cpu python tests/bench_torch_orbax.py
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def bench(seed_dir: Path = REPO / "checkpoints" / "r5_d512x12_seed") -> dict:
    import zstandard

    from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
    from omnilingual_asr_tpu.models import zoo as jax_zoo
    from omnilingual_asr_torch.checkpoint import ocdbt, orbax, zstd

    jcfg = JaxConfig.from_json((seed_dir / "config.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "asr"
        t0 = time.perf_counter()
        jax_zoo.save_checkpoint(path, jax_zoo.load_checkpoint(
            seed_dir / "asr.npz", jcfg))
        save_s = time.perf_counter() - t0
        store = ocdbt.Store(path)
        chunks = [store.read(k) for k in store.list()
                  if not k.endswith(".zarray")]
        dec = zstandard.ZstdDecompressor()
        out_bytes = sum(len(dec.decompress(c, max_output_size=1 << 31))
                        for c in chunks)
        t0 = time.perf_counter()
        for c in chunks:
            zstd.decompress(c)
        zstd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for c in chunks:
            dec.decompress(c, max_output_size=1 << 31)
        zstandard_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        flat = orbax.read_flat(path)
        read_s = time.perf_counter() - t0
    return {"leaves": len(flat), "chunks": len(chunks),
            "chunk_mb": out_bytes / 1e6, "jax_save_s": save_s,
            "zstd_mb_s": out_bytes / 1e6 / zstd_s,
            "zstandard_mb_s": out_bytes / 1e6 / zstandard_s,
            "read_flat_s": read_s}


if __name__ == "__main__":
    print(json.dumps(bench()))
