"""Golden fixture of the PyTorch port: the JAX engine's result on 7.6 s of
synthetic speech, stored in ``omnilingual_asr_torch/testdata``.

The tests regenerate the audio and the JAX result on the CPU and assert that
the committed files are current, then hold the port's CPU result to them by
the criterion of ``omnilingual_asr_torch.testing``. ``chip_smoke.py`` holds
the card's result to the same JSON.

Regenerate the files with ``JAX_PLATFORMS=cpu OMNIASR_RELEASE_DIR=
python tests/test_torch_golden.py``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from omnilingual_asr_torch import testing as golden  # noqa: E402

torch.set_num_threads(2)

RELEASE = REPO / "checkpoints" / "release"
GOLDEN_SEED = 3           # eval_set seed: two speakers, languages, emotions
GOLDEN_CANDIDATES = 5
GOLDEN_MAX_S = 9.3        # keeps golden.wav under 300 KB of int16
GOLDEN_GAP_S = 1.0        # silence between utterances: a turn boundary


def golden_samples() -> np.ndarray:
    """Utterances of ``eval_set(5, seed=3)`` in order, 1 s of silence
    apart, skipping any that would push the total past 9.3 s; int16 at
    16 kHz."""
    from omnilingual_asr_tpu.train.synth import eval_set

    gap = np.zeros(int(GOLDEN_GAP_S * 16_000), np.float32)
    parts, total = [], 0
    for ex in eval_set(GOLDEN_CANDIDATES, seed=GOLDEN_SEED):
        need = len(ex.samples) + (len(gap) if parts else 0)
        if total + need <= GOLDEN_MAX_S * 16_000:
            parts.extend([gap, ex.samples] if parts else [ex.samples])
            total += need
    audio = np.concatenate(parts).astype(np.float32)
    return np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)


def wav_bytes(pcm: np.ndarray, sr: int = 16_000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def jax_engine():
    import jax
    from omnilingual_asr_tpu.config import MeshConfig, PipelineConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    return TranscriptionEngine(
        config=cfg, xvector_path=str(RELEASE / "xvector.npz"),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]),
        batch_windows_per_device=4)


def greedy_ids(engine, path: Path):
    """Per-window greedy CTC ids over valid frames (either engine)."""
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    ids = []
    for outs in engine._forward_batches(windows, n_last):
        ids.extend(np.asarray(o["ctc_ids"]).astype(int).tolist()
                   for o in outs)
    return ids


def jax_golden(path: Path) -> dict:
    eng = jax_engine()
    res = eng.transcribe(path)
    return {"result": dataclasses.asdict(res),
            "ctc_ids": greedy_ids(eng, path)}


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    pcm = golden_samples()
    path = tmp_path_factory.mktemp("golden") / "golden.wav"
    path.write_bytes(wav_bytes(pcm))
    return path, jax_golden(path)


def test_golden_wav_is_current(regenerated):
    path, _ = regenerated
    assert golden.GOLDEN_WAV.read_bytes() == path.read_bytes()
    assert golden.GOLDEN_WAV.stat().st_size <= 300_000


def test_golden_json_is_current(regenerated):
    # The stored JAX result equals a fresh JAX run by the port's own
    # criterion (exact texts/speakers/languages/emotions, 40 ms times,
    # 99.5 % ids): XLA:CPU's summation order may differ across host CPUs.
    _, fresh = regenerated
    stored = golden.load_golden()
    assert golden.result_mismatches(stored["result"], fresh["result"]) == []
    assert golden.ctc_agreement(stored["ctc_ids"], fresh["ctc_ids"]) >= \
        golden.MIN_CTC_AGREEMENT


def test_golden_has_content():
    stored = golden.load_golden()
    segs = stored["result"]["segments"]
    assert len(segs) >= 2
    assert len({s["speaker"] for s in segs}) >= 2
    assert all(s["text"] for s in segs)


def test_port_cpu_matches_golden():
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    eng = TranscriptionEngine(config=cfg, device="cpu",
                              xvector_path=str(RELEASE / "xvector.npz"))
    res = eng.transcribe(golden.GOLDEN_WAV)
    stored = golden.load_golden()
    assert golden.result_mismatches(stored["result"], res.to_dict()) == []
    agree = golden.ctc_agreement(stored["ctc_ids"],
                                 greedy_ids(eng, golden.GOLDEN_WAV))
    assert agree >= golden.MIN_CTC_AGREEMENT


def main() -> None:
    os.environ.setdefault("OMNIASR_RELEASE_DIR", "")
    pcm = golden_samples()
    golden.TESTDATA.mkdir(parents=True, exist_ok=True)
    golden.GOLDEN_WAV.write_bytes(wav_bytes(pcm))
    data = jax_golden(golden.GOLDEN_WAV)
    golden.GOLDEN_JSON.write_text(json.dumps(data, ensure_ascii=False,
                                             separators=(",", ":")) + "\n")
    print(f"wrote {golden.GOLDEN_WAV} ({len(pcm) / 16000:.2f} s) and "
          f"{golden.GOLDEN_JSON}")


if __name__ == "__main__":
    main()
