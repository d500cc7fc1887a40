"""PyTorch port: ``TranscriptionEngine`` on a (data, model) mesh whose
``model`` axis is above 1 (tensor parallelism), held to the engine without
a model axis, to the JAX engine on the same mesh of host devices and, with
the release weights, to ``golden.json``.

The port's meshes are shards on the CPU (``[cpu] * n``); the JAX engine
runs on the 8 host devices that ``tests/conftest.py`` forces.
"""

from __future__ import annotations

import dataclasses
import io
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import MeshConfig, PipelineConfig
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.parallel import mesh as pm

torch.set_num_threads(2)

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
RELEASE = REPO / "checkpoints" / "release"
WINDOW_SECONDS = 10.0
# Two tiny engines whose forwards differ only in f32 order (the sums over
# the model shards): their greedy ids on at least this share of frames.
MIN_TP_AGREEMENT = 0.999


def _tiled(path: Path, seconds: float) -> Path:
    with wave.open(str(golden.GOLDEN_WAV), "rb") as w:
        params = w.getparams()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setparams(params)
        w.writeframes(np.resize(pcm, int(seconds * 16_000)).tobytes())
    path.write_bytes(buf.getvalue())
    return path


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    return _tiled(tmp_path_factory.mktemp("tp") / "tp.wav", 30.0)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX package's tiny config and seeded parameters, and the port's
    copy of both."""
    from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
    from omnilingual_asr_tpu.models.conformer import asr_init

    jcfg = jax_tiny_config()
    jp = asr_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tiny_config(), zoo.params_from_jax(jp)


def _mesh(data: int, model: int):
    return pm.build_mesh(MeshConfig(data=data, model=model),
                         [CPU] * (data * model))


def _ids(engine, path):
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    return [o["ctc_ids"].astype(int).tolist()
            for outs in engine._forward_batches(windows, n_last)
            for o in outs]


def _engine(cfg, params, mesh, **kw):
    kw.setdefault("speaker_mode", "inline")
    return TranscriptionEngine(config=cfg, params=params, mesh=mesh,
                               window_seconds=WINDOW_SECONDS,
                               batch_windows_per_device=2, **kw)


def test_tp_engine_equals_no_model_axis_and_jax(wav, jax_tiny):
    """A tiny engine at (2, 2) against one at (2, 1): the same segments,
    greedy ids on MIN_TP_AGREEMENT; and against the JAX engine at (2, 2)
    on host devices with the same parameters, by the golden criterion."""
    from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build

    jcfg, jp, cfg, params = jax_tiny
    tp = _engine(cfg, params, _mesh(2, 2))
    dp = _engine(cfg, params, _mesh(2, 1))
    assert [len(r.shards) for r in tp._replicas] == [2, 2]
    assert tp._replicas[0] is tp._replicas[1]     # rows on one device
    got, want = tp.transcribe(wav).to_dict(), dp.transcribe(wav).to_dict()
    assert len(got["segments"]) >= 3
    assert golden.result_mismatches(want, got) == []
    assert golden.ctc_agreement(_ids(dp, wav), _ids(tp, wav)) >= \
        MIN_TP_AGREEMENT
    jeng = JaxEngine(config=jcfg.replace(mesh=JaxMeshConfig(data=2,
                                                            model=2)),
                     params=jp, speaker_mode="inline",
                     window_seconds=WINDOW_SECONDS,
                     batch_windows_per_device=2,
                     mesh=jax_build(JaxMeshConfig(data=2, model=2),
                                    devices=jax.devices()[:4]))
    jres = dataclasses.asdict(jeng.transcribe(wav))
    assert golden.result_mismatches(jres, got) == []


def test_tp_engine_quantize_true_serves(wav, jax_tiny):
    """quantize=True at model 2 (int8 leaves split as the reference's
    quantize_spec_tree places them, dequantized into the bf16 products)
    equals quantize=True without a model axis."""
    _, _, cfg, params = jax_tiny
    tp = _engine(cfg, params, _mesh(1, 2), quantize=True)
    one = _engine(cfg, params, _mesh(1, 1), quantize=True)
    w_q = tp._replicas[0].shards[0]["blocks"][0]["ffn1"]["w1"]["w_q"]
    assert w_q.dtype == torch.int8 and w_q.shape[1] == 4 * 128 // 2
    got, want = tp.transcribe(wav).to_dict(), one.transcribe(wav).to_dict()
    assert golden.result_mismatches(want, got) == []
    assert golden.ctc_agreement(_ids(one, wav), _ids(tp, wav)) >= \
        MIN_TP_AGREEMENT


def test_tp_engine_crop_and_streaming(wav, jax_tiny):
    """Crop re-embedding at model 2 (the trunk's plain attention and conv
    on the shards) equals crop without a model axis; streaming at model 2
    ends in transcribe's result."""
    _, _, cfg, params = jax_tiny
    tp = _engine(cfg, params, _mesh(1, 2), speaker_mode="crop")
    one = _engine(cfg, params, _mesh(1, 1), speaker_mode="crop")
    assert tp._crop_shards is not None
    got, want = tp.transcribe(wav).to_dict(), one.transcribe(wav).to_dict()
    assert golden.result_mismatches(want, got) == []
    events = list(tp.transcribe_streaming(wav))
    final = events[-1]
    assert final[0] == "final"
    assert golden.result_mismatches(got, final[1].to_dict()) == []


def test_tp_engine_sequence_mode(jax_tiny, tmp_path):
    """Sequence mode on a (2, 2) mesh runs over the data axis on the
    parameters gathered per data row (as the reference passes them
    replicated): equal to sequence mode on (2, 1)."""
    _, _, cfg, params = jax_tiny
    path = _tiled(tmp_path / "s.wav", 12.0)
    got = _engine(cfg, params, _mesh(2, 2),
                  long_mode="sequence").transcribe(path).to_dict()
    want = _engine(cfg, params, _mesh(2, 1),
                   long_mode="sequence").transcribe(path).to_dict()
    assert got == want


def test_tp_engine_moe_alltoall(wav):
    """A mixture-of-experts engine at (1, 2) with all-to-all dispatch
    inside the blocks (each shard's own experts, capacity where nothing
    drops) against the dense engine without a model axis."""
    cfg = tiny_config()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, n_experts=4, moe_dispatch="alltoall",
        moe_capacity_factor=16.0))
    from omnilingual_asr_torch.models.conformer import asr_init

    params = asr_init(torch.Generator().manual_seed(2), cfg)
    tp = _engine(cfg, params, _mesh(1, 2))
    dense = _engine(cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, moe_dispatch="dense")), params, _mesh(1, 1))
    assert tp._replicas[0].shards[0]["blocks"][0]["ffn2"]["w1"].shape[0] == 2
    assert golden.ctc_agreement(_ids(dense, wav), _ids(tp, wav)) >= \
        MIN_TP_AGREEMENT


def test_release_request_at_model_2_matches_golden():
    """One release-weight request at (1, 2) on the CPU, held to the JAX
    engine's golden.json by testing.py's criterion."""
    cfg = PipelineConfig.from_json((RELEASE / "config.json").read_text(),
                                   checkpoint_path=str(RELEASE / "asr.npz"))
    eng = TranscriptionEngine(config=cfg,
                              xvector_path=str(RELEASE / "xvector.npz"),
                              mesh=_mesh(1, 2))
    res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
    stored = golden.load_golden()
    assert golden.result_mismatches(stored["result"], res,
                                    tone_mass=stored["tone_mass"]) == []
    assert golden.ctc_agreement(stored["ctc_ids"],
                                _ids(eng, golden.GOLDEN_WAV)) >= \
        golden.MIN_CTC_AGREEMENT
