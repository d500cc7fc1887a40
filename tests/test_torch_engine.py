"""PyTorch port: ``TranscriptionEngine`` end to end against the JAX engine,
plus the port's entry-point rules.

Both engines are built from the release ``config.json`` with explicit
``checkpoint_path=asr.npz`` and ``xvector_path=xvector.npz`` (conftest
disables release discovery), and both transcribe the same WAV files of
``train/synth.py::eval_set`` utterances. The criterion is
``omnilingual_asr_torch.testing``'s: identical texts, speakers, languages
and emotions, segment and word times within one subsampled frame (40 ms),
greedy CTC ids equal on at least 99.5 % of valid frames.
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
from omnilingual_asr_torch.config import ChunkingConfig, DecodeConfig
from omnilingual_asr_torch.config import PipelineConfig, tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RELEASE = REPO / "checkpoints" / "release"
E2E_SEED = 424_242     # fixed before any result was seen
E2E_COUNT = 12         # 33.6 s: two windows, the second one partial
STAGES = {"decode", "forward", "extract", "assemble", "assemble.cluster",
          "assemble.segments", "assemble.translate", "assemble.summary"}


def _write_wav(path: Path, audio: np.ndarray) -> Path:
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())
    path.write_bytes(buf.getvalue())
    return path


@pytest.fixture(scope="module")
def long_wav(tmp_path_factory):
    from omnilingual_asr_tpu.train.synth import eval_set

    audio = np.concatenate([e.samples for e in eval_set(E2E_COUNT,
                                                         seed=E2E_SEED)])
    path = _write_wav(tmp_path_factory.mktemp("e2e") / "long.wav", audio)
    assert len(audio) > 30 * 16_000, "the file must span two windows"
    assert len(audio) % (30 * 16_000) != 0, "the last window is partial"
    return path


def _release_config(cls, **overrides):
    return cls.from_json((RELEASE / "config.json").read_text(),
                         checkpoint_path=str(RELEASE / "asr.npz"),
                         **overrides)


@pytest.fixture(scope="module")
def jax_engine():
    from omnilingual_asr_tpu.config import MeshConfig
    from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    return JaxEngine(config=_release_config(JaxConfig),
                     xvector_path=str(RELEASE / "xvector.npz"),
                     mesh=build_mesh(MeshConfig(data=1),
                                     devices=jax.devices()[:1]),
                     batch_windows_per_device=4)


@pytest.fixture(scope="module")
def port_engine():
    return TranscriptionEngine(config=_release_config(PipelineConfig),
                               xvector_path=str(RELEASE / "xvector.npz"),
                               device="cpu")


def _ids(engine, path):
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    return [np.asarray(o["ctc_ids"]).astype(int).tolist()
            for outs in engine._forward_batches(windows, n_last)
            for o in outs]


@pytest.mark.parametrize("hints", [
    {},
    {"language": "en", "speaker_count": "2"},
])
def test_transcribe_matches_jax_engine(jax_engine, port_engine, long_wav,
                                       hints):
    want = dataclasses.asdict(jax_engine.transcribe(long_wav, **hints))
    got = port_engine.transcribe(long_wav, **hints).to_dict()
    assert len(want["segments"]) >= 4
    assert golden.result_mismatches(want, got) == []


def test_greedy_ctc_ids_match_jax_engine(jax_engine, port_engine, long_wav):
    want, got = _ids(jax_engine, long_wav), _ids(port_engine, long_wav)
    assert len(want) == len(got) == 2
    assert [len(w) for w in want] == [len(g) for g in got]
    assert golden.ctc_agreement(want, got) >= golden.MIN_CTC_AGREEMENT


def test_stage_names_match_jax_engine(jax_engine, port_engine, long_wav):
    jax_engine.transcribe(long_wav)
    port_engine.transcribe(long_wav)
    assert set(port_engine.last_trace.stages) == STAGES
    assert set(jax_engine.last_trace.stages) == STAGES
    assert port_engine.last_trace.audio_seconds == pytest.approx(
        jax_engine.last_trace.audio_seconds)


def test_progress_contract(port_engine, long_wav):
    calls = []
    port_engine.transcribe(long_wav,
                           progress_callback=lambda s, i: calls.append((s, i)))
    assert calls == [("uploading", 0), ("transcribing", 1),
                     ("processing", 2), ("done", 3)]
    frac = []
    port_engine.transcribe(
        long_wav, progress_callback=lambda s, i, f=None: frac.append((s, i, f)))
    steps = [c for c in frac if c[2] is None]
    fractions = [c for c in frac if c[2] is not None]
    assert [(s, i) for s, i, _ in steps] == [c for c in calls]
    assert fractions == [("transcribing", 1, 1.0)]   # one batch


def test_retry_and_chunked_entry_points(port_engine, long_wav):
    base = port_engine.transcribe(long_wav).to_dict()
    assert port_engine.transcribe_chunked(long_wav).to_dict() == base
    assert port_engine.transcribe_with_retry(long_wav).to_dict() == base


def test_streamed_long_wav_equals_whole_decode(port_engine, long_wav):
    """Past the chunking threshold, windows stream off the WAV (no decode
    stage) and the result is the same."""
    cfg = port_engine.config.replace(
        chunking=ChunkingConfig(min_duration_for_chunking_s=20.0))
    eng = TranscriptionEngine(config=cfg, params=port_engine.params,
                              xvector_params=port_engine._xvector,
                              device="cpu")
    streamed = eng.transcribe(long_wav).to_dict()
    assert "decode" not in eng.last_trace.stages
    assert streamed == port_engine.transcribe(long_wav).to_dict()


def test_multi_batch_progress(port_engine, long_wav):
    """With one window per batch, step 1 reports one fraction per batch."""
    eng = TranscriptionEngine(config=port_engine.config,
                              params=port_engine.params,
                              xvector_params=port_engine._xvector,
                              device="cpu", batch_windows_per_device=1)
    frac = []
    res = eng.transcribe(long_wav,
                         progress_callback=lambda s, i, f=None: frac.append(f))
    assert [f for f in frac if f is not None] == [0.5, 1.0]
    assert res.to_dict() == port_engine.transcribe(long_wav).to_dict()


# ---------------------------------------------------------------------------
# Int8 serving on tiny_config: both engines on the same random weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_weights():
    """JAX-initialised tiny_config ASR and x-vector weights, in both
    packages' trees (tiny_config's FFN up-projections, 128 -> 512, are the
    layers the kernels take)."""
    from omnilingual_asr_tpu.config import tiny_config as jax_tiny
    from omnilingual_asr_tpu.models.conformer import asr_init
    from omnilingual_asr_tpu.models.xvector import xvector_init
    from omnilingual_asr_torch.models import zoo

    jcfg = jax_tiny()
    jp = asr_init(jax.random.PRNGKey(0), jcfg)
    jx = xvector_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, jx, zoo.params_from_jax(jp), zoo.params_from_jax(jx)


def _tiny_engines(tiny_weights, quantize):
    from omnilingual_asr_tpu.config import MeshConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    jcfg, jp, jx, tp, tx = tiny_weights
    common = dict(quantize=quantize, speaker_mode="inline",
                  batch_windows_per_device=1)
    jax_eng = JaxEngine(config=jcfg, params=jp, xvector_params=jx,
                        mesh=build_mesh(MeshConfig(data=1),
                                        devices=jax.devices()[:1]), **common)
    port = TranscriptionEngine(config=tiny_config(), params=tp,
                               xvector_params=tx, device="cpu", **common)
    return jax_eng, port


@pytest.mark.parametrize("quantize", [True, "w8", "a8"])
def test_quantized_tiny_engine_matches_jax_engine(tiny_weights, quantize):
    """Each int8 mode against the JAX engine in the same mode (its Pallas
    kernels in interpret mode) on the golden audio: the golden criterion
    on the result, greedy CTC ids on at least 99.5 % of frames."""
    jax_eng, port = _tiny_engines(tiny_weights, quantize)
    path = golden.GOLDEN_WAV
    want = dataclasses.asdict(jax_eng.transcribe(path))
    got = port.transcribe(path).to_dict()
    assert len(want["segments"]) >= 2
    assert golden.result_mismatches(
        want, got, tone_mass=golden.tone_mass(jax_eng, path)) == []
    assert golden.ctc_agreement(_ids(jax_eng, path),
                                _ids(port, path)) >= golden.MIN_CTC_AGREEMENT


@pytest.mark.parametrize("quantize", [False, True, "w8", "a8"])
def test_quantized_engine_parameters(tiny_weights, quantize):
    """What each mode holds: int8 dense weights with f32 scales; for the
    kernel modes a K-contiguous copy of the weights the kernels take; the
    fused conv module's pw1/pw2 in bf16, made from the f32 dequantized
    weight; the x-vector and the host pooling projection unquantized."""
    from omnilingual_asr_torch.ops.quant import quantize_weight

    _, _, _, tp, tx = tiny_weights
    eng = TranscriptionEngine(config=tiny_config(), params=tp,
                              xvector_params=tx, device="cpu",
                              speaker_mode="inline", quantize=quantize)
    kernel = quantize if quantize in ("w8", "a8") else None
    assert eng._quant_kernel == kernel
    blk = eng.params["blocks"][0]
    w1, w2 = blk["ffn1"]["w1"], blk["ffn1"]["w2"]      # 128->512, 512->128
    pw1 = tp["blocks"][0]["conv"]["pw1"]["w"]
    if quantize:
        assert w1["w_q"].dtype == torch.int8 and "w" not in w1
        assert w1["w_scale"].dtype == torch.float32
        assert ("w_t" in w1) == (kernel is not None)
        assert "w_t" not in w2
        if kernel:
            assert torch.equal(w1["w_t"], w1["w_q"].t())
        q, sc = quantize_weight(pw1)
        want_pw1 = (q.float() * sc[None, :]).to(torch.bfloat16)
    else:
        assert "w" in w1 and "w_q" not in w1
        want_pw1 = pw1.to(torch.bfloat16)
    assert set(blk["conv"]["pw1"]) == {"w"}
    assert torch.equal(blk["conv"]["pw1"]["w"], want_pw1)
    assert eng._xvector["convs"][0]["w"].dtype == torch.float32
    # the active embedder (the x-vector) pools with its own projection
    np.testing.assert_array_equal(eng._spk_pool["spk_proj"]["w"],
                                  tx["spk_proj"]["w"].numpy())


def test_quantized_modes_change_the_forward(tiny_weights):
    """The mode reaches the layers: the three int8 modes give three
    different forwards, each different from the unquantized one."""
    samples = np.random.default_rng(3).integers(
        -3000, 3000, (1, 480_000)).astype(np.int16)
    outs = {}
    for q in (False, True, "w8", "a8"):
        _, _, _, tp, tx = tiny_weights
        eng = TranscriptionEngine(config=tiny_config(), params=tp,
                                  xvector_params=tx, device="cpu",
                                  speaker_mode="inline", quantize=q,
                                  batch_windows_per_device=1)
        n_valid = torch.tensor([eng.window_frames], dtype=torch.int32)
        ctc_mask = torch.zeros(eng.config.vocab.vocab_size)
        out = eng._process(torch.from_numpy(samples), n_valid, ctc_mask)
        outs[q] = out["emotion_logits"].float()
    keys = list(outs)
    for i, a in enumerate(keys):
        for b in keys[i + 1:]:
            assert not torch.equal(outs[a], outs[b]), (a, b)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_default_construction_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TranscriptionEngine(config=tiny_config())
    with pytest.raises(RuntimeError):
        TranscriptionEngine(config=tiny_config(), device="cuda")


def test_cpu_construction_works(tmp_path):
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        eng = TranscriptionEngine(config=tiny_config(), device="cpu",
                                  speaker_mode="inline")
    assert eng.device == torch.device("cpu")
    assert eng.infer_config.encoder.use_flash_attention
    assert eng.infer_config.encoder.use_fused_conv
    rng = np.random.default_rng(0)
    path = _write_wav(tmp_path / "noise.wav",
                      rng.standard_normal(16_000).astype(np.float32) * 0.1)
    res = eng.transcribe(path)
    assert res.summary is None or "Audio of 1.0 seconds" in res.summary


@pytest.mark.parametrize("kwargs", [
    {"long_mode": "sequence"},
    {"speaker_mode": "crop"},
    {"ingress": "mulaw"},
    {"config": tiny_config().replace(decode=DecodeConfig(beam_size=4))},
    {"config": tiny_config().replace(decode=DecodeConfig(spk_wire="i8"))},
    {"config": tiny_config().replace(
        decode=DecodeConfig(spk_frame_stride=2))},
])
def test_unported_modes_raise(kwargs):
    """Only ``long_mode="sequence"`` (A10, several devices) is unported and
    raises; the other modes that raised before the engine's single-card
    modes were ported now construct, with the mode in force."""
    kwargs = {"config": tiny_config(), **kwargs}
    speaker_mode = kwargs.pop("speaker_mode", "inline")
    if kwargs.get("long_mode") == "sequence":
        with pytest.raises(NotImplementedError, match="A10.*ROADMAP"):
            TranscriptionEngine(device="cpu", speaker_mode=speaker_mode,
                                **kwargs)
        return
    eng = TranscriptionEngine(device="cpu", speaker_mode=speaker_mode,
                              **kwargs)
    assert eng.speaker_mode == speaker_mode
    assert eng.ingress == kwargs.get("ingress", "i16")
    assert eng.config.decode == kwargs["config"].decode


def test_auto_speaker_mode_without_xvector_is_crop_and_raises():
    """"auto" resolves to crop without x-vector weights (as in the JAX
    engine); crop mode is ported, so construction no longer raises."""
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        eng = TranscriptionEngine(config=tiny_config(), device="cpu")
    assert eng.speaker_mode == "crop"
    assert eng._xvector is None


@pytest.mark.parametrize("kwargs", [
    {"quantize": "w8a8"}, {"long_mode": "stream"},
    {"speaker_mode": "bogus"}, {"ingress": "f32"}, {"device": "tpu"},
])
def test_invalid_values_raise_value_error(kwargs):
    with pytest.raises(ValueError):
        TranscriptionEngine(config=tiny_config(), **kwargs)
