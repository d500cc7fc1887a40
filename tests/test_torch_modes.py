"""PyTorch port: the engine's other single-card serving modes against the
JAX engine.

Each case builds a tiny-config port engine on the CPU and a JAX engine from
the same JAX-initialised weights (``zoo.params_from_jax``) and runs both on
the same WAV: the golden audio, or the golden audio twice, a window
each (two device batches of one window). The modes: prefix beam
search with the lexicon LM (texts identical), crop speaker re-embedding
(embeddings within rel-L2 1e-3, speakers identical), ``transcribe_streaming``
(partials equal to the JAX engine's, times within 40 ms; the final result
``to_dict()``-equal to ``transcribe``'s), μ-law ingress, the slim speaker
wire (int8 with a per-frame scale, mean-pooled at stride 2), the health
check and the one re-dispatch of a failed batch.
"""

from __future__ import annotations

import dataclasses
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine

torch.set_num_threads(2)

TOPK_TOL = 1e-2


@pytest.fixture(scope="module")
def tiny_weights():
    from omnilingual_asr_tpu.config import tiny_config as jax_tiny
    from omnilingual_asr_tpu.models.conformer import asr_init
    from omnilingual_asr_tpu.models.xvector import xvector_init
    from omnilingual_asr_torch.models import zoo

    jcfg = jax_tiny()
    jp = asr_init(jax.random.PRNGKey(0), jcfg)
    jx = xvector_init(jax.random.PRNGKey(1), jcfg)
    return jcfg, jp, jx, zoo.params_from_jax(jp), zoo.params_from_jax(jx)


@pytest.fixture(scope="module")
def tiled_wav(tmp_path_factory):
    """Two windows, each the golden audio from its start: the first padded
    with silence to 30 s, the second partial. Both windows then carry the
    frames on which the two packages' greedy ids are known to agree (a
    random tiny model's near-tied logits elsewhere flip single ids)."""
    with wave.open(str(golden.GOLDEN_WAV), "rb") as w:
        params = w.getparams()
        pcm = w.readframes(w.getnframes())
    window = int(30.0 * params.framerate) * params.sampwidth
    path = tmp_path_factory.mktemp("modes") / "two_windows.wav"
    with wave.open(str(path), "wb") as w:
        w.setparams(params)
        w.writeframes(pcm + b"\0" * (window - len(pcm)) + pcm)
    return path


def _engines(tiny_weights, *, xvector=True, decode=None, **kwargs):
    """(JAX engine, port engine) on the same weights and settings."""
    from omnilingual_asr_tpu.config import MeshConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    jcfg, jp, jx, tp, tx = tiny_weights
    pcfg = tiny_config()
    if decode:
        jcfg = jcfg.replace(decode=dataclasses.replace(jcfg.decode, **decode))
        pcfg = pcfg.replace(decode=dataclasses.replace(pcfg.decode, **decode))
    kwargs.setdefault("speaker_mode", "inline")
    kwargs.setdefault("batch_windows_per_device", 1)
    jax_eng = JaxEngine(config=jcfg, params=jp,
                        xvector_params=jx if xvector else None,
                        mesh=build_mesh(MeshConfig(data=1),
                                        devices=jax.devices()[:1]), **kwargs)
    port = TranscriptionEngine(config=pcfg, params=tp,
                               xvector_params=tx if xvector else None,
                               device="cpu", **kwargs)
    return jax_eng, port


@pytest.fixture(scope="module")
def plain_engines(tiny_weights):
    """(JAX engine, port engine) at the default settings, built once for
    the tests that take them as they are (each JAX engine compiles its
    own forward)."""
    return _engines(tiny_weights)


@pytest.fixture(scope="module")
def speaker_base(plain_engines):
    """The largest difference of the two plain forwards' speaker frames on
    the golden file (the x-vector's f32 sums in another order, then f16
    rounding)."""
    jax_plain, plain = plain_engines
    return max(float(np.abs(g["speaker_frames"] - w["speaker_frames"]).max())
               for g, w in zip(_window_outs(plain, golden.GOLDEN_WAV),
                               _window_outs(jax_plain, golden.GOLDEN_WAV)))


def _window_outs(engine, path):
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    return [o for outs in engine._forward_batches(windows, n_last)
            for o in outs]


# ---------------------------------------------------------------------------
# Beam search with the lexicon LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lexicon", ["synth", "synth_bigram", "words"])
def test_beam_texts_equal_jax(tiny_weights, plain_engines, tmp_path,
                              lexicon):
    """beam_size 8 with lm_alpha 0.3: the texts of both engines are
    identical, and the beam changed at least one segment's greedy text."""
    if lexicon == "words":
        lexicon = str(tmp_path / "words.txt")
        Path(lexicon).write_text("the old man walked\ndown to the water\n",
                                 encoding="utf-8")
    decode = dict(beam_size=8, lexicon=lexicon, lm_alpha=0.3)
    jax_eng, port = _engines(tiny_weights, decode=decode)
    want = dataclasses.asdict(jax_eng.transcribe(golden.GOLDEN_WAV))
    got = port.transcribe(golden.GOLDEN_WAV).to_dict()
    assert len(want["segments"]) >= 2
    assert [s["text"] for s in got["segments"]] == \
        [s["text"] for s in want["segments"]]
    assert golden.result_mismatches(
        want, got, tone_mass=golden.tone_mass(jax_eng, golden.GOLDEN_WAV)) \
        == []
    _, greedy = plain_engines
    plain = greedy.transcribe(golden.GOLDEN_WAV).to_dict()
    assert [s["text"] for s in plain["segments"]] != \
        [s["text"] for s in got["segments"]]


def test_beam_topk_equals_jax(tiny_weights):
    """The device's top-K feed against the JAX engine's: each frame's
    sorted log-probabilities within TOPK_TOL (bf16 roundings of the two
    forwards move a logit by up to ~5e-3 on this model), and its classes
    equal wherever a value stands more than 2 TOPK_TOL from its
    neighbours (nearer ones may swap)."""
    jax_eng, port = _engines(tiny_weights, decode=dict(beam_size=8))
    want = _window_outs(jax_eng, golden.GOLDEN_WAV)
    got = _window_outs(port, golden.GOLDEN_WAV)
    n_checked = 0
    for w, g in zip(want, got):
        (wl, wi), (gl, gi) = w["ctc_topk"], g["ctc_topk"]
        assert gi.dtype == np.int16 and gl.dtype == np.float32
        assert gi.shape == wi.shape == (len(w["ctc_ids"]), 8)
        assert (np.diff(gl, axis=1) <= 0).all()
        assert np.abs(gl - wl).max() <= TOPK_TOL
        gap = np.abs(np.diff(wl, axis=1))
        apart = np.ones_like(wl, dtype=bool)
        apart[:, :-1] &= gap > 2 * TOPK_TOL
        apart[:, 1:] &= gap > 2 * TOPK_TOL
        apart[:, -1] = False      # the K+1-th class is not shipped
        np.testing.assert_array_equal(gi[apart], wi[apart])
        n_checked += int(apart.sum())
    assert n_checked >= len(want[0]["ctc_ids"])


# ---------------------------------------------------------------------------
# Crop speaker re-embedding
# ---------------------------------------------------------------------------

def test_crop_embeddings_and_speakers_equal_jax(tiny_weights, tiled_wav,
                                                monkeypatch):
    """Without x-vector weights "auto" is crop in both packages; each
    segment's re-embedding is within rel-L2 1e-3 of the JAX engine's, and
    the results' speakers are identical."""
    jax_eng, port = _engines(tiny_weights, xvector=False, speaker_mode=None,
                             batch_windows_per_device=2)
    assert jax_eng.speaker_mode == port.speaker_mode == "crop"
    samples = jax_eng._load_audio(tiled_wav)
    decoded = jax_eng._extract_windows(_window_outs(jax_eng, tiled_wav))[0]
    assert len(decoded) >= 4
    want = jax_eng._segment_crop_embeds(samples, decoded)
    got = port._segment_crop_embeds(samples, decoded)
    assert got.shape == want.shape
    rel = (np.linalg.norm(got - want, axis=1)
           / np.linalg.norm(want, axis=1))
    assert rel.max() <= 1e-3

    calls = []
    crop = port._segment_crop_embeds
    monkeypatch.setattr(port, "_segment_crop_embeds",
                        lambda *a: calls.append(1) or crop(*a))
    w = dataclasses.asdict(jax_eng.transcribe(tiled_wav))
    g = port.transcribe(tiled_wav).to_dict()
    assert calls == [1]
    assert "decode" in port.last_trace.stages   # crop mode reads the samples
    assert [s["speaker"] for s in g["segments"]] == \
        [s["speaker"] for s in w["segments"]]
    assert golden.result_mismatches(
        w, g, tone_mass=golden.tone_mass(jax_eng, tiled_wav)) == []


def test_crop_with_xvector_equals_jax(tiny_weights):
    """speaker_mode="crop" with x-vector weights re-embeds through the
    x-vector alone, as the JAX engine does."""
    jax_eng, port = _engines(tiny_weights, speaker_mode="crop")
    samples = jax_eng._load_audio(golden.GOLDEN_WAV)
    decoded = jax_eng._extract_windows(
        _window_outs(jax_eng, golden.GOLDEN_WAV))[0]
    want = jax_eng._segment_crop_embeds(samples, decoded)
    got = port._segment_crop_embeds(samples, decoded)
    rel = (np.linalg.norm(got - want, axis=1)
           / np.linalg.norm(want, axis=1))
    assert rel.max() <= 1e-3


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------

def _segment_view(seg) -> dict:
    d = seg if isinstance(seg, dict) else dataclasses.asdict(seg)
    return {k: d[k] for k in ("text", "speaker", "language",
                              "language_code", "languages", "emotion")}


def test_streaming_equals_jax_and_transcribe(plain_engines, tiled_wav):
    """One partial a batch with the JAX engine's segments (texts,
    speakers, languages, emotions; times within 40 ms), then a final
    result equal to ``transcribe``'s."""
    jax_eng, port = plain_engines
    want = list(jax_eng.transcribe_streaming(tiled_wav))
    got = list(port.transcribe_streaming(tiled_wav))
    assert [k for k, _ in got] == [k for k, _ in want] == \
        ["partial", "partial", "final"]
    for (_, ws), (_, gs) in zip(want[:-1], got[:-1]):
        assert [_segment_view(s) for s in gs] == \
            [_segment_view(s) for s in ws]
        for w, g in zip(ws, gs):
            assert abs(w.start - g.start) <= golden.TIME_TOL_S + 1e-9
            assert abs(w.end - g.end) <= golden.TIME_TOL_S + 1e-9
    final = got[-1][1].to_dict()
    assert final == port.transcribe(tiled_wav).to_dict()
    assert golden.result_mismatches(
        dataclasses.asdict(want[-1][1]), final,
        tone_mass=golden.tone_mass(jax_eng, tiled_wav)) == []
    n_partial = sum(len(segs) for _, segs in got[:-1])
    assert n_partial == len(final["segments"]) >= 4


def test_streaming_crop_beam_final_equals_transcribe(tiny_weights,
                                                     tiled_wav):
    """In crop mode with the beam search, the final event is still
    ``transcribe``'s result."""
    _, port = _engines(tiny_weights, xvector=False, speaker_mode="crop",
                       decode=dict(beam_size=8))
    *_, (kind, final) = port.transcribe_streaming(tiled_wav)
    assert kind == "final"
    assert final.to_dict() == port.transcribe(tiled_wav).to_dict()


def test_streaming_empty_audio(plain_engines, tmp_path):
    p = tmp_path / "e.wav"
    with wave.open(str(p), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(b"")
    _, port = plain_engines
    events = list(port.transcribe_streaming(p))
    assert len(events) == 1 and events[0][0] == "final"
    assert events[0][1].to_dict() == {"summary": None, "segments": [],
                                      "detected_languages": None}


def test_online_speaker_equals_jax():
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine

    rng = np.random.default_rng(5)
    embs = [rng.standard_normal(16) + (3 if i % 3 == 0 else 0)
            for i in range(12)]
    state = {"port": ([], []), "jax": ([], [])}
    for e in embs:
        a = TranscriptionEngine._online_speaker(e, *state["port"], 0.45)
        b = JaxEngine._online_speaker(e, *state["jax"], 0.45)
        assert a == b
    np.testing.assert_array_equal(np.stack(state["port"][0]),
                                  np.stack(state["jax"][0]))


# ---------------------------------------------------------------------------
# μ-law ingress and the slim speaker wire
# ---------------------------------------------------------------------------

def test_mulaw_codec_equals_jax():
    from omnilingual_asr_torch.audio import codec
    from omnilingual_asr_tpu.audio import codec as jax_codec

    x = np.concatenate([
        np.random.default_rng(0).uniform(-1.2, 1.2, 50_000),
        [-1.0, -0.5, 0.0, 1e-6, 0.5, 1.0]]).astype(np.float32)
    u = codec.mulaw_encode(x)
    np.testing.assert_array_equal(u, jax_codec.mulaw_encode(x))
    assert u.dtype == np.uint8
    allu = np.arange(256, dtype=np.uint8)
    got = codec.mulaw_decode(torch.from_numpy(allu)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_codec.mulaw_decode(allu)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, jax_codec.mulaw_decode_np(allu),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(codec.mulaw_decode_np(allu),
                                  jax_codec.mulaw_decode_np(allu))


def test_mulaw_ingress_equals_jax(tiny_weights, plain_engines):
    """``ingress="mulaw"``: the result equals the JAX engine's in the same
    mode, and the greedy ids differ from the int16 wire's somewhere."""
    jax_eng, port = _engines(tiny_weights, ingress="mulaw")
    assert port.ingress == "mulaw"
    want = dataclasses.asdict(jax_eng.transcribe(golden.GOLDEN_WAV))
    got = port.transcribe(golden.GOLDEN_WAV).to_dict()
    assert golden.result_mismatches(
        want, got, tone_mass=golden.tone_mass(jax_eng, golden.GOLDEN_WAV)) \
        == []
    ids = lambda e: [o["ctc_ids"].astype(int).tolist()  # noqa: E731
                     for o in _window_outs(e, golden.GOLDEN_WAV)]
    assert golden.ctc_agreement(ids(jax_eng), ids(port)) >= \
        golden.MIN_CTC_AGREEMENT
    _, plain = plain_engines
    assert ids(plain) != ids(port)


@pytest.mark.parametrize("decode", [
    {"spk_wire": "i8"}, {"spk_frame_stride": 2},
    {"spk_wire": "i8", "spk_frame_stride": 2},
], ids=["i8", "stride2", "i8-stride2"])
def test_speaker_wire_equals_jax(tiny_weights, speaker_base, decode):
    """The host's speaker frames after unpacking, at the frame rate, against
    the JAX engine's in the same mode. The two forwards' f16 frames already
    differ by up to ``base`` (the x-vector's f32 sums in another order,
    then f16 rounding; measured here on the full wire); pooling cannot
    widen that, and int8 adds at most one step of the frame's scale (the
    scales themselves differ by at most base / 127)."""
    base = speaker_base
    jax_eng, port = _engines(tiny_weights, decode=decode)
    want = _window_outs(jax_eng, golden.GOLDEN_WAV)
    got = _window_outs(port, golden.GOLDEN_WAV)
    for w, g in zip(want, got):
        ws, gs = w["speaker_frames"], g["speaker_frames"]
        assert gs.shape == ws.shape
        step = (np.abs(ws).max(axis=-1, keepdims=True) / 127.0
                if "spk_wire" in decode else 0.0)
        assert (np.abs(gs - ws) <= 2.0 * base + step).all()
    if decode.get("spk_frame_stride") == 2:
        s = got[0]["speaker_frames"]
        np.testing.assert_array_equal(s[0:-1:2], s[1::2])


def test_speaker_wire_payload(tiny_weights):
    """What crosses the wire: int8 frames and an f16 scale a frame, at half
    the frame count under stride 2."""
    _, port = _engines(tiny_weights, decode=dict(spk_wire="i8",
                                                 spk_frame_stride=2))
    samples = torch.zeros(1, port.window_samples, dtype=torch.int16)
    out = port._process(samples, torch.tensor([100], dtype=torch.int32),
                        torch.zeros(port.config.vocab.vocab_size))
    T = out["mask"].shape[1]
    assert "speaker_frames" not in out
    assert out["speaker_frames_q"].dtype == torch.int8
    assert out["speaker_frames_q"].shape[1] == T // 2
    assert out["speaker_scale"].dtype == torch.float16
    assert out["speaker_scale"].shape == (1, T // 2)


# ---------------------------------------------------------------------------
# Health and re-dispatch
# ---------------------------------------------------------------------------

def test_health_check(plain_engines):
    _, port = plain_engines
    report = port.health_check()
    assert report == {"devices": [{"id": "cpu", "ok": True}], "ok": True}


def test_dispatch_redispatches_on_transient_error(plain_engines,
                                                 monkeypatch):
    """A batch whose program raises once is re-run once; a second failure
    surfaces; a kernel build failure is not retried."""
    from omnilingual_asr_torch.ops.cuda_build import KernelBuildError

    _, port = plain_engines
    orig = port._process
    calls = []

    def flaky(fail_times, exc):
        def run(*a, **k):
            calls.append(1)
            if len(calls) <= fail_times:
                raise exc("injected device fault")
            return orig(*a, **k)
        return run

    sb = torch.zeros((port.batch_size, port.window_samples), dtype=torch.int16)
    nb = torch.zeros((port.batch_size,), dtype=torch.int32)
    mask = torch.zeros(port.config.vocab.vocab_size)
    monkeypatch.setattr(port, "_process", flaky(1, RuntimeError))
    assert "ctc_ids" in port._dispatch_batch(sb, nb, mask)
    assert len(calls) == 2
    calls.clear()
    monkeypatch.setattr(port, "_process", flaky(2, RuntimeError))
    with pytest.raises(RuntimeError, match="injected"):
        port._dispatch_batch(sb, nb, mask)
    assert len(calls) == 2
    calls.clear()
    monkeypatch.setattr(port, "_process", flaky(1, KernelBuildError))
    with pytest.raises(KernelBuildError):
        port._dispatch_batch(sb, nb, mask)
    assert len(calls) == 1
    calls.clear()
    monkeypatch.setattr(port, "_process", flaky(1, RuntimeError))
    res = port.transcribe(golden.GOLDEN_WAV).to_dict()
    assert len(calls) == 2
    monkeypatch.setattr(port, "_process", orig)
    assert res == port.transcribe(golden.GOLDEN_WAV).to_dict()
