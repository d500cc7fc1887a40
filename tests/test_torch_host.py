"""PyTorch port: the host modules it keeps its own copies of (config,
decode, resample, CTC segmentation, clustering, VAD, languages, orthography,
summary, tracing) give the JAX package's answers on the same inputs."""

from __future__ import annotations

import dataclasses
import struct
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from omnilingual_asr_tpu import config as jax_config
from omnilingual_asr_tpu.audio import decode as jax_decode
from omnilingual_asr_tpu.audio import resample as jax_resample
from omnilingual_asr_tpu.diarization import cluster as jax_cluster
from omnilingual_asr_tpu.diarization import vad as jax_vad
from omnilingual_asr_tpu.models import languages as jax_languages
from omnilingual_asr_tpu.models import orthography as jax_orthography
from omnilingual_asr_tpu.models.conformer import \
    pooled_speaker_embed_np as jax_pool
from omnilingual_asr_tpu.models.summarizer import \
    template_summary as jax_summary
from omnilingual_asr_tpu.ops import ctc as jax_ctc
from omnilingual_asr_torch import config
from omnilingual_asr_torch.audio import decode, resample
from omnilingual_asr_torch.diarization import cluster, vad
from omnilingual_asr_torch.models import languages, orthography
from omnilingual_asr_torch.models.conformer import pooled_speaker_embed_np
from omnilingual_asr_torch.models.summarizer import template_summary
from omnilingual_asr_torch.ops import ctc
from omnilingual_asr_torch.utils import tracing
from omnilingual_asr_torch.utils.tracing import StageTrace
from test_frontend import make_aiff_bytes
from test_torch_native_audio import jax_native_ready

torch.set_num_threads(2)

RELEASE = Path(__file__).resolve().parents[1] / "checkpoints" / "release"


def test_release_config_equals_jax():
    text = (RELEASE / "config.json").read_text()
    a = jax_config.PipelineConfig.from_json(text)
    b = config.PipelineConfig.from_json(text)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.decode.ahc_threshold == 0.52
    for n in (0, 399, 400, 480_000, 123_457):
        assert (b.frontend.frames_for_samples(n)
                == a.frontend.frames_for_samples(n))


def _wav(pcm: np.ndarray, sr: int, channels: int) -> bytes:
    data = pcm.astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, channels, sr, sr * 2 * channels,
                      2 * channels, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("fmt,channels", [("wav", 1), ("wav", 2),
                                          ("aiff", 1), ("aiff", 2)])
def test_decode_equals_jax(tmp_path, monkeypatch, fmt, channels):
    rng = np.random.default_rng(channels)
    pcm = rng.integers(-30000, 30000, size=8000 * channels).astype(np.int16)
    if fmt == "wav":
        path = tmp_path / "a.wav"
        path.write_bytes(_wav(pcm, 16000, channels))
    else:
        path = tmp_path / "a.aiff"
        path.write_bytes(make_aiff_bytes(pcm.astype(">i2").tobytes(), 16000,
                                         channels=channels))
    # Both packages decode natively first (AIFF through libav where it is
    # linked), then in Python. Where the JAX package's library cannot build,
    # both take their Python routes.
    if not jax_native_ready():
        monkeypatch.setattr(jax_decode, "native_available", lambda: False)
        monkeypatch.setattr(decode, "native_available", lambda: False)
    want = jax_decode.decode_audio(path)
    got = decode.decode_audio(path)
    assert got[1] == want[1] == 16000
    np.testing.assert_array_equal(got[0], want[0])
    assert decode.get_audio_duration(path) == pytest.approx(0.5)


def test_decode_refuses_other_containers(tmp_path):
    """A container that neither the native library nor the Python parsers
    decode raises the JAX package's error."""
    path = tmp_path / "a.mp3"
    path.write_bytes(b"\xff\xfb" + b"\x00" * 100)
    with pytest.raises(ValueError, match="no pure-Python fallback") as got:
        decode.decode_audio(path)
    with pytest.raises(ValueError) as want:
        jax_decode.decode_audio(path)
    assert str(got.value) == str(want.value)
    assert decode.get_audio_duration(path) == 0.0
    assert decode.get_audio_duration(tmp_path / "missing.wav") == 0.0


@pytest.mark.parametrize("sr", [8000, 22050, 44100])
def test_resample_equals_jax(sr):
    x = np.random.default_rng(sr).standard_normal(sr // 2).astype(np.float32)
    np.testing.assert_array_equal(resample.resample(x, sr, 16000),
                                  jax_resample.resample(x, sr, 16000))


def _alignment(seed: int, n: int = 600) -> np.ndarray:
    """Greedy-CTC-like ids: blank runs, repeats, ASCII letters and spaces,
    and a few multibyte UTF-8 sequences."""
    rng = np.random.default_rng(seed)
    ids = np.zeros(n, np.int64)
    t = 0
    while t < n:
        run = int(rng.integers(1, 40))
        if rng.random() < 0.6:
            text = rng.choice(["hello ", "world ", "ñandú ", "ქღ ", "ab"])
            for b in text.encode():
                if t < n:
                    ids[t:t + 2] = b + 1
                    t += 2
        t += run
    return ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segments_from_alignment_equal_jax(seed):
    ids = _alignment(seed)
    vocab, dec = config.VocabConfig(), config.DecodeConfig()
    got = ctc.segments_from_alignment(ids, 0.04, vocab, dec,
                                      time_offset_s=30.0)
    want = jax_ctc.segments_from_alignment(
        ids, 0.04, jax_config.VocabConfig(), jax_config.DecodeConfig(),
        time_offset_s=30.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


@pytest.mark.parametrize("n,kwargs", [
    (12, {}), (12, {"n_clusters": 3}), (90, {}),
    (20, {"count_mode": "eigengap"}), (20, {"resegment": True}),
])
def test_cluster_speakers_equal_jax(n, kwargs):
    rng = np.random.default_rng(n)
    centers = rng.standard_normal((3, 16))
    embeds = (centers[rng.integers(0, 3, n)]
              + 0.3 * rng.standard_normal((n, 16))).astype(np.float32)
    got = cluster.cluster_speakers(embeds, threshold=0.3, **kwargs)
    want = jax_cluster.cluster_speakers(embeds, threshold=0.3, **kwargs)
    np.testing.assert_array_equal(got, want)


def test_vad_equals_jax():
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((400, 128)).astype(np.float32) - 10.0
    mel[100:250] += 8.0
    np.testing.assert_array_equal(vad.vad_mask(mel), jax_vad.vad_mask(mel))
    assert vad.speech_ratio(mel) == jax_vad.speech_ratio(mel)


@pytest.mark.parametrize("orth", [None, "latin", "cyrillic", "han", "bogus"])
def test_ctc_logit_mask_equals_jax(orth):
    np.testing.assert_array_equal(
        orthography.ctc_logit_mask(orth, config.VocabConfig()),
        jax_orthography.ctc_logit_mask(orth, jax_config.VocabConfig()))


def test_language_table_equals_jax():
    assert languages.KNOWN_LANGUAGES == jax_languages.KNOWN_LANGUAGES
    for hint in ("en", "English", "ka", "xx", ""):
        assert (languages.id_for_language(hint)
                == jax_languages.id_for_language(hint))
    for i in (0, 5, 2047, 5000):
        assert languages.language_for_id(i) == jax_languages.language_for_id(i)


def test_template_summary_equals_jax():
    kw = dict(duration_s=12.34, n_speakers=1, n_segments=3,
              language_names=["Greek", "Georgian"], top_emotion="sad")
    assert template_summary(**kw) == jax_summary(**kw)


def test_pooled_speaker_embed_equals_jax():
    rng = np.random.default_rng(3)
    params = {"spk_proj": {"w": rng.standard_normal((512, 256)).astype(
        np.float32), "b": rng.standard_normal(256).astype(np.float32)}}
    frames = rng.standard_normal((40, 256)).astype(np.float32)
    w = (rng.random(40) > 0.3).astype(np.float32)
    np.testing.assert_allclose(pooled_speaker_embed_np(params, frames, w),
                               jax_pool(params, frames, w), rtol=1e-6,
                               atol=1e-7)


def test_stage_trace_accumulates():
    """A stage's seconds add up over its blocks; under a profiler each
    block is also a span, and the stage holds the spans' seconds."""
    tr = StageTrace(audio_seconds=10.0)
    with tr.stage("forward"):
        time.sleep(0.01)
    with tr.stage("forward"):
        pass
    tr.stages["extract"] = 0.5
    d = tr.to_dict()
    assert d == {"stages": {"forward": tr.stages["forward"], "extract": 0.5},
                 "audio_seconds": 10.0, "n_chips": 1}
    assert 0.01 <= d["stages"]["forward"] < 1.0
    assert tracing.spans() == []
    before = tr.stages["forward"]
    tracing.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with tr.stage("forward"):
            time.sleep(0.01)
        with tr.stage("forward"):
            pass
    spans = tracing.spans()
    tracing.clear()
    assert [s.name for s in spans] == ["forward", "forward"]
    assert all(s.parent is None and s.request is None for s in spans)
    took = sum(s.end - s.start for s in spans)
    assert took >= 0.01
    assert tr.stages["forward"] - before == pytest.approx(took, abs=1e-3)
