"""PyTorch port: ring attention, the sequence-parallel conformer forward and
the engine's sequence mode, held to the JAX package on the CPU.

The JAX side runs on the 8 host devices that ``tests/conftest.py`` forces;
the port's meshes are shards on the CPU (``[cpu] * n``). Parameters cross
with ``zoo.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import (EncoderConfig, MeshConfig,
                                          PipelineConfig, tiny_config)
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.ops.ring_attention import ring_attention
from omnilingual_asr_torch.parallel.mesh import build_mesh
from omnilingual_asr_torch.parallel.sequence import sp_conformer_forward
from omnilingual_asr_tpu.config import EncoderConfig as JaxEncoderConfig
from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
from omnilingual_asr_tpu.models.conformer import asr_init as jax_asr_init
from omnilingual_asr_tpu.models.translation import (
    translator_init as jax_translator_init)
from omnilingual_asr_tpu.ops.ring_attention import (
    ring_attention as jax_ring_attention)
from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build_mesh
from omnilingual_asr_tpu.parallel.sequence import (
    sp_conformer_forward as jax_sp_forward)

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: Ring attention against the JAX function: the JAX tests' own tolerance
#: against full attention (both sides compute the same f32 online softmax).
RING_ATOL, RING_RTOL = 2e-5, 1e-4
#: The sequence-parallel forward (f32 on both sides) against the JAX one:
#: max abs difference over the largest magnitude of each output.
SP_REL = 1e-4
#: The engine's sequence-mode frame arrays (f32 host copies) against the
#: JAX engine's, relative to each array's largest magnitude. Both run the
#: f32 encoder, but the mel is K1's plain twin against the Pallas kernel
#: in interpret mode (f32 DFT, summed in another order).
SEQ_FRAME_REL = 1e-3
#: bf16 encoder states: the same f32 value within SP_REL may round to
#: neighbouring bf16 values, one ulp apart (at most 2^-7 of the largest).
STATE_REL = 2.0 ** -7


def port_mesh(n: int):
    return build_mesh(MeshConfig(data=n, model=1), [CPU] * n)


def jax_mesh(n: int):
    return jax_build_mesh(JaxMeshConfig(data=n, model=1),
                          devices=jax.devices()[:n])


def jax_sp(jp, mel, mask, jcfg, n_dev: int, **kw):
    """The JAX sequence-parallel forward, jitted (one compile instead of
    op-by-op dispatch of the tap loop)."""
    mesh = jax_mesh(n_dev)
    fn = jax.jit(lambda p, m, k: jax_sp_forward(p, m, k, jcfg, mesh, **kw))
    return fn(jp, jnp.asarray(mel), jnp.asarray(mask))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_ring_attention_matches_jax(n_dev):
    rng = np.random.default_rng(n_dev)
    q, k, v = (rng.standard_normal((1, 512, 2, 32)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((1, 512), bool)
    want = np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask),
                                         jax_mesh(n_dev)))
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                         port_mesh(n_dev))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=RING_ATOL,
                               rtol=RING_RTOL)


def test_ring_attention_ragged_mask_matches_jax():
    """Valid keys end mid-shard: the valid queries agree with the JAX
    ring (and its fully masked rows too, where both divide by 1e-30)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 512, 2, 32)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((2, 512), bool)
    mask[0, :350] = True
    mask[1, :77] = True
    want = np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(mask),
                                         jax_mesh(8)))
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                         port_mesh(8)).numpy()
    np.testing.assert_allclose(got, want, atol=RING_ATOL, rtol=RING_RTOL)


def _sp_setup(T: int, seed: int = 0, conv_kernel: int = 8):
    enc = dict(d_model=64, n_layers=2, n_heads=2, conv_kernel=conv_kernel)
    jcfg = JaxConfig(encoder=JaxEncoderConfig(**enc))
    tcfg = PipelineConfig(encoder=EncoderConfig(**enc))
    jp = jax_asr_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((T, 128)) * 2.0 - 5.0).astype(np.float32)
    return jcfg, tcfg, jp, zoo.params_from_jax(jp), mel


@pytest.mark.parametrize("n_dev,valid", [(2, 512), (4, 400)],
                         ids=["n2-full", "n4-ragged"])
def test_sp_conformer_forward_matches_jax(n_dev, valid):
    """all_heads and with_states, at n = 2 and at n = 4 with a ragged
    tail (mask False past ``valid`` frames, across shard edges)."""
    jcfg, tcfg, jp, tp, mel = _sp_setup(512)
    mask = np.arange(512) < valid
    want = jax_sp(jp, mel, mask, jcfg, n_dev, all_heads=True,
                  with_states=True)
    got = sp_conformer_forward(tp, torch.from_numpy(mel),
                               torch.from_numpy(mask), tcfg,
                               port_mesh(n_dev), all_heads=True,
                               with_states=True)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    nv = valid // tcfg.encoder.subsample_factor
    for key in ("ctc_logits", "lid_logits", "emotion_logits",
                "speaker_frames"):
        assert _rel(got[key].numpy()[:nv],
                    np.asarray(want[key])[:nv]) <= SP_REL, key
    assert got["encoder_states"].dtype == torch.bfloat16
    assert _rel(got["encoder_states"].float().numpy()[:nv],
                np.asarray(want["encoder_states"], np.float32)[:nv]) <= \
        STATE_REL


def test_sp_short_shard_halo_raises_like_jax():
    """A shard shorter than the conv halo: the release's kernel of 32 taps
    has a halo of 15 + 16 frames, and 128 mel frames over 8 shards leave 4
    subsampled frames a shard. The JAX function fails on the misaligned
    tap slices (it does not return a wrong result); the port raises a
    ValueError that names the halo."""
    jcfg, tcfg, jp, tp, mel = _sp_setup(128, conv_kernel=32)
    mask = np.ones(128, bool)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax_sp(jp, mel, mask, jcfg, 8)
    with pytest.raises(ValueError, match="halo"):
        sp_conformer_forward(tp, torch.from_numpy(mel),
                             torch.from_numpy(mask), tcfg, port_mesh(8))
    # Two shards of 16 frames hold the halo: both run, and agree.
    want = jax_sp(jp, mel, mask, jcfg, 2)
    got = sp_conformer_forward(tp, torch.from_numpy(mel),
                               torch.from_numpy(mask), tcfg, port_mesh(2))
    assert _rel(got["ctc_logits"].numpy(),
                np.asarray(want["ctc_logits"])) <= SP_REL


def test_sp_forward_refuses_a_moe_tree_like_jax():
    """A mixture-of-experts tree: the JAX function applies a dense FFN to
    ``ffn2`` and fails on the stacked experts; the port raises ValueError
    before any work."""
    import dataclasses as dc

    jcfg, tcfg, _, _, mel = _sp_setup(128)
    jcfg = jcfg.replace(encoder=dc.replace(jcfg.encoder, n_experts=4))
    tcfg = tcfg.replace(encoder=dc.replace(tcfg.encoder, n_experts=4))
    jp = jax_asr_init(jax.random.PRNGKey(0), jcfg)
    mask = np.ones(128, bool)
    with pytest.raises((TypeError, IndexError)):
        jax_sp(jp, mel, mask, jcfg, 2)
    with pytest.raises(ValueError, match="dense FFNs"):
        sp_conformer_forward(zoo.params_from_jax(jp), torch.from_numpy(mel),
                             torch.from_numpy(mask), tcfg, port_mesh(2))


# ---------------------------------------------------------------------------
# The engine in sequence mode
# ---------------------------------------------------------------------------

SEQ_SECONDS = 32.0
SEQ_SHARDS = 4


def _speech_like(seconds: float, seed: int) -> np.ndarray:
    sr = 16_000
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 150 * t)
            * (1 + 0.6 * np.sin(2 * np.pi * 2.5 * t))
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _write_wav(path: Path, x: np.ndarray) -> Path:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(np.clip(x * 20000, -32768, 32767).astype(
            "<i2").tobytes())
    return path


@pytest.fixture(scope="module")
def seq_engines():
    """The JAX and the port engine in sequence mode over 4 shards, tiny
    config, the same JAX-initialised weights, no x-vector (trunk speaker
    frames, inline pooling), and a random audio-mode translator so that
    encoder states are emitted."""
    jcfg = jax_tiny_config()
    tcfg = tiny_config()
    jp = jax_asr_init(jax.random.PRNGKey(0), jcfg)
    jt = jax_translator_init(jax.random.PRNGKey(1), jcfg)
    kw = dict(window_seconds=10.0, batch_windows_per_device=1,
              long_mode="sequence", speaker_mode="inline")
    jeng = JaxEngine(config=jcfg, params=jp, mesh=jax_mesh(SEQ_SHARDS),
                     translator_params=jt, **kw)
    teng = TranscriptionEngine(config=tcfg, params=zoo.params_from_jax(jp),
                               mesh=port_mesh(SEQ_SHARDS),
                               translator_params=zoo.params_from_jax(jt),
                               **kw)
    return jeng, teng


def test_engine_forward_sequence_matches_jax(seq_engines):
    jeng, teng = seq_engines
    x = _speech_like(SEQ_SECONDS, 2)
    want = jeng._forward_sequence(x)
    got = teng._forward_sequence(x)
    assert len(got) == len(want) == 1
    w, g = want[0], got[0]
    assert golden.ctc_agreement([np.asarray(w["ctc_ids"]).tolist()],
                                [g["ctc_ids"].tolist()]) >= \
        golden.MIN_CTC_AGREEMENT
    assert len(g["ctc_ids"]) == len(w["ctc_ids"])
    for key in ("lid_conf", "emotion_logits", "speaker_frames",
                "frame_energy", "encoder_states"):
        assert g[key].dtype == np.float32, key
        tol = STATE_REL if key == "encoder_states" else SEQ_FRAME_REL
        assert _rel(g[key], w[key]) <= tol, key
    # Encoder states come back because the translator reads them.
    assert g["encoder_states"].shape == (len(g["ctc_ids"]),
                                         teng.config.encoder.d_model)


def test_engine_sequence_transcribe_matches_jax(seq_engines, tmp_path):
    jeng, teng = seq_engines
    path = _write_wav(tmp_path / "seq.wav", _speech_like(SEQ_SECONDS, 1))
    want = dataclasses.asdict(jeng.transcribe(path))
    got = teng.transcribe(path).to_dict()
    assert golden.result_mismatches(want, got) == []
    assert got["segments"] and got["segments"][-1]["end"] > 10.0
    assert teng.last_trace.n_chips == SEQ_SHARDS
    assert "forward" in teng.last_trace.stages
