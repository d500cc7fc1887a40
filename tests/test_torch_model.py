"""PyTorch port: conformer blocks, the full ``asr_forward`` and the x-vector
embedder against the JAX package on the same weights and inputs.

Tiny configs (2 layers, d 64) run under the stored flags (the plain XLA
attention and conv paths) and under the engine's inference flags (flash
attention + fused conv module, the Pallas kernels in interpret mode); one
full forward runs on the release weights over a 30 s window.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import EncoderConfig as JaxEncoderConfig
from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.models import layers as jax_layers
from omnilingual_asr_tpu.models import xvector as jax_xvector
from omnilingual_asr_tpu.models.zoo import load_checkpoint as jax_load_ckpt
from omnilingual_asr_tpu.ops.mel_pallas import MelFrontend as JaxMelFrontend
from omnilingual_asr_torch.config import EncoderConfig, PipelineConfig
from omnilingual_asr_torch.models import conformer, layers, xvector, zoo

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RELEASE = REPO / "checkpoints" / "release"
GOLDEN_WAV = REPO / "omnilingual_asr_torch" / "testdata" / "golden.wav"

FLAGS = {"stored": (False, False), "inference": (True, True)}


def _tiny(flags):
    flash, fused = FLAGS[flags]
    enc = dict(d_model=64, n_layers=2, n_heads=1, conv_kernel=32,
               use_flash_attention=flash, use_fused_conv=fused)
    return (JaxConfig(encoder=JaxEncoderConfig(**enc)),
            PipelineConfig(encoder=EncoderConfig(**enc)))


def _mel_and_mask(B, T, valid, seed=0):
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    return mel, mask


def _close(got, want, rel):
    """Max abs difference within ``rel`` of the reference's max magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"relative max error {err:.3e} > {rel}"


# bf16 rounding: every dense layer rounds its input to bf16 (2^-8 relative
# ulp). f32 differences in summation order flip single roundings, and each
# flip moves one product term by <= 2^-8 of itself; after a block that is
# ~1e-3 of the output scale, after a model ~1e-2. These bounds are relative
# to each output's max magnitude.
REL_BLOCK = 1e-2
REL_MODEL = 3e-2


@pytest.mark.parametrize("flags", ["stored", "inference"])
def test_conformer_block_matches_jax(flags):
    jcfg, tcfg = _tiny(flags)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(1), jcfg)
    tp = zoo.params_from_jax(jp)
    B, T = 3, 256     # subsampled length: a multiple of the flash block
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray([T, 100, 0])[:, None]
    cos, sin = jax_layers.rope_angles(T, 64)
    want, _ = jax_conformer.conformer_block_apply(
        jp["blocks"][0], jnp.asarray(x), jnp.asarray(mask), cos, sin,
        jcfg.encoder, jnp.bfloat16, flash_interpret=True)
    tcos, tsin = layers.rope_angles(T, 64)
    got, _ = conformer.conformer_block_apply(
        tp["blocks"][0], torch.from_numpy(x), torch.from_numpy(mask), tcos,
        tsin, tcfg.encoder, torch.bfloat16)
    _close(got.numpy(), np.asarray(want), REL_BLOCK)


@pytest.mark.parametrize("flags", ["stored", "inference"])
def test_asr_forward_tiny_matches_jax(flags):
    jcfg, tcfg = _tiny(flags)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(0), jcfg)
    tp = zoo.params_from_jax(jp)
    mel, mask = _mel_and_mask(3, 1024, [1024, 601, 0])
    want = jax_conformer.asr_forward(jp, jnp.asarray(mel), jnp.asarray(mask),
                                     jcfg, flash_interpret=True)
    got = conformer.asr_forward(tp, torch.from_numpy(mel),
                                torch.from_numpy(mask), tcfg)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    for key in ("ctc_logits", "lid_logits", "emotion_logits",
                "speaker_frames", "speaker_embed", "encoder_states"):
        _close(got[key].numpy(), np.asarray(want[key]), REL_MODEL)


def test_subsampled_mask_first_frame_rule():
    m = torch.tensor([[1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1]], dtype=torch.bool)
    want = jax_conformer.subsampled_mask(jnp.asarray(m.numpy()), 4)
    got = conformer.subsampled_mask(m, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [[True, True, False]]


@pytest.fixture(scope="module")
def release_window():
    """One 30 s window of the golden audio, its mel (JAX frontend) and
    mask, and both packages' release weights."""
    import wave

    with wave.open(str(GOLDEN_WAV), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    x = np.zeros(480_000, np.float32)
    x[:len(pcm)] = pcm.astype(np.float32) / 32768.0
    text = (RELEASE / "config.json").read_text()
    jcfg = JaxConfig.from_json(text)
    tcfg = PipelineConfig.from_json(text)
    fe = JaxMelFrontend(jcfg.frontend, interpret=True)
    mel = np.asarray(fe(x))                               # [2998, 128]
    T = 3072
    mel = np.pad(mel, ((0, T - len(mel)), (0, 0)))[None]
    n_valid = jcfg.frontend.frames_for_samples(len(pcm))
    mask = (np.arange(T) < n_valid)[None]
    return mel, mask, jcfg, tcfg


def test_asr_forward_release_window_matches_jax(release_window):
    """Release weights, one 30 s window, the engine's inference flags."""
    mel, mask, jcfg, tcfg = release_window
    enc_flags = dict(use_flash_attention=True, use_fused_conv=True)
    jcfg = jcfg.replace(encoder=dataclasses.replace(jcfg.encoder,
                                                    **enc_flags))
    tcfg = tcfg.replace(encoder=dataclasses.replace(tcfg.encoder,
                                                    **enc_flags))
    jp = jax_load_ckpt(RELEASE / "asr.npz", jcfg)
    tp = zoo.load_checkpoint(RELEASE / "asr.npz", tcfg)
    want = jax_conformer.asr_forward(jp, jnp.asarray(mel), jnp.asarray(mask),
                                     jcfg, flash_interpret=True)
    got = conformer.asr_forward(tp, torch.from_numpy(mel),
                                torch.from_numpy(mask), tcfg)
    valid = np.asarray(want["mask"])[0]
    for key in ("ctc_logits", "lid_logits", "emotion_logits",
                "speaker_frames", "encoder_states"):
        _close(got[key].numpy()[0, valid], np.asarray(want[key])[0, valid],
                REL_MODEL)
    # Greedy CTC ids: the decision the transcript is made of.
    ids_w = np.asarray(want["ctc_logits"])[0, valid, :257].argmax(-1)
    ids_g = got["ctc_logits"].numpy()[0, valid, :257].argmax(-1)
    assert (ids_w == ids_g).mean() >= 0.995


def test_xvector_frames_match_jax(release_window):
    """x-vector frames on xvector.npz. The reference convolves in bf16
    (f32 accumulation, bf16 output); both round at the same points, so the
    bound is the bf16 one of REL_MODEL."""
    mel, mask, jcfg, tcfg = release_window
    jp = jax_xvector.load_xvector(RELEASE / "xvector.npz", jcfg)
    tp = zoo.load_xvector(RELEASE / "xvector.npz", tcfg)
    want = np.asarray(jax_xvector.xvector_frames(jp, jnp.asarray(mel),
                                                 jnp.asarray(mask)))
    got = xvector.xvector_frames(tp, torch.from_numpy(mel),
                                 torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (1, 768, 256)
    _close(got, want, REL_MODEL)


@pytest.mark.parametrize("T,k,s,d", [(3072, 5, 2, 1), (1536, 5, 2, 1),
                                     (768, 3, 1, 8), (7, 5, 2, 1)])
def test_same_padding_matches_xla(T, k, s, d):
    """Hand SAME padding gives XLA's output length and alignment."""
    x = np.arange(T, dtype=np.float32)[None, :, None]
    w = np.zeros((k, 1, 1), np.float32)
    w[0] = 1.0                          # picks the first tap's input
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s,), "SAME", rhs_dilation=(d,),
        dimension_numbers=("NWC", "WIO", "NWC")))[0, :, 0]
    left, right = xvector.same_padding(T, k, s, d)
    xt = torch.nn.functional.pad(torch.from_numpy(x[:, :, 0])[:, None],
                                 (left, right))
    got = torch.nn.functional.conv1d(
        xt, torch.from_numpy(w[:, 0, 0].copy())[None, None], stride=s,
        dilation=d)[0, 0].numpy()
    np.testing.assert_array_equal(got, want)
