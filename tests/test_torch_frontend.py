"""PyTorch port: log-mel frontend (constants, framing, and kernel K1's
plain version) against the JAX package's Pallas kernel in interpret mode."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.audio import frontend as jax_frontend
from omnilingual_asr_tpu.config import FrontendConfig as JaxFrontendConfig
from omnilingual_asr_tpu.ops import mel_pallas
from omnilingual_asr_torch.audio import frontend
from omnilingual_asr_torch.config import FrontendConfig
from omnilingual_asr_torch.ops import mel

torch.set_num_threads(2)


def _signal(n: int, seed: int = 0) -> np.ndarray:
    """Speech-like test signal: noise bursts over silence, so frames span
    loud, quiet and all-zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 0.2
    x[n // 3: n // 2] *= 0.001
    x[-n // 5:] = 0.0
    return x


def test_constants_equal_jax():
    """The real bins equal the reference's exactly. The reference pads the
    bin axis with zeros to 640 for its 128-lane tiles; the port keeps the
    513 real bins (its FFT kernel reads no DFT matrix)."""
    jc, tc = JaxFrontendConfig(), FrontendConfig()
    nf = tc.n_freqs
    for axis, a, b in zip((1, 1, 0), mel_pallas.build_mel_constants(jc),
                          mel.build_mel_constants(tc)):
        assert b.shape[axis] == nf
        np.testing.assert_array_equal(np.take(a, range(nf), axis), b)
        assert not np.take(a, range(nf, a.shape[axis]), axis).any()
    np.testing.assert_array_equal(jax_frontend.hann_window(400),
                                  frontend.hann_window(400))


@pytest.mark.parametrize("n", [16_000, 480_000, 300])
def test_framing_equals_jax(n):
    """Pre-emphasis + n_fft framing + padding to 256 rows, as
    MelFrontend.frames_from_signal. Tolerance 1e-6 abs: pre-emphasis is
    one f32 multiply-subtract per sample, rounded the same way up to
    contraction into an FMA."""
    x = _signal(n)
    jfe = mel_pallas.MelFrontend(JaxFrontendConfig(), interpret=True)
    want, want_n = jfe.frames_from_signal(x)
    tfe = mel.MelFrontend(FrontendConfig(), "cpu")
    got, got_n = tfe.frames_from_signal(torch.from_numpy(x))
    assert got_n == want_n
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_batched_framing_restarts_preemphasis_per_row():
    """Each window is its own signal: pre-emphasis restarts at its first
    sample, as the JAX engine's vmap over windows does."""
    x = np.stack([_signal(4000, 1), _signal(4000, 2)])
    tfe = mel.MelFrontend(FrontendConfig(), "cpu")
    both, _ = tfe.frames_from_signal(torch.from_numpy(x))
    for i in range(2):
        one, _ = tfe.frames_from_signal(torch.from_numpy(x[i]))
        assert torch.equal(both[i], one)


@pytest.mark.parametrize("n_frames", [256, 512])
def test_k1_plain_matches_pallas_kernel(n_frames):
    """Kernel K1's plain version vs log_mel_frames_pallas(interpret=True) on
    the same frames (T a multiple of 256).

    Both are f32 products in another summation order; log() amplifies the
    absolute error of a mel value by 1/value, so near the 1e-10 floor a
    1e-7 relative power difference is still tiny but a quiet bin whose
    power is ~1e-6 of the frame peak can move by ~1e-2 in log. Tolerance:
    log-domain 2e-3 abs where the bin is within 60 dB of its frame's peak,
    and the linear mel within 1e-5 of the frame peak everywhere."""
    cfg = FrontendConfig()
    jc = JaxFrontendConfig()
    x = _signal(160 * n_frames + 1024, seed=3)
    tfe = mel.MelFrontend(cfg, "cpu")
    frames, _ = tfe.frames_from_signal(torch.from_numpy(x))
    frames = frames[:n_frames].contiguous()
    cw, sw, fb = mel_pallas.build_mel_constants(jc)
    want = np.asarray(mel_pallas.log_mel_frames_pallas(
        frames.numpy(), cw, sw, fb, jc, interpret=True))
    got = mel.log_mel_frames(frames, tfe.cw, tfe.sw, tfe.fb,
                             cfg.log_floor).numpy()
    assert got.shape == want.shape == (n_frames, cfg.n_mels)
    lin_w, lin_g = np.exp(want), np.exp(got)
    peak = lin_w.max(axis=1, keepdims=True)
    np.testing.assert_allclose(lin_g / peak, lin_w / peak, atol=1e-5, rtol=0)
    sig = lin_w > peak * 1e-6
    np.testing.assert_allclose(got[sig], want[sig], atol=2e-3, rtol=0)
    # All-zero frames sit exactly on the log floor in both.
    zero = (frames.abs().sum(dim=1) == 0).numpy()
    assert zero.any()
    np.testing.assert_array_equal(got[zero], want[zero])


def test_k1_plain_matches_mel_frontend():
    """The port's MelFrontend vs the JAX MelFrontend (interpret mode) from
    raw samples; same criterion as the kernel test."""
    x = _signal(32_000, seed=4)
    want = np.asarray(mel_pallas.MelFrontend(JaxFrontendConfig(),
                                             interpret=True)(x))
    got = mel.MelFrontend(FrontendConfig(), "cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    lin_w, lin_g = np.exp(want), np.exp(got)
    peak = lin_w.max(axis=1, keepdims=True)
    np.testing.assert_allclose(lin_g / peak, lin_w / peak, atol=1e-5, rtol=0)
    sig = lin_w > peak * 1e-6
    np.testing.assert_allclose(got[sig], want[sig], atol=2e-3, rtol=0)


def test_k1_wrapper_counts_only_kernel_launches():
    """On a CPU tensor the wrapper runs the plain version and counts
    nothing: the counter is of kernel launches."""
    tfe = mel.MelFrontend(FrontendConfig(), "cpu")
    before = mel.log_mel_frames.launches
    tfe.log_mel(torch.zeros(1, 256, 1024))
    assert mel.log_mel_frames.launches == before


def test_k1_fft_emulation_matches_pallas_kernel():
    """Kernel K1's FFT (``log_mel_frames_emulated``: the kernel's window
    from cw[:, 0], even/odd packing, radix-8 Stockham stages, twiddle
    table and bin post-processing, in plain PyTorch) against
    log_mel_frames_pallas(interpret=True) at the release frontend's shapes
    (n_fft 1024, 128 mels, 512 frames). On noise frames (every bin well
    above the floor, as chip_smoke.py feeds the kernel) within K1's card
    tolerance, 1e-3 abs on log-mel everywhere; on speech-like frames
    (quiet bins and all-zero frames) by the criterion of
    test_k1_plain_matches_pallas_kernel, all-zero frames exactly on the
    floor."""
    cfg = FrontendConfig()
    jc = JaxFrontendConfig()
    cw, sw, fb = mel_pallas.build_mel_constants(jc)
    tfe = mel.MelFrontend(cfg, "cpu")
    plan = mel.mel_plan(tfe.cw, tfe.sw, tfe.fb, "cpu")
    rng = np.random.default_rng(5)
    noise = (0.1 * rng.standard_normal((512, cfg.n_fft))).astype(np.float32)
    x = _signal(160 * 512 + 1024, seed=6)
    speech, _ = tfe.frames_from_signal(torch.from_numpy(x))
    for frames, exact in ((torch.from_numpy(noise), True),
                          (speech[:512].contiguous(), False)):
        want = np.asarray(mel_pallas.log_mel_frames_pallas(
            frames.numpy(), cw, sw, fb, jc, interpret=True))
        got = mel.log_mel_frames_emulated(frames, plan, tfe.fb,
                                          cfg.log_floor).numpy()
        assert got.shape == want.shape == (512, cfg.n_mels)
        if exact:
            assert np.abs(got - want).max() <= 1e-3
            continue
        lin_w, lin_g = np.exp(want), np.exp(got)
        peak = lin_w.max(axis=1, keepdims=True)
        np.testing.assert_allclose(lin_g / peak, lin_w / peak, atol=1e-5,
                                   rtol=0)
        sig = lin_w > peak * 1e-6
        np.testing.assert_allclose(got[sig], want[sig], atol=2e-3, rtol=0)
        zero = (frames.abs().sum(dim=1) == 0).numpy()
        assert zero.any()
        np.testing.assert_array_equal(got[zero], want[zero])


def test_mel_plan_reads_the_constants():
    """The FFT kernel's plan: the window from cw[:, 0] (400 nonzero
    samples of the 1024), the twiddle table exp(-2 pi i t / 1024) within
    f32 rounding, and each filter's band covering exactly its nonzero bins,
    the weights packed in filter order. Constants that are not a windowed
    DFT are refused."""
    cfg = FrontendConfig()
    cw, sw, fb = mel.build_mel_constants(cfg)
    plan = mel.mel_plan(cw, sw, fb, "cpu")
    np.testing.assert_array_equal(plan.window.numpy(),
                                  frontend.hann_window(cfg.win_length))
    t = np.arange(cfg.n_fft)
    want = np.exp(-2j * np.pi * t / cfg.n_fft)
    tw = plan.twiddles.numpy()
    assert np.abs(tw[:, 0] + 1j * tw[:, 1] - want).max() <= 1e-7
    bands = plan.bands.numpy()
    off = 0
    for m, (lo, cnt, o) in enumerate(bands):
        nz = np.flatnonzero(fb[:, m])
        assert (lo, lo + cnt - 1, o) == (nz[0], nz[-1], off)
        off += cnt
    assert plan.n_weights == off <= mel.KERNEL_MAX_WEIGHTS
    with pytest.raises(ValueError, match="windowed DFT"):
        mel.mel_plan(cw * 1.01, sw, fb, "cpu")
    with pytest.raises(ValueError, match="windowed DFT"):
        mel.mel_plan(cw, np.roll(sw, 1, axis=0), fb, "cpu")
