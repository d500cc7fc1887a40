"""Fused log-mel frontend: kernel K1 and its plain PyTorch versions.

Port of ``omnilingual_asr_tpu/ops/mel_pallas.py``: ``build_mel_constants``,
``MelFrontend`` and the log-mel over pre-cut frames,

    log(max(((F Cw)^2 + (F Sw)^2) FB, floor))

with the Hann window folded into the DFT matrices (513 bins; the reference
pads them to 640 for its 128-lane tiles). ``log_mel_frames`` launches the
CUDA kernel (``csrc/mel.cu``) for CUDA tensors and runs
``log_mel_frames_plain`` (the dense DFT, as the reference computes it)
for CPU tensors. The kernel
computes the same function with a real FFT of the windowed frame and the
filterbank's nonzero bands, from a :class:`MelPlan` that
:func:`mel_plan` derives once from (cw, sw, fb);
``log_mel_frames_emulated`` is that FFT in plain PyTorch, with the kernel's
stages, twiddle table and bin post-processing. All are f32 throughout:
the reference computes at ``Precision.HIGHEST``, so TF32 must stay off for
the plain version on a card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..audio.frontend import (dft_matrices, hann_window, mel_filterbank,
                              preemphasis)
from ..config import FrontendConfig
from ..device import resolve_device
from . import cuda_build

#: Frames are padded to a multiple of this, as the reference pads them for
#: its 256-frame kernel blocks; the engine's window length derives from it.
BLOCK_T = 256
#: Frame length the FFT kernel takes: a 512-point complex FFT of the
#: even/odd-packed samples, three radix-8 stages.
KERNEL_N_FFT = 1024
#: Mel filters the kernel takes (two a thread of 64 a frame).
KERNEL_N_MELS = 128
#: Largest number of nonzero filterbank weights the kernel holds in shared
#: memory (the release filterbank has 1 013).
KERNEL_MAX_WEIGHTS = 4096


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_mel_constants(cfg: FrontendConfig):
    """Windowed DFT and mel matrices over the n_fft / 2 + 1 bins.

    Returns numpy (cw, sw, fb): cw, sw [n_fft, n_bins], fb [n_bins,
    n_mels], all float32.
    """
    cos_m, sin_m = dft_matrices(cfg)
    win = np.zeros(cfg.n_fft, dtype=np.float32)
    win[: cfg.win_length] = hann_window(cfg.win_length)
    cw = win[:, None] * cos_m
    sw = win[:, None] * sin_m
    return cw, sw, mel_filterbank(cfg)


def log_mel_frames_plain(frames: torch.Tensor, cw: torch.Tensor,
                         sw: torch.Tensor, fb: torch.Tensor,
                         log_floor: float) -> torch.Tensor:
    """Plain PyTorch log-mel over frames [N, n_fft] f32 -> [N, n_mels]."""
    re = frames @ cw
    im = frames @ sw
    power = re * re + im * im
    mel = power @ fb
    return torch.log(torch.clamp(mel, min=log_floor))


@dataclass(frozen=True)
class MelPlan:
    """What the FFT kernel needs beside fb, derived once from the
    constants: the window (``cw[:n_win, 0]``, as cos 0 = 1; zero past
    n_win), the twiddle table exp(-2 pi i t / n_fft) for t < n_fft as f32
    (cos, -sin) pairs computed in float64, and each mel filter's band of
    nonzero bins as (first bin, count, offset of its first weight in the
    packed weights), int32 [n_mels, 3]."""

    window: torch.Tensor
    twiddles: torch.Tensor
    bands: torch.Tensor
    n_weights: int


def twiddle_table(n_fft: int) -> np.ndarray:
    """exp(-2 pi i t / n_fft), t < n_fft, as f32 [n_fft, 2] (cos, -sin),
    computed in float64."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


def mel_plan(cw, sw, fb, device=None) -> MelPlan:
    """Derive and check the FFT kernel's plan from the dense constants
    (numpy arrays, or tensors, which are read back to the host once), on
    ``device`` (the card when None, which raises without one; ``"cpu"``
    for the CPU).

    Raises unless cw and sw are the windowed DFT of the window in their
    first column (cos 0 = 1) with zero padding bins, and fb is zero on the
    padding bins; each filter's band is the span of its nonzero bins."""
    cw, sw, fb = (np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                             else t, np.float32) for t in (cw, sw, fb))
    n_fft, n_bins = cw.shape
    n_freqs = n_fft // 2 + 1
    win = cw[:, 0].copy()
    nz = np.flatnonzero(win)
    n_win = int(nz[-1]) + 1 if nz.size else 1
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    want_c = win[:, None] * np.cos(ang).astype(np.float32)
    want_s = win[:, None] * (-np.sin(ang)).astype(np.float32)
    if (sw.shape != cw.shape or n_bins < n_freqs
            or fb.shape[0] != n_bins
            or not np.allclose(cw[:, :n_freqs], want_c, rtol=0, atol=1e-6)
            or not np.allclose(sw[:, :n_freqs], want_s, rtol=0, atol=1e-6)
            or cw[:, n_freqs:].any() or sw[:, n_freqs:].any()
            or fb[n_freqs:].any()):
        raise ValueError("cw/sw are not the windowed DFT of the window in "
                         "cw[:, 0] (or fb is nonzero on padding bins): the "
                         "log-mel kernel computes that function only")
    bands, off = [], 0
    for m in range(fb.shape[1]):
        nzm = np.flatnonzero(fb[:, m])
        lo, cnt = (int(nzm[0]), int(nzm[-1] - nzm[0] + 1)) if nzm.size \
            else (0, 0)
        bands.append((lo, cnt, off))
        off += cnt
    device = resolve_device(device)
    return MelPlan(torch.from_numpy(win[:n_win].copy()).to(device),
                   torch.from_numpy(twiddle_table(n_fft)).to(device),
                   torch.tensor(bands, dtype=torch.int32, device=device), off)


def _dft8(re, im):
    """Radix-8 butterfly on lists of 8 f32 (re, im) tensors, in the
    kernel's order: two radix-4 halves (even, odd inputs), then the odd
    half times exp(-2 pi i q / 8)."""
    r2 = torch.tensor(0.70710678118654752, dtype=torch.float32)

    def dft4(xr, xi):
        ar, ai = xr[0] + xr[2], xi[0] + xi[2]
        br, bi = xr[0] - xr[2], xi[0] - xi[2]
        cr, ci = xr[1] + xr[3], xi[1] + xi[3]
        dr, di = xi[1] - xi[3], xr[3] - xr[1]      # -i (x1 - x3)
        return ([ar + cr, br + dr, ar - cr, br - dr],
                [ai + ci, bi + di, ai - ci, bi - di])

    er, ei = dft4(re[0::2], im[0::2])
    orr, oi = dft4(re[1::2], im[1::2])
    # odd half times w^q: 1, (1 - i) / sqrt 2, -i, (-1 - i) / sqrt 2
    wr = [orr[0], r2 * (orr[1] + oi[1]), oi[2], r2 * (oi[3] - orr[3])]
    wi = [oi[0], r2 * (oi[1] - orr[1]), -orr[2], -r2 * (orr[3] + oi[3])]
    return ([er[q] + wr[q] for q in range(4)] + [er[q] - wr[q]
                                                 for q in range(4)],
            [ei[q] + wi[q] for q in range(4)] + [ei[q] - wi[q]
                                                 for q in range(4)])


def log_mel_frames_emulated(frames: torch.Tensor, plan: MelPlan,
                            fb: torch.Tensor,
                            log_floor: float) -> torch.Tensor:
    """Kernel K1's FFT in plain PyTorch (CPU tests): frames [N, 1024] f32
    -> [N, n_mels]. The samples under the window are windowed and packed
    as z[m] = x[2m] + i x[2m+1]; a 512-point complex FFT runs as three
    radix-8 Stockham stages (64 butterflies each, input i + 64 r,
    twiddles from the plan's table, output (i - k) 8 + k + q p for stage
    stride p and k = i mod p); bins 0..512 of the real FFT come from
    Z[k] and conj(Z[512 - k]); then power and the mel projection (dense,
    over the real bins) and the log."""
    n, n_fft = frames.shape
    half = n_fft // 2
    f32 = torch.float32
    xw = torch.zeros((n, n_fft), dtype=f32, device=frames.device)
    n_win = plan.window.shape[0]
    xw[:, :n_win] = frames[:, :n_win].to(f32) * plan.window.to(f32)
    zr, zi = xw[:, 0::2], xw[:, 1::2]
    tw = plan.twiddles.to(f32)
    i = torch.arange(half // 8, device=frames.device)
    for p in (1, 8, 64):
        k = i % p
        ur = [zr[:, i + 64 * r] for r in range(8)]
        ui = [zi[:, i + 64 * r] for r in range(8)]
        if p > 1:
            for r in range(1, 8):
                t = r * k * (2 * half // (8 * p))
                c, s = tw[t, 0], tw[t, 1]
                ur[r], ui[r] = ur[r] * c - ui[r] * s, ur[r] * s + ui[r] * c
        vr, vi = _dft8(ur, ui)
        j = (i - k) * 8 + k
        yr, yi = torch.empty_like(zr), torch.empty_like(zi)
        for q in range(8):
            yr[:, j + q * p], yi[:, j + q * p] = vr[q], vi[q]
        zr, zi = yr, yi
    kb = torch.arange(half + 1, device=frames.device)
    a, b = zr[:, kb % half], zi[:, kb % half]
    c, d = zr[:, (half - kb) % half], zi[:, (half - kb) % half]
    er, ei = (a + c) * 0.5, (b - d) * 0.5
    orr, oi = (b + d) * 0.5, (c - a) * 0.5
    wc, ws = tw[kb, 0], tw[kb, 1]
    xr = er + (wc * orr - ws * oi)
    xi = ei + (wc * oi + ws * orr)
    power = xr * xr + xi * xi
    mel = power @ fb[:half + 1].to(f32)
    return torch.log(torch.clamp(mel, min=log_floor))


def log_mel_frames(frames: torch.Tensor, cw: torch.Tensor, sw: torch.Tensor,
                   fb: torch.Tensor, log_floor: float,
                   plan: MelPlan | None = None) -> torch.Tensor:
    """Log-mel over frames [N, n_fft] f32 -> [N, n_mels] f32.

    A CUDA tensor goes to kernel K1 (n_fft 1024, 128 mels), which reads
    the frames under the window, fb and ``plan`` (:func:`mel_plan` of these
    cw, sw, fb; :class:`MelFrontend` holds one). Without ``plan`` it is
    derived here, which reads the constants back to the host. A CPU tensor
    goes to the plain version.
    """
    if not frames.is_cuda:
        return log_mel_frames_plain(frames, cw, sw, fb, log_floor)
    n, n_fft = frames.shape
    n_bins, n_mels = fb.shape
    dev = frames.device
    f32 = torch.float32
    if plan is None:
        plan = mel_plan(cw, sw, fb, dev)
    n_win = plan.window.shape[0]
    cuda_build.check_tensor(frames, "frames", f32, device=dev)
    cuda_build.check_tensor(fb, "fb", f32, (n_bins, n_mels), dev)
    cuda_build.check_tensor(plan.window, "plan.window", f32, (n_win,), dev)
    cuda_build.check_tensor(plan.twiddles, "plan.twiddles", f32,
                            (n_fft, 2), dev)
    cuda_build.check_tensor(plan.bands, "plan.bands", torch.int32,
                            (n_mels, 3), dev)
    if (n_fft != KERNEL_N_FFT or n_mels != KERNEL_N_MELS or n == 0
            or n_win > n_fft or n_bins < n_fft // 2 + 1
            or plan.n_weights > KERNEL_MAX_WEIGHTS):
        raise ValueError(
            f"log-mel kernel takes n_fft {KERNEL_N_FFT}, n_mels "
            f"{KERNEL_N_MELS}, at least one frame and at most "
            f"{KERNEL_MAX_WEIGHTS} filterbank weights; got {n_fft}, "
            f"{n_mels}, {n}, {plan.n_weights}")
    out = torch.empty((n, n_mels), dtype=f32, device=dev)
    lib = cuda_build.library()
    err = lib.omni_log_mel(frames.data_ptr(), plan.window.data_ptr(), n_win,
                           plan.twiddles.data_ptr(), fb.data_ptr(),
                           plan.bands.data_ptr(), plan.n_weights,
                           out.data_ptr(), n, n_fft, n_mels,
                           float(log_floor), cuda_build.stream_ptr(dev))
    cuda_build.check(err, "log-mel kernel")
    log_mel_frames.launches += 1
    return out


log_mel_frames.launches = 0


class MelFrontend:
    """Holds the mel constants on a device (the card when ``device`` is
    None, which raises without one; ``"cpu"`` for the CPU) and cuts frames
    from samples.

    Frames are cut at length n_fft (not win_length); the zero tail of the
    folded window kills the extra samples, so the result equals
    window-then-zero-pad.
    """

    def __init__(self, cfg: FrontendConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        cw, sw, fb = build_mel_constants(cfg)
        self.cw = torch.from_numpy(cw).to(self.device)
        self.sw = torch.from_numpy(sw).to(self.device)
        self.fb = torch.from_numpy(fb).to(self.device)
        #: The FFT kernel's window, twiddles and filter bands (checked).
        self.plan = mel_plan(cw, sw, fb, self.device)

    def frames_from_signal(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Pre-emphasis + strided framing at n_fft length.

        x: [..., n] samples. Returns (frames [..., T_pad, n_fft], n_frames)
        with T_pad a multiple of BLOCK_T and the padded rows zero.
        """
        cfg = self.cfg
        x = preemphasis(x.to(torch.float32), cfg.preemphasis)
        lead = x.shape[:-1]
        n_frames = cfg.frames_for_samples(x.shape[-1])
        if n_frames <= 0:
            return x.new_zeros((*lead, BLOCK_T, cfg.n_fft)), 0
        need = (n_frames - 1) * cfg.hop_length + cfg.n_fft
        if need > x.shape[-1]:
            x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
        view = x.unfold(-1, cfg.n_fft, cfg.hop_length)[..., :n_frames, :]
        frames = x.new_zeros((*lead, _round_up(n_frames, BLOCK_T), cfg.n_fft))
        frames[..., :n_frames, :] = view
        return frames, n_frames

    def log_mel(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames [..., n_fft] -> log-mel [..., n_mels]."""
        lead = frames.shape[:-1]
        flat = frames.reshape(-1, self.cfg.n_fft)
        mel = log_mel_frames(flat, self.cw, self.sw, self.fb,
                             self.cfg.log_floor, self.plan)
        return mel.reshape(*lead, self.cfg.n_mels)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Raw samples [n] -> log-mel [n_frames, n_mels]."""
        frames, n_frames = self.frames_from_signal(x)
        return self.log_mel(frames)[:n_frames]
