"""Log-mel frontend constants and framing.

The PyTorch port's copy of the constant builders of
``omnilingual_asr_tpu/audio/frontend.py`` (HTK mel filterbank, periodic
Hann window, DFT-as-matmul matrices) plus pre-emphasis, written on torch
tensors. The fused log-mel itself is kernel K1 in ``ops/mel.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FrontendConfig


def hz_to_mel(f):
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """Triangular mel filterbank matrix [n_freqs, n_mels], float32."""
    n_freqs = cfg.n_freqs
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(cfg.f_min), hz_to_mel(cfg.fmax),
                          cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, cfg.n_mels), dtype=np.float64)
    for m in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-8)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-8)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def dft_matrices(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real DFT as two dense matrices (cos, -sin), each [n_fft, n_freqs], so
    that for a frame f: Re = f @ cos, Im = f @ sin."""
    n_fft, n_freqs = cfg.n_fft, cfg.n_freqs
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def preemphasis(x: torch.Tensor, coef: float) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1] along the last axis; y[0] = x[0]."""
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], dim=-1)
