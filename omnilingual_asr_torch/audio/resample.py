"""Host-side sample-rate conversion.

The PyTorch port's own copy of ``omnilingual_asr_tpu/audio/resample.py`` (the port imports nothing
of the JAX package); keep the two in step.

The reference leaves resampling to ffmpeg / the Gemini service; here every
decoder output is normalised to the frontend sample rate (16 kHz) before it
hits the TPU. Polyphase windowed-sinc resampling via a rational L/M factor.
"""

from __future__ import annotations

import math

import numpy as np


def _kaiser_sinc_filter(num_taps: int, cutoff: float, beta: float = 8.6) -> np.ndarray:
    """Low-pass windowed-sinc FIR prototype. cutoff in (0, 1], Nyquist-relative."""
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float64)


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample mono float32 audio from sr_in to sr_out (polyphase)."""
    if sr_in == sr_out or x.size == 0:
        return np.asarray(x, dtype=np.float32)
    g = math.gcd(sr_in, sr_out)
    L, M = sr_out // g, sr_in // g
    # Anti-aliasing cutoff at min(input, output) Nyquist, in units of the
    # upsampled (sr_in * L) Nyquist.
    cutoff = 1.0 / max(L, M)
    taps_per_phase = 24
    num_taps = taps_per_phase * max(L, M)
    if num_taps % 2 == 0:
        num_taps += 1
    h = _kaiser_sinc_filter(num_taps, cutoff) * L

    # Polyphase decomposition: pad h to a multiple of L, reshape to [L, K].
    K = (len(h) + L - 1) // L
    hp = np.zeros(L * K, dtype=np.float64)
    hp[: len(h)] = h
    phases = hp.reshape(K, L).T  # [L, K], phase p holds h[p], h[p+L], ...

    xpad = np.concatenate([np.zeros(K, dtype=np.float64), x.astype(np.float64),
                           np.zeros(K, dtype=np.float64)])
    # Generate enough output to cover the filter group delay, then trim.
    delay_up = (num_taps - 1) // 2
    n_out = int(np.ceil((len(x) * L + delay_up) / M)) + 1
    # Output sample t sits at upsampled index t*M = q*L + p.
    # y[t] = sum_k phases[p, k] * x[q - k]  (with the K-sample left pad, index
    # into xpad at q + K - k). Process in blocks: the [block, K] gather matrix
    # would otherwise be O(n_out * K) floats — 1.6 GB for a 3-minute 44.1 kHz
    # file — so bound it at ~64 MB.
    phases32 = phases.astype(np.float32)
    xpad32 = xpad.astype(np.float32)
    karr = np.arange(K, dtype=np.int32)
    # int32 indices + this block size keep the [block, K] index matrix plus
    # the two float32 gathers at ~48 MB peak per block.
    block = max(1, (1 << 22) // max(K, 1))
    y = np.empty(n_out, dtype=np.float32)
    for b0 in range(0, n_out, block):
        t = np.arange(b0, min(b0 + block, n_out), dtype=np.int64)
        q = ((t * M) // L).astype(np.int32)
        p = ((t * M) % L).astype(np.int32)
        idx = (q[:, None] + K) - karr[None, :]
        y[b0:b0 + len(t)] = np.einsum(
            "tk,tk->t", phases32[p], xpad32[idx])
    # Compensate the group delay of the causal prototype ((num_taps-1)/2
    # upsampled samples), then trim to the exact output length.
    delay_out = int(round(delay_up / M))
    y = y[delay_out: delay_out + int(len(x) * L // M)]
    return y.astype(np.float32)
