"""Sample-wire codecs for host-to-device audio ingress.

The engine ships raw samples to the device, where its per-batch program
decodes them before the mel frontend. int16 ingress (lossless for 16-bit
sources) is the default; μ-law companding (G.711's curve, mu=255) halves the
bytes again at ~38 dB SNR (``ingress="mulaw"``).

Both ends are ours, so the continuous companding formula is used rather
than the G.711 segment approximation; the pair below round-trips to the
quantization floor exactly.

The PyTorch port's own copy of ``omnilingual_asr_tpu/audio/codec.py`` (the
port imports nothing of the JAX package); the device decoder is a torch
function here.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """f32 samples in [-1, 1] -> uint8 μ-law codes."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(MU * np.abs(x)) / np.log1p(MU)
    return np.round((y + 1.0) * 127.5).astype(np.uint8)


def mulaw_decode_np(u: np.ndarray) -> np.ndarray:
    """uint8 μ-law codes -> f32 samples (host reference for tests)."""
    y = u.astype(np.float32) / 127.5 - 1.0
    return np.sign(y) * (np.power(1.0 + MU, np.abs(y)) - 1.0) / MU


def mulaw_decode(u: torch.Tensor) -> torch.Tensor:
    """uint8 μ-law codes -> f32 samples, on the codes' device."""
    y = u.to(torch.float32) / 127.5 - 1.0
    return torch.sign(y) * (torch.pow(1.0 + MU, y.abs()) - 1.0) / MU
