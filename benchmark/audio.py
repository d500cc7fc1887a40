"""Inputs drawn from the seed: long files and training rows tiled from the
frozen golden dialogue (``benchmark/data/golden.wav``: 7.63 s, Georgian
and Greek, two speakers).

Each copy of the dialogue gets its own gain, circular offset and white
noise at a drawn SNR, so every file and row differs while every seed draws
the same sizes.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parent / "data" / "golden.wav"
SAMPLE_RATE = 16_000


def golden() -> np.ndarray:
    """The dialogue as f32 samples in [-1, 1]."""
    with wave.open(str(GOLDEN), "rb") as w:
        if w.getframerate() != SAMPLE_RATE or w.getsampwidth() != 2:
            raise ValueError(f"{GOLDEN}: expected 16-bit {SAMPLE_RATE} Hz")
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        if w.getnchannels() > 1:
            x = x.reshape(-1, w.getnchannels()).mean(axis=1)
    return x.astype(np.float32) / 32768.0


def tiled_file(rng: np.random.Generator, n_samples: int,
               gain=(0.7, 1.3), snr_db=(20.0, 40.0)) -> np.ndarray:
    """int16 samples of length ``n_samples``: copies of the dialogue, each
    rolled by a drawn offset, scaled by a drawn gain and given white noise
    at a drawn SNR relative to the copy's power."""
    src = golden()
    parts, n = [], 0
    while n < n_samples:
        c = np.roll(src, int(rng.integers(0, len(src)))) \
            * rng.uniform(*gain)
        p = float(np.mean(c * c)) + 1e-12
        snr = rng.uniform(*snr_db)
        c = c + rng.standard_normal(len(c)).astype(np.float32) \
            * np.sqrt(p / 10.0 ** (snr / 10.0))
        parts.append(c)
        n += len(c)
    x = np.concatenate(parts)[:n_samples]
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


def write_wav(path: Path, samples: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(samples.astype("<i2").tobytes())


def pool_rows(seed: int, n_rows: int, n_samples: int, device,
              gain=(0.7, 1.3), snr_db=(20.0, 40.0)):
    """[n_rows, n_samples] int16 rows on ``device``: crops of the tiled
    dialogue at drawn offsets, each with a drawn gain and white noise at a
    drawn SNR, made on the device from one generator."""
    import torch

    src = torch.from_numpy(golden()).to(device)
    reps = -(-(2 * n_samples) // src.numel()) + 1
    tape = src.repeat(reps)
    gen = torch.Generator(device=device).manual_seed(seed)
    offs = torch.randint(0, src.numel(), (n_rows,), generator=gen,
                         device=device)
    idx = offs[:, None] + torch.arange(n_samples, device=device)[None, :]
    x = tape[idx]
    g = gain[0] + (gain[1] - gain[0]) * torch.rand(
        (n_rows, 1), generator=gen, device=device)
    snr = snr_db[0] + (snr_db[1] - snr_db[0]) * torch.rand(
        (n_rows, 1), generator=gen, device=device)
    x = x * g
    p = (x * x).mean(dim=1, keepdim=True) + 1e-12
    x = x + torch.randn(x.shape, generator=gen, device=device) \
        * torch.sqrt(p / 10.0 ** (snr / 10.0))
    return torch.clamp(torch.round(x * 32768.0), -32768,
                       32767).to(torch.int16)
