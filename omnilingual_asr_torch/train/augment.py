"""SpecAugment: time and frequency masking on log-mel batches.

The PyTorch port of ``omnilingual_asr_tpu/train/augment.py`` (Park et al.
2019). Runs on the batch's device inside the train step, driven by a
``torch.Generator`` so every step sees fresh masks; the masks are drawn
from the same distributions as the reference's, not the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SpecAugmentConfig:
    n_freq_masks: int = 2
    freq_mask_width: int = 20     # mel bins
    n_time_masks: int = 2
    time_mask_width: int = 60     # frames (~0.6 s at 10 ms hop)


def spec_augment(gen: torch.Generator, mel: torch.Tensor, mask: torch.Tensor,
                 cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """Apply SpecAugment to a batch.

    mel [B, T, F]; mask [B, T] valid-frame mask (time masks start within
    the valid span). Masked regions take the per-utterance mean of the
    valid frames (gentler than zeroing for log-domain features). ``gen``
    lives on mel's device.
    """
    B, T, F = mel.shape
    dev = mel.device
    m = mask.to(mel.dtype)
    mean = (mel * m[:, :, None]).sum(dim=(1, 2), keepdim=True) / torch.clamp(
        m.sum(dim=1)[:, None, None] * F, min=1.0)

    def randint(high, shape=(B, 1, 1)):
        return torch.randint(0, high, shape, generator=gen, device=dev)

    out = mel
    freq_idx = torch.arange(F, device=dev)[None, None, :]
    for _ in range(cfg.n_freq_masks):
        width = randint(cfg.freq_mask_width + 1)
        start = randint(max(F - cfg.freq_mask_width, 1))
        hit = (freq_idx >= start) & (freq_idx < start + width)
        out = torch.where(hit, mean, out)

    time_idx = torch.arange(T, device=dev)[None, :, None]
    n_valid = mask.sum(dim=1)[:, None, None]
    for _ in range(cfg.n_time_masks):
        width = randint(cfg.time_mask_width + 1)
        lim = torch.clamp(n_valid - width, min=1)
        start = randint(T) % lim
        hit = (time_idx >= start) & (time_idx < start + width)
        out = torch.where(hit, mean, out)
    return out
