"""Device-resident example pool: near-zero per-step host-to-device bytes.

The PyTorch port of ``omnilingual_asr_tpu/train/device_pool.py``. Shipping
a full audio batch every step costs host-to-device bytes and host time
(~2 MB at batch 16 of 8 s on the int16 wire); the pool keeps the
*dataset* on the card instead:

  - the host bakes a pool of P collated examples ONCE (``SynthBatcher`` in
    ``bake_mode``: the expensive augments — speed/channel/LTAS EQ —
    applied, gain/noise left clean) and ships it to the card: ~1 GB at
    P=4096, 8 s windows, int16 (half that on the mu-law wire);
  - every step ships only a [B] int32 index vector + the curriculum
    scalars. The step gathers the batch rows on the card
    (``index_select``), applies gain + additive-noise augmentation there
    (a fresh realization a step, mirroring ``SynthBatcher._collate``'s host
    augmentation), then runs the usual log-mel (kernel K1) -> conformer ->
    multi-task loss;
  - every ``refresh_every`` steps the host bakes one fresh batch and
    overwrites a rotating slice of the pool in place (no reallocation), so
    the pool churns completely every P/B * refresh_every steps.

The augmentation's draws (gain, SNR, noise) are arguments of
:func:`augment_samples`; the step draws them from a ``torch.Generator``
seeded from the step, as the reference folds the step into
``PRNGKey(17)`` (the bits differ from ``jax.random``'s).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..parallel.mesh import Mesh, require_one_process
from .step import (Optimizer, OptState, counted_grads, decode_wire,
                   make_optimizer, make_train_step, training_device)

__all__ = ["build_pool", "make_pool_train_step", "encode_wire"]

#: Generator seed of a step's gain, SNR and noise: the step plus this salt
#: (the reference folds the step into PRNGKey(17)).
_POOL_SALT = 17 << 40


def encode_wire(samples: np.ndarray, wire: str) -> np.ndarray:
    """f32 [-1,1] -> pool storage dtype (int16, or uint8 mu-law: half)."""
    if wire == "mulaw":
        from ..audio.codec import mulaw_encode

        return mulaw_encode(samples)
    return np.clip(samples * 32768.0, -32768, 32767).astype(np.int16)


def build_pool(batches: Iterator[Dict[str, np.ndarray]], n_entries: int,
               wire: str = "i16") -> Dict[str, np.ndarray]:
    """Concatenate bake-mode batches into host pool arrays [P, ...].

    ``batches`` must come from a SynthBatcher(bake_mode=True) so entries
    carry ``n_samples`` and un-noised audio.
    """
    parts: Dict[str, list] = {}
    n = 0
    while n < n_entries:
        b = next(batches)
        if "n_samples" not in b:
            raise ValueError("device pool requires bake_mode batches "
                             "(missing n_samples)")
        for k, v in b.items():
            parts.setdefault(k, []).append(v)
        n += len(b["n_samples"])
    pool = {k: np.concatenate(v)[:n_entries] for k, v in parts.items()}
    pool["samples"] = encode_wire(pool["samples"], wire)
    return pool


def pool_to_device(pool: Dict[str, np.ndarray],
                   device) -> Dict[str, torch.Tensor]:
    """The host pool's arrays as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in pool.items()}


def augment_draws(gen: torch.Generator, B: int, W: int,
                  snr_range: Tuple[float, float],
                  gain_range: Tuple[float, float], device="cpu"):
    """(gain [B, 1] ~ U(gain_range), snr [B, 1] ~ U(snr_range), noise [B, W]
    standard normal), drawn on ``device``."""
    def uniform(lo, hi):
        u = torch.rand((B, 1), generator=gen, device=device)
        return lo + (hi - lo) * u

    gain = uniform(*gain_range)
    snr = uniform(*snr_range)
    noise = torch.randn((B, W), generator=gen, device=device)
    return gain, snr, noise


def augment_samples(x: torch.Tensor, n_valid: torch.Tensor,
                    gain: torch.Tensor, snr: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
    """The on-device mirror of SynthBatcher._collate's per-draw noise: gain,
    then additive white noise at ``snr`` dB relative to the gained signal
    power over the valid samples, masked to the valid region, clipped."""
    W = x.shape[1]
    valid = (torch.arange(W, device=x.device)[None, :]
             < n_valid[:, None]).to(x.dtype)
    x = x * gain
    p_sig = (x * x * valid).sum(dim=1, keepdim=True) \
        / torch.clamp(n_valid[:, None].to(x.dtype), min=1.0) + 1e-12
    noise = noise * torch.sqrt(p_sig / 10.0 ** (snr / 10.0))
    return torch.clamp(x + noise * valid, -1.0, 1.0)


def make_pool_train_step(cfg: PipelineConfig, device=None,
                         tx: Optional[Optimizer] = None,
                         augment=None,
                         with_translator: bool = False,
                         snr_range: Optional[Tuple[float, float]]
                         = (15.0, 40.0),
                         gain_range: Tuple[float, float] = (0.7, 1.3),
                         dropout: bool = False):
    """Returns ``(init_state, pool_step, refresh_pool, loss_and_grads)``,
    on one device (the card when ``device`` is None, which raises without
    one; ``"cpu"`` for the CPU) or over a (data, model) mesh when
    ``device`` is a
    ``parallel.mesh.Mesh``: the pool then lives on shard (0, 0)'s device
    (the reference replicates it; a row's entries read from one copy are
    the same), the step's rows and draws are gathered and drawn there, and
    ``make_train_step``'s mesh step splits the rows over ``data``.

    ``init_state(seed)``: ``make_train_step``'s. ``pool_step(params,
    opt_state, pool, idx, step, scalars, draws=None)`` — one training step
    on pool rows ``idx`` (a [B] integer tensor on ``device``) with fresh
    on-device gain/noise augmentation (off entirely when ``snr_range`` is
    None, e.g. for equivalence tests against the host-batch path); the
    parameters are updated in place. ``scalars`` join the batch (the ramp
    weights, and the host's ``step.CTC_INFEASIBLE`` rows). ``draws``:
    (gain, snr, noise) in place of the step's own. ``loss_and_grads``
    takes the same arguments but the optimizer state and returns
    (metrics, grads).

    ``refresh_pool(pool, start, new)`` — overwrite pool rows
    [start:start+R) with a freshly baked slice, in place; returns the pool.
    """
    tx = tx or make_optimizer()
    if isinstance(device, Mesh):
        require_one_process(device, "the device-pool step")
    init_state, _, batch_grads = make_train_step(
        cfg, device, tx=tx, from_samples=True, augment=augment,
        with_translator=with_translator, dropout=dropout)
    if isinstance(device, Mesh):
        device = device.devices[0, 0]
    device = training_device(device)

    def gathered(pool, idx, step: int, scalars, draws=None):
        n_valid = pool["n_samples"].index_select(0, idx)
        batch = {k: v.index_select(0, idx) for k, v in pool.items()
                 if k != "n_samples"}
        x = decode_wire(batch["samples"])
        if snr_range is not None:
            if draws is None:
                gen = torch.Generator(device=device).manual_seed(
                    _POOL_SALT + int(step))
                draws = augment_draws(gen, *x.shape, snr_range, gain_range,
                                      device)
            x = augment_samples(x, n_valid, *draws)
        batch["samples"] = x
        batch.update(scalars)
        return batch

    def loss_and_grads(params, pool, idx, step: int, scalars, draws=None):
        return batch_grads(params, gathered(pool, idx, step, scalars, draws),
                           step)

    def pool_step(params, opt_state: OptState, pool, idx, step: int,
                  scalars, draws=None):
        metrics, grads = loss_and_grads(params, pool, idx, step, scalars,
                                        draws)
        tx.update(opt_state, grads, counted_grads(params, grads))
        return params, opt_state, step + 1, metrics

    def refresh_pool(pool, start: int, new):
        for k, v in pool.items():
            src = new[k]
            if isinstance(src, np.ndarray):
                src = torch.from_numpy(np.ascontiguousarray(src))
            v[start:start + src.shape[0]].copy_(src)
        return pool

    return init_state, pool_step, refresh_pool, loss_and_grads
