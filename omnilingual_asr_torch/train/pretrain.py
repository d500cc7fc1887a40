"""Self-supervised pretraining: BEST-RQ-style masked prediction, on one GPU.

The PyTorch port of ``omnilingual_asr_tpu/train/pretrain.py``. The
omnilingual claim (1600+ languages) rests on self-supervised pretraining
over unlabeled speech: labels exist for only a fraction of those languages.
The recipe is BEST-RQ's (random-projection quantizer, Chiu et al. 2022):

1. a FROZEN random projection + codebook turn each (stacked) mel frame into
   a discrete target id;
2. contiguous spans of the input mel are masked (replaced with noise);
3. the conformer encoder + a linear head predict the target ids at masked
   positions (cross-entropy).

After pretraining, ``params["encoder"]`` warm-starts the supervised
multi-task training (``synth_train --init-encoder``).

The random inputs of a step (the span starts and the noise) are arguments
of :func:`pretrain_loss`; :func:`make_pretrain_step` draws them from a
``torch.Generator`` seeded from the step, as the reference folds the step
into ``PRNGKey(0)`` (the bits differ from ``jax.random``'s). The quantizer's
targets are an argmax over the codebook: TF32 stays off for that product on
the card (PyTorch's default, and the entry points set it), as for every
f32 GEMM of the port. Over a (data, model) mesh the step is
``train/mesh_step.py``'s, with the reference's ``pretrain_param_specs``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..config import PipelineConfig
from ..models import layers as L
from ..models.conformer import (asr_forward, asr_init, subsample_frames,
                                subsampled_mask)
from ..parallel.mesh import Mesh
from .step import (Optimizer, OptState, make_optimizer, mel_from_samples,
                   training_device, tree_leaves, tree_map)

#: Generator seed of a step's span starts and noise: the step plus this
#: salt (the reference folds the step into PRNGKey(0)).
_PRETRAIN_SALT = 2 << 40


@dataclass(frozen=True)
class PretrainConfig:
    codebook_size: int = 8192
    codebook_dim: int = 16
    mask_prob: float = 0.06       # probability a subsampled frame STARTS a mask
    mask_span: int = 5            # masked span length (subsampled frames)
    noise_scale: float = 0.1


def make_quantizer(gen: torch.Generator, cfg: PipelineConfig,
                   pcfg: PretrainConfig) -> Dict[str, torch.Tensor]:
    """Frozen random projection + codebook (never trained), each column of
    the projection and row of the codebook of unit norm."""
    in_dim = cfg.frontend.n_mels * cfg.encoder.subsample_factor
    proj = torch.randn((in_dim, pcfg.codebook_dim), generator=gen)
    proj = proj / torch.linalg.norm(proj, dim=0, keepdim=True)
    codebook = torch.randn((pcfg.codebook_size, pcfg.codebook_dim),
                           generator=gen)
    codebook = codebook / torch.linalg.norm(codebook, dim=1, keepdim=True)
    return {"proj": proj, "codebook": codebook}


@torch.no_grad()
def quantize_targets(quantizer: Dict[str, torch.Tensor], mel: torch.Tensor,
                     sub: int) -> torch.Tensor:
    """Target ids [B, T'] from unmasked mel [B, T, F] (frame stacking
    matches the encoder's subsampler so targets align 1:1 with encoder
    frames)."""
    stacked = subsample_frames(mel, sub)               # [B, T', sub*F]
    # Per-utterance standardization before projection (BEST-RQ detail:
    # keeps the random quantizer balanced across loudness).
    mean = stacked.mean(dim=(1, 2), keepdim=True)
    std = stacked.std(dim=(1, 2), keepdim=True, correction=0) + 1e-5
    z = (stacked - mean) / std
    v = z @ quantizer["proj"]                          # [B, T', D]
    v = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-9)
    sims = torch.einsum("btd,cd->btc", v, quantizer["codebook"])
    return torch.argmax(sims, dim=-1)                  # [B, T']


def span_starts(gen: torch.Generator, B: int, Tp: int,
                pcfg: PretrainConfig, device="cpu") -> torch.Tensor:
    """[B, T'] bool Bernoulli(mask_prob) span starts."""
    return torch.rand((B, Tp), generator=gen, device=device) < pcfg.mask_prob


def make_span_mask(starts: torch.Tensor, pcfg: PretrainConfig) -> torch.Tensor:
    """[B, T'] bool, True where the input is masked: each start smeared over
    the ``mask_span`` frames from it."""
    m = starts
    for s in range(1, pcfg.mask_span):
        m = m | torch.nn.functional.pad(starts, (s, 0))[:, :starts.shape[1]]
    return m


def pretrain_init(gen: torch.Generator, cfg: PipelineConfig,
                  pcfg: PretrainConfig):
    return {
        "encoder": asr_init(gen, cfg),
        "head": L.dense_init(gen, cfg.encoder.d_model, pcfg.codebook_size),
    }


def pretrain_loss(params, quantizer, batch, starts: torch.Tensor,
                  noise: torch.Tensor, cfg: PipelineConfig,
                  pcfg: PretrainConfig,
                  targets: Optional[torch.Tensor] = None, forward=None):
    """Masked-prediction CE -> (loss, metrics). batch: mel [B, T, F], mask
    [B, T] (valid). ``starts`` [B, T'] bool span starts and ``noise`` [B, T,
    F] standard normal: the step's random draws. ``targets`` [B, T']: the
    quantizer's ids, computed from the mel when None. ``forward(corrupted,
    valid)`` -> the head's logits [B, T', codebook] over the whole batch
    (default: the encoder and the head of ``params`` on one device; a mesh
    computes them over its shards, ``train/mesh_step.py``)."""
    mel, valid = batch["mel"], batch["mask"]
    sub = cfg.encoder.subsample_factor
    T = mel.shape[1]
    if targets is None:
        targets = quantize_targets(quantizer, mel, sub)
    span_mask = make_span_mask(starts, pcfg) & subsampled_mask(valid, sub)

    # Corrupt the input: replace masked frames with gaussian noise.
    frame_mask = torch.repeat_interleave(span_mask, sub, dim=1)[:, :T]
    corrupted = torch.where(frame_mask[:, :, None],
                            pcfg.noise_scale * noise, mel)

    if forward is None:
        out = asr_forward(params["encoder"], corrupted, valid, cfg)
        logits = L.dense_apply(params["head"], out["encoder_states"])
    else:
        logits = forward(corrupted, valid)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.to(torch.long)[..., None])[..., 0]
    w = span_mask.to(torch.float32)
    n = torch.clamp(w.sum(), min=1.0)
    loss = (nll * w).sum() / n
    with torch.no_grad():
        acc = ((torch.argmax(logits, -1) == targets) * w).sum() / n
    return loss, {"loss": loss.detach(), "masked_acc": acc,
                  "masked_frames": w.sum()}


def step_draws(step: int, B: int, T: int, cfg: PipelineConfig,
               pcfg: PretrainConfig, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The span starts [B, T // sub] and the standard-normal noise [B, T,
    n_mels] of step ``step``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(_PRETRAIN_SALT
                                                     + int(step))
    starts = span_starts(gen, B, T // cfg.encoder.subsample_factor, pcfg,
                         device)
    noise = torch.randn((B, T, cfg.frontend.n_mels), generator=gen,
                        device=device)
    return starts, noise


def make_pretrain_step(cfg: PipelineConfig, device=None,
                       pcfg: PretrainConfig = PretrainConfig(),
                       tx: Optional[Optimizer] = None,
                       from_samples: bool = False):
    """Returns ``(init_state, pretrain_step, loss_and_grads)`` on one
    device (the card when ``device`` is None, which raises without one;
    ``"cpu"`` for the CPU), or over a (data, model) mesh when ``device`` is
    a ``parallel.mesh.Mesh`` (``train/mesh_step.py``: the parameters a
    ``MeshParams`` placed by ``pretrain_param_specs``, the head split over
    its codes; the same functions otherwise).

    ``init_state(seed)`` -> (params, quantizer, opt_state): params from
    ``seed``, the quantizer from ``seed + 1``, on ``device``.
    ``pretrain_step(params, quantizer, opt_state, batch, step, draws=None)``
    -> (params, opt_state, step + 1, metrics), the parameters updated in
    place. The batch holds ``mel`` and ``mask``, or with ``from_samples``
    a sample wire (int16, uint8 mu-law or f32) as ``samples`` whose log-mel
    (kernel K1 on the card) the step computes. ``draws``: (starts, noise)
    in place of :func:`step_draws`'. ``loss_and_grads(params, quantizer,
    batch, step, draws=None)`` -> (metrics, grads aligned with
    ``tree_leaves(params)``), the step without the update.
    """
    tx = tx or make_optimizer(lr=2e-3)
    if isinstance(device, Mesh):
        from .mesh_step import make_mesh_pretrain_step

        return make_mesh_pretrain_step(cfg, device, pcfg, tx, from_samples)
    device = training_device(device)
    frontend = None
    if from_samples:
        from ..ops.mel import MelFrontend

        frontend = MelFrontend(cfg.frontend, device)

    def init_state(seed: int = 0):
        params = pretrain_init(torch.Generator().manual_seed(seed), cfg, pcfg)
        params = tree_map(lambda t: t.to(device).requires_grad_(True), params)
        quantizer = make_quantizer(torch.Generator().manual_seed(seed + 1),
                                   cfg, pcfg)
        quantizer = {k: v.to(device) for k, v in quantizer.items()}
        return params, quantizer, tx.init(params)

    def loss_and_grads(params, quantizer, batch, step: int, draws=None):
        if from_samples:
            batch = mel_from_samples(batch, frontend)
        if draws is None:
            B, T = batch["mask"].shape
            draws = step_draws(step, B, T, cfg, pcfg, device)
        loss, metrics = pretrain_loss(params, quantizer, batch, *draws, cfg,
                                      pcfg)
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    allow_unused=True)
        return metrics, list(grads)

    def pretrain_step(params, quantizer, opt_state: OptState, batch,
                      step: int, draws=None):
        metrics, grads = loss_and_grads(params, quantizer, batch, step, draws)
        tx.update(opt_state, grads)
        return params, opt_state, step + 1, metrics

    return init_state, pretrain_step, loss_and_grads
