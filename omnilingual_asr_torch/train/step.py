"""Multi-task training step on one device.

The PyTorch port of ``omnilingual_asr_tpu/train/step.py``: CTC over byte
labels, cross-entropy for the LID and emotion heads, the optional
frame-level LID, dense byte-CE, AAM-softmax speaker and translation terms
(each keyed by the batch's contents), and the reference's optimizer
(warmup-cosine learning rate, clip by global norm 1.0, ``zero_nans``,
AdamW). One device; sharding over a mesh is A10 in ROADMAP.md.

Parameters are trees of leaf tensors (``requires_grad``), updated in place
by the optimizer; the step function returns them as the reference's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..config import PipelineConfig
from ..models.conformer import asr_forward, asr_init, pooled_speaker_embed
from ..ops.ctc import ctc_loss

#: Generator seeds of a step's SpecAugment masks and dropout: the step
#: number plus a salt, as the reference folds the step into PRNGKey(0) and
#: PRNGKey(1).
_AUG_SALT = 0
_DROPOUT_SALT = 1 << 40


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a parameter tree in a fixed order (dict order, list
    order): the optimizer's and the saved train state's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@dataclass(frozen=True)
class Optimizer:
    """The reference's ``make_optimizer`` chain, written out:

    1. learning rate: optax ``warmup_cosine_decay_schedule(0, lr, warmup,
       decay_steps, 0.05 lr)``, read at the update count (0 at the first
       update, so the first update moves nothing);
    2. ``clip_by_global_norm(1.0)``;
    3. ``zero_nans``: a NaN gradient element becomes 0 (after the clip, a
       non-finite global norm has made every element NaN or 0, so the whole
       update is zero while Adam's moments still decay);
    4. AdamW (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
       decoupled weight decay scaled by the learning rate), which is what
       ``torch.optim.AdamW`` computes with the learning rate set per step.
    """

    lr: float = 1e-3
    weight_decay: float = 1e-6
    warmup_steps: int = 1000
    decay_steps: int = 200_000
    max_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        if count < self.warmup_steps:
            return self.lr * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        t = min(count - self.warmup_steps, span)
        alpha = 0.05
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return self.lr * ((1.0 - alpha) * cosine + alpha)

    def init(self, params) -> "OptState":
        leaves = tree_leaves(params)
        opt = torch.optim.AdamW(leaves, lr=0.0, betas=(self.b1, self.b2),
                                eps=self.eps, weight_decay=self.weight_decay)
        return OptState(opt, leaves, 0)

    def clip_and_zero_nans(self, grads: List[torch.Tensor]) -> None:
        """Steps 2 and 3, in place, in f32."""
        norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum()
                              for g in grads))
        for g in grads:
            clipped = torch.where(norm < self.max_norm, g,
                                  g / norm * self.max_norm)
            g.copy_(torch.where(torch.isnan(clipped),
                                torch.zeros_like(clipped), clipped))

    def update(self, state: "OptState", grads: List[Optional[torch.Tensor]]
               ) -> None:
        """Apply one update in place; ``grads`` align with the state's
        leaves (None: no gradient reached the leaf, which counts as 0)."""
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(state.leaves, grads)]
        self.clip_and_zero_nans(grads)
        for p, g in zip(state.leaves, grads):
            p.grad = g
        for group in state.opt.param_groups:
            group["lr"] = self.schedule(state.count)
        state.opt.step()
        for p in state.leaves:
            p.grad = None
        state.count += 1


@dataclass
class OptState:
    opt: torch.optim.AdamW
    leaves: List[torch.Tensor]
    count: int


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-6,
                   warmup_steps: int = 1000,
                   decay_steps: int = 200_000) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay,
                     warmup_steps=warmup_steps, decay_steps=decay_steps)


@dataclass
class TrainState:
    params: Any
    opt_state: OptState
    step: int


def aam_softmax_loss(embed: torch.Tensor, labels: torch.Tensor,
                     weight: torch.Tensor, margin: float = 0.2,
                     scale: float = 30.0) -> torch.Tensor:
    """Additive-angular-margin softmax (ArcFace) over speaker classes.

    embed [B, D] L2-normalised; weight [D, C]; labels [B] int. The cosine
    is clamped away from +-1 before the square root, whose gradient is
    infinite there."""
    wn = weight / torch.clamp(weight.norm(dim=0, keepdim=True), min=1e-8)
    cos = embed @ wn
    labels = labels.to(torch.long)
    tgt = torch.gather(cos, 1, labels[:, None])[:, 0]
    tgt = torch.clamp(tgt, -1.0 + 1e-4, 1.0 - 1e-4)
    sin = torch.sqrt(1.0 - tgt ** 2)
    tgt_m = tgt * math.cos(margin) - sin * math.sin(margin)
    onehot = torch.nn.functional.one_hot(labels, cos.shape[-1]).to(cos.dtype)
    logits = scale * (cos + onehot * (tgt_m - tgt)[:, None])
    logp = torch.log_softmax(logits, dim=-1)
    return -(logp * onehot).sum(dim=-1).mean()


def _pick(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, idx.to(torch.long)[..., None])[..., 0]


def loss_fn(params, batch: Dict[str, Any], cfg: PipelineConfig,
            trans_params=None, dropout_seed: Optional[int] = None):
    """Joint multi-task loss -> (total, metrics), as the reference's.

    Always: per-token CTC + 0.1 (LID CE + emotion CE). Optional, keyed by
    the batch: ``lid_frame_label`` (frame LID instead of pooled),
    ``char_frame_label`` (blank-excluded dense byte CE), ``speaker_label``
    (AAM-softmax on the pooled speaker embedding), ``trans_*`` with
    ``trans_params`` (teacher-forced translation CE), and the ramp scalars
    ``w_ctc``, ``w_fce``, ``w_spk``, ``w_trans``.
    """
    out = asr_forward(params, batch["mel"], batch["mask"], cfg,
                      dropout_seed=dropout_seed)
    lmask = batch["label_mask"]
    l_ctc_seq = ctc_loss(out["ctc_logits"], out["mask"], batch["labels"],
                         lmask, blank_id=cfg.vocab.blank_id)
    # Per-label-token nats (the reference's normalisation): the
    # per-sequence sum would drown every other objective.
    n_seq = torch.clamp(lmask.any(dim=-1).sum(), min=1)
    n_tok = torch.clamp(lmask.sum(), min=1)
    l_ctc = l_ctc_seq * n_seq / n_tok
    w_ctc = batch.get("w_ctc", 1.0)

    sub_mask = out["mask"].to(torch.float32)[:, :, None]
    denom = torch.clamp(sub_mask.sum(dim=1), min=1.0)

    def pooled_ce(logits, label):
        pooled = (logits * sub_mask).sum(dim=1) / denom
        return -_pick(torch.log_softmax(pooled, dim=-1), label).mean()

    def frame_ce(logp, lbl, offset=0):
        valid = ((lbl >= 0) & out["mask"]).to(torch.float32)
        pick = _pick(logp, torch.clamp(lbl - offset, min=0))
        return -(pick * valid).sum() / torch.clamp(valid.sum(), min=1.0)

    if "lid_frame_label" in batch:
        l_lid = frame_ce(torch.log_softmax(out["lid_logits"], dim=-1),
                         batch["lid_frame_label"])
    else:
        l_lid = pooled_ce(out["lid_logits"], batch["lid_label"])
    l_emo = pooled_ce(out["emotion_logits"], batch["emotion_label"])
    total = w_ctc * l_ctc + 0.1 * (l_lid + l_emo)
    metrics = {"ctc": l_ctc, "lid": l_lid, "emotion": l_emo}

    if "char_frame_label" in batch:
        # Dense per-frame byte CE on p(byte | not blank): CTC keeps the
        # blank mass while this shapes the relative byte geometry.
        if cfg.vocab.blank_id != 0:
            raise ValueError("the frame byte CE assumes blank id 0")
        n_real = 1 + cfg.vocab.n_bytes
        logp_f = torch.log_softmax(out["ctc_logits"][..., 1:n_real], dim=-1)
        l_fce = frame_ce(logp_f, batch["char_frame_label"], offset=1)
        total = total + batch.get("w_fce", 1.0) * l_fce
        metrics["frame_ce"] = l_fce

    if "speaker_label" in batch:
        emb = pooled_speaker_embed(params, out["speaker_frames"],
                                   out["mask"].to(torch.float32))
        l_spk = aam_softmax_loss(emb, batch["speaker_label"],
                                 params["spk_aam"])
        total = total + 0.3 * batch.get("w_spk", 1.0) * l_spk
        metrics["speaker"] = l_spk

    if trans_params is not None and "trans_in" in batch:
        from ..models.translation import decoder_forward

        tlogits = decoder_forward(trans_params, batch["trans_in"],
                                  out["encoder_states"], out["mask"], cfg)
        pick = _pick(torch.log_softmax(tlogits, dim=-1), batch["trans_tgt"])
        tm = batch["trans_mask"].to(torch.float32)
        l_tr = -(pick * tm).sum() / torch.clamp(tm.sum(), min=1.0)
        total = total + 0.5 * batch.get("w_trans", 1.0) * l_tr
        metrics["translation"] = l_tr

    metrics["loss"] = total
    return total, metrics


def mel_from_samples(batch, frontend):
    """Decode the i16 sample wire and run the log-mel frontend (kernel K1
    on the card) on the batch's device; ``mel`` replaces ``samples``."""
    samples = batch["samples"]
    if samples.dtype != torch.int16:
        raise NotImplementedError(
            f"sample wire {samples.dtype} is not ported (i16 only; the "
            f"mu-law wire is A11 in ROADMAP.md)")
    x = samples.to(torch.float32) * (1.0 / 32768.0)
    T = batch["mask"].shape[1]
    with torch.no_grad():
        frames, _ = frontend.frames_from_signal(x)
        mel = frontend.log_mel(frames)[:, :T]
    out = dict(batch)
    out.pop("samples")
    out["mel"] = mel
    return out


def make_train_step(cfg: PipelineConfig, device="cpu",
                    tx: Optional[Optimizer] = None,
                    from_samples: bool = False,
                    augment: Optional["SpecAugmentConfig"] = None,
                    with_translator: bool = False,
                    dropout: bool = False):
    """Returns ``(init_state, train_step, loss_and_grads)`` on one device.

    ``init_state(seed)`` -> :class:`TrainState` with fresh parameters
    (``asr_init`` from seed, the translator from seed + 1) on ``device``.
    ``train_step(params, opt_state, batch, step)`` -> ``(params, opt_state,
    step + 1, metrics)``: the batch is a dict of tensors on ``device``
    (``samples`` int16 instead of ``mel`` with ``from_samples``), the
    parameters are updated in place. ``loss_and_grads(params, batch,
    step)`` -> (metrics, grads aligned with ``tree_leaves(params)``), the
    step's gradient without the update. The batch's own keys select the
    loss terms (the reference's ``batch_keys`` only set its shardings).
    """
    tx = tx or make_optimizer()
    device = torch.device(device)
    frontend = None
    if from_samples:
        from ..ops.mel import MelFrontend

        frontend = MelFrontend(cfg.frontend, device)

    def init_state(seed: int = 0) -> TrainState:
        params = asr_init(torch.Generator().manual_seed(seed), cfg)
        if with_translator:
            from ..models.translation import translator_init

            params = {"asr": params, "translator": translator_init(
                torch.Generator().manual_seed(seed + 1), cfg)}
        params = tree_map(
            lambda t: t.to(device).requires_grad_(True), params)
        return TrainState(params, tx.init(params), 0)

    def loss_and_grads(params, batch, step: int):
        if from_samples:
            batch = mel_from_samples(batch, frontend)
        if augment is not None:
            from .augment import spec_augment

            gen = torch.Generator(device=device).manual_seed(
                _AUG_SALT + int(step))
            aug = spec_augment(gen, batch["mel"], batch["mask"], augment)
            w = batch.get("w_aug", 1.0)
            batch = dict(batch, mel=batch["mel"] + w * (aug - batch["mel"]))
        seed = _DROPOUT_SALT + int(step) if dropout else None
        if with_translator:
            total, metrics = loss_fn(params["asr"], batch, cfg,
                                     trans_params=params["translator"],
                                     dropout_seed=seed)
        else:
            total, metrics = loss_fn(params, batch, cfg, dropout_seed=seed)
        grads = torch.autograd.grad(total, tree_leaves(params),
                                    allow_unused=True)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(params, opt_state: OptState, batch, step: int):
        metrics, grads = loss_and_grads(params, batch, step)
        tx.update(opt_state, grads)
        return params, opt_state, step + 1, metrics

    return init_state, train_step, loss_and_grads
