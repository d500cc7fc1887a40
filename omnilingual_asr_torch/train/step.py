"""Multi-task training step.

The PyTorch port of ``omnilingual_asr_tpu/train/step.py``: CTC over byte
labels, cross-entropy for the LID and emotion heads, the optional
frame-level LID, dense byte-CE, AAM-softmax speaker and translation terms
(each keyed by the batch's contents), and the reference's optimizer
(warmup-cosine learning rate, clip by global norm 1.0, ``zero_nans``,
AdamW) with the other trainers' variants of it. It also holds what the
x-vector, translator and summarizer trainers share: one update
(:func:`train_update`), the decoders' masked cross-entropy and a run's
log (:class:`RunLog`). On one device here; over a (data, model) mesh
``make_train_step`` builds ``train/mesh_step.py``'s step (the batch over
``data``, the parameters over ``model``, one update equal to one
device's).

Parameters are trees of leaf tensors (``requires_grad``), updated in place
by the optimizer; the step function returns them as the reference's does.
"""

from __future__ import annotations

import contextlib
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import exact_f32, resolve_device
from ..models.conformer import asr_forward, asr_init, pooled_speaker_embed
from ..ops.ctc import ctc_loss, infeasible_rows

#: Generator seeds of a step's SpecAugment masks and dropout: the step
#: number plus a salt, as the reference folds the step into PRNGKey(0) and
#: PRNGKey(1).
_AUG_SALT = 0
_DROPOUT_SALT = 1 << 40
#: Batch key of the host-side indices of the rows whose CTC labels cannot
#: be aligned in their frames (:func:`ctc_rows`); not a tensor.
CTC_INFEASIBLE = "ctc_infeasible"


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
    """The reference trainers' optax chains, written out:

    1. learning rate: optax ``warmup_cosine_decay_schedule(0, lr, warmup,
       decay_steps, 0.05 lr)``, read at the update count (0 at the first
       update, so the first update moves nothing);
    2. ``clip_by_global_norm(1.0)``;
    3. with ``zero_nans`` (optax's ``zero_nans()``): a NaN gradient element
       becomes 0 (after the clip, a non-finite global norm has made every
       element NaN or 0, so the whole update is zero while Adam's moments
       still decay). Without it a NaN reaches Adam's moments and the
       parameters, as in a chain without that step;
    4. AdamW (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
       decoupled weight decay scaled by the learning rate), which is what
       ``torch.optim.AdamW`` computes with the learning rate set per step.

    ``make_optimizer`` (the synthetic-corpus and x-vector trainers) has
    weight decay 1e-6 and ``zero_nans``; the translator trainers build the
    same chain with their own warmup and decay; the summarizer trainer's
    has no ``zero_nans`` and optax's default weight decay, 1e-4.
    """

    lr: float = 1e-3
    weight_decay: float = 1e-6
    warmup_steps: int = 1000
    decay_steps: int = 200_000
    max_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    zero_nans: bool = True

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

    def clip_and_zero_nans(self, grads: List[torch.Tensor],
                           counted: Optional[List[torch.Tensor]] = None
                           ) -> List[torch.Tensor]:
        """Steps 2 and 3 in f32 -> the clipped gradients. The global norm
        runs over ``counted`` (default: ``grads``): over a mesh, one copy
        of each block of each leaf (``parallel.tensor.MeshParams.
        counted``), so that a leaf held by several shards counts once."""
        counted = grads if counted is None else counted
        dev = counted[0].device
        norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum().to(dev)
                              for g in counted))
        out = []
        for g in grads:
            n = norm.to(g.device)
            clipped = torch.where(n < self.max_norm, g, g / n * self.max_norm)
            if self.zero_nans:
                clipped = torch.where(torch.isnan(clipped),
                                      torch.zeros_like(clipped), clipped)
            out.append(clipped)
        return out

    def update(self, state: "OptState", grads: List[Optional[torch.Tensor]],
               counted: Optional[List[torch.Tensor]] = None) -> None:
        """Apply one update in place; ``grads`` align with the state's
        leaves (None: no gradient reached the leaf, which counts as 0).
        ``counted``: what the global norm counts (:meth:`clip_and_zero_nans`;
        over a mesh the step passes it)."""
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(state.leaves, grads)]
        grads = self.clip_and_zero_nans(grads, counted)
        for p, g in zip(state.leaves, grads):
            p.grad = g
        for group in state.opt.param_groups:
            group["lr"] = self.schedule(state.count)
        state.opt.step()
        for p in state.leaves:
            p.grad = None
        state.count += 1


def trainable(tree, device):
    """A copy of a parameter tree on ``device``: f32 leaves that require a
    gradient, apart from the tree they came from."""
    return tree_map(lambda t: t.detach().to(device, torch.float32).clone()
                    .requires_grad_(True), tree)


def value_and_grads(loss, params, *args):
    """``loss(params, *args)`` and its gradient with respect to every leaf
    of ``params`` (None for a leaf the loss does not reach, which
    :meth:`Optimizer.update` counts as 0): the reference trainers'
    ``jax.value_and_grad``."""
    value = loss(params, *args)
    grads = torch.autograd.grad(value, tree_leaves(params), allow_unused=True)
    return value.detach(), list(grads)


def counted_grads(params, grads):
    """What a step's global norm counts (``Optimizer.update``'s
    ``counted``): None on one device, over a mesh one copy of each block
    (``parallel.tensor.MeshParams.counted``)."""
    from ..parallel.tensor import MeshParams

    return params.counted(grads) if isinstance(params, MeshParams) else None


def whole_params(params):
    """The whole parameter tree: ``params`` on one device, the gathered
    tree over a mesh (``MeshParams.full``, what a checkpoint saves)."""
    from ..parallel.tensor import MeshParams

    return params.full() if isinstance(params, MeshParams) else params


def train_update(tx: "Optimizer", opt_state: "OptState", loss, params,
                 *args) -> float:
    """One update of ``params`` in place (the reference trainers' jitted
    step): ``loss(params, *args)`` and its gradient, then ``tx``. Returns
    the loss, read back (so that the step has finished)."""
    value, grads = value_and_grads(loss, params, *args)
    tx.update(opt_state, grads)
    return float(value)


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
class RunLog:
    """What one run of the x-vector, translator or summarizer trainer did:
    its loss at every step, its eval lines, and seconds by part (``synth``: the host
    making data; ``encode``: the frozen encoder's bank; ``steps``: the train
    steps, each waited for; ``eval``). :meth:`emit` prints a JSON line and
    appends it to the metrics log, as the reference trainers do."""

    metrics_log: Optional[Path] = None
    losses: List[float] = field(default_factory=list)
    evals: List[dict] = field(default_factory=list)
    seconds: Dict[str, float] = field(default_factory=dict)

    def emit(self, line: dict) -> None:
        print(json.dumps(line), flush=True)
        if self.metrics_log is not None:
            self.metrics_log.parent.mkdir(parents=True, exist_ok=True)
            with self.metrics_log.open("a") as f:
                f.write(json.dumps(line) + "\n")

    @contextlib.contextmanager
    def timed(self, part: str):
        """Adds the block's wall seconds to ``seconds[part]``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[part] = (self.seconds.get(part, 0.0)
                                  + time.perf_counter() - t0)


def make_translator_optimizer(lr: float, steps: int) -> Optimizer:
    """The translator trainers' chain (text and audio mode): clip,
    ``zero_nans``, AdamW with weight decay 1e-6, warmup ``min(200, max(1,
    steps // 5))``, cosine decay over ``steps``."""
    return Optimizer(lr=lr, weight_decay=1e-6,
                     warmup_steps=min(200, max(1, steps // 5)),
                     decay_steps=steps)


def make_summarizer_optimizer(lr: float, steps: int) -> Optimizer:
    """The summarizer trainer's chain: clip, then optax's ``adamw`` at its
    default weight decay 1e-4, warmup 200, decay over ``max(steps, 201)``;
    no ``zero_nans``."""
    return Optimizer(lr=lr, weight_decay=1e-4, warmup_steps=200,
                     decay_steps=max(steps, 201), zero_nans=False)


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


def masked_ce(logits: torch.Tensor, tgt: torch.Tensor,
              msk: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``tgt`` under ``logits`` over the positions
    ``msk`` marks: the decoder trainers' loss."""
    pick = _pick(torch.log_softmax(logits, dim=-1), tgt)
    m = msk.to(torch.float32)
    return -(pick * m).sum() / torch.clamp(m.sum(), min=1.0)


def forward_outputs(params, batch: Dict[str, Any], cfg: PipelineConfig,
                    trans_params=None, dropout_seed: Optional[int] = None):
    """What :func:`loss_fn` reads of the model on one device:
    ``asr_forward``'s dict, with the translator's teacher-forced logits as
    ``trans_logits`` when ``trans_params`` and ``trans_in`` are given.
    A mesh computes the same dict over its shards (``train/mesh_step.py``)
    and hands it to :func:`loss_fn` as ``out``."""
    out = asr_forward(params, batch["mel"], batch["mask"], cfg,
                      dropout_seed=dropout_seed)
    if trans_params is not None and "trans_in" in batch:
        from ..models.translation import decoder_forward

        out["trans_logits"] = decoder_forward(
            trans_params, batch["trans_in"], out["encoder_states"],
            out["mask"], cfg)
    return out


def loss_fn(params, batch: Dict[str, Any], cfg: PipelineConfig,
            trans_params=None, dropout_seed: Optional[int] = None,
            out: Optional[Dict[str, torch.Tensor]] = None):
    """Joint multi-task loss -> (total, metrics), as the reference's.

    Always: per-token CTC + 0.1 (LID CE + emotion CE); with experts, 0.01
    times the blocks' load-balance loss (``metrics["moe_aux"]``).
    Optional, keyed by the batch: ``lid_frame_label`` (frame LID instead
    of pooled), ``char_frame_label`` (blank-excluded dense byte CE),
    ``speaker_label`` (AAM-softmax on the pooled speaker embedding), ``trans_*`` with
    ``trans_params`` (teacher-forced translation CE), and the ramp scalars
    ``w_ctc``, ``w_fce``, ``w_spk``, ``w_trans``. ``CTC_INFEASIBLE``, if
    present, gives the CTC loss its unalignable rows from the host.

    ``out``: the model's outputs over the whole batch
    (:func:`forward_outputs`' dict), computed elsewhere; every term is
    then normalised over the whole batch exactly as on one device, and
    ``params`` serves only the replicated speaker leaves.
    """
    if out is None:
        out = forward_outputs(params, batch, cfg, trans_params, dropout_seed)
    lmask = batch["label_mask"]
    l_ctc_seq = ctc_loss(out["ctc_logits"], out["mask"], batch["labels"],
                         lmask, blank_id=cfg.vocab.blank_id,
                         infeasible=batch.get(CTC_INFEASIBLE))
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

    if cfg.encoder.n_experts > 0:
        # The Switch load-balance loss, summed over the blocks, at the
        # standard coefficient.
        total = total + 0.01 * out["moe_aux"]
        metrics["moe_aux"] = out["moe_aux"]

    if "speaker_label" in batch:
        emb = pooled_speaker_embed(params, out["speaker_frames"],
                                   out["mask"].to(torch.float32))
        l_spk = aam_softmax_loss(emb, batch["speaker_label"],
                                 params["spk_aam"])
        total = total + 0.3 * batch.get("w_spk", 1.0) * l_spk
        metrics["speaker"] = l_spk

    if "trans_logits" in out:
        l_tr = masked_ce(out["trans_logits"], batch["trans_tgt"],
                         batch["trans_mask"])
        total = total + 0.5 * batch.get("w_trans", 1.0) * l_tr
        metrics["translation"] = l_tr

    metrics["loss"] = total
    return total, metrics


def ctc_rows(batch, cfg: PipelineConfig) -> np.ndarray:
    """The rows of a host (numpy) batch whose labels cannot be aligned in
    their subsampled frames (``ops.ctc.infeasible_rows``), from the arrays
    the host built: the value of ``batch[CTC_INFEASIBLE]`` once the batch
    is on a device, so that ``loss_fn`` reads nothing back."""
    mask = np.asarray(batch["mask"])
    B, T = mask.shape
    sub = cfg.encoder.subsample_factor
    n_frames = mask.reshape(B, T // sub, sub)[:, :, 0].sum(axis=1)
    return infeasible_rows(n_frames, batch["labels"], batch["label_mask"])


def training_device(device) -> torch.device:
    """A trainer's device: CUDA unless the caller asks for the CPU
    (``device.resolve_device``: None is the card, and raises without
    one), with TF32 off on the card, so that f32 products (an f32
    encoder's, the quantizer's code similarities, the mel) stay f32."""
    dev = resolve_device(device)
    exact_f32([dev])
    return dev


def decode_wire(samples: torch.Tensor) -> torch.Tensor:
    """A sample wire -> f32 samples in [-1, 1], on the wire's device: int16
    (x / 32768), uint8 mu-law codes (``audio/codec.py``), and any other
    dtype (the manifest trainer's and the pool's f32) as it is."""
    if samples.dtype == torch.int16:
        return samples.to(torch.float32) * (1.0 / 32768.0)
    if samples.dtype == torch.uint8:
        from ..audio.codec import mulaw_decode

        return mulaw_decode(samples)
    return samples


def mel_from_samples(batch, frontend):
    """Decode the batch's sample wire (:func:`decode_wire`) and run the
    log-mel frontend (kernel K1 on the card) on the batch's device; ``mel``
    replaces ``samples``, cut to the mask's frames."""
    x = decode_wire(batch["samples"])
    T = batch["mask"].shape[1]
    with torch.no_grad():
        frames, _ = frontend.frames_from_signal(x)
        mel = frontend.log_mel(frames)[:, :T]
    out = dict(batch)
    out.pop("samples")
    out["mel"] = mel
    return out


def make_train_step(cfg: PipelineConfig, device=None,
                    tx: Optional[Optimizer] = None,
                    from_samples: bool = False,
                    augment: Optional["SpecAugmentConfig"] = None,
                    with_translator: bool = False,
                    dropout: bool = False):
    """Returns ``(init_state, train_step, loss_and_grads)`` on one device
    (``device``: the card when None, which raises without one; ``"cpu"``
    for the CPU), or over a (data, model) mesh when ``device`` is a
    ``parallel.mesh.Mesh`` (``train/mesh_step.py``: the parameters a
    ``parallel.tensor.MeshParams``, the batch the global batch on shard
    (0, 0)'s device, one update equal to one device's).

    ``init_state(seed)`` -> :class:`TrainState` with fresh parameters
    (``asr_init`` from seed, the translator from seed + 1) on ``device``.
    ``train_step(params, opt_state, batch, step)`` -> ``(params, opt_state,
    step + 1, metrics)``: the batch is a dict of tensors on ``device``
    (with ``from_samples``, ``samples`` instead of ``mel``: int16, uint8
    mu-law or f32, :func:`decode_wire`), the
    parameters are updated in place. ``loss_and_grads(params, batch,
    step)`` -> (metrics, grads aligned with ``tree_leaves(params)``), the
    step's gradient without the update. The batch's own keys select the
    loss terms (the reference's ``batch_keys`` only set its shardings).
    """
    tx = tx or make_optimizer()
    from ..parallel.mesh import Mesh

    if isinstance(device, Mesh):
        from .mesh_step import make_mesh_train_step

        return make_mesh_train_step(cfg, device, tx, from_samples, augment,
                                    with_translator, dropout)
    device = training_device(device)
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
