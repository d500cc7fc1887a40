"""Training over a (data, model) mesh: the train, pool and pretrain steps.

The PyTorch port of what the reference's ``make_train_step(cfg, mesh)``,
``make_pool_train_step`` and ``make_pretrain_step`` get from GSPMD: the
batch split over the ``data`` rows (``P("data", ...)``), the parameters
and the optimizer state split over ``model`` as
``models/conformer.py::asr_param_specs`` (and the translator's and the
pretraining head's specs) place them, one update equal to one device's.
Within a process one controller drives every shard of its rows, and
devices may repeat (shards of one card run in turn). A mesh may span
processes (``parallel.mesh.init_distributed``, one process a host as in
the reference's multi-host training): each process drives its own data
rows and their model shards, and only the ``data`` axis crosses
processes.

A step:

1. takes the global batch (over processes: rank 0's, broadcast,
   :func:`broadcast_batch`), scatters it over the data rows (each process
   its block); from a sample wire each row runs the log-mel (kernel K1)
   on its own rows;
2. draws every random input over the global batch's shape on shard
   (0, 0)'s device, as one device draws it (SpecAugment on the gathered
   mel, the dropout masks, the pool's gain and noise, pretraining's span
   starts and noise), and hands each row its rows; every process draws
   the same with the same seed;
3. runs each row's model shards (``models/conformer.py::
   mesh_asr_forward``, the translator's ``tp_decoder_forward``), gathers
   the rows' outputs onto shard (0, 0)'s device (and over processes, so
   that each holds the whole batch's) and runs the unchanged one-device
   loss there, so that every term is normalised over the whole batch
   (:func:`global_loss`);
4. takes autograd's gradients through the gathers and the collectives,
   sums each block's copies (``parallel.tensor.MeshParams.reduce``, and
   over processes) and clips by a global norm that counts each logical
   element once (``MeshParams.counted``); AdamW then gives every copy the
   same update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config import MeshConfig, PipelineConfig
from ..device import exact_f32, resolve_device
from ..models.conformer import (asr_init, asr_param_specs, check_tp_dims,
                                mesh_asr_forward, mesh_moe_aux)
from ..parallel import tensor as tp
from ..parallel.mesh import (Mesh, block_of, build_mesh, gather,
                             local_devices, process_all_gather,
                             process_broadcast, process_broadcast_object,
                             process_count, process_index, replicate,
                             scatter, to_device)
from ..parallel.tensor import MeshParams

#: The outputs of ``asr_forward`` that the loss reads, gathered over rows.
_OUT_KEYS = ("ctc_logits", "lid_logits", "emotion_logits", "speaker_frames",
             "mask")


def training_mesh(mcfg: MeshConfig, device) -> Optional[Mesh]:
    """The trainers' mesh for ``cfg.mesh``: None for one shard (the
    one-device step), else a (data, model) mesh. ``device`` None spans
    every visible CUDA device, as the reference's ``build_mesh`` spans
    ``jax.devices()`` (``data=-1``: all the rest); an explicit device
    (``"cpu"``, ``"cuda:0"``) holds every shard, one after another. After
    ``parallel.mesh.init_distributed`` the mesh spans the processes:
    ``data`` counts every process's rows, and this process holds its share
    of them (``device`` None: over its visible cards)."""
    dev = resolve_device(device)
    visible = (local_devices() if device is None else [dev])
    model = max(1, mcfg.model)
    procs = process_count()
    data = (mcfg.data if mcfg.data > 0
            else procs * max(1, len(visible) // model))
    if data * model == 1 and procs == 1:
        return None
    if data % procs:
        raise ValueError(f"{data} data rows do not split over {procs} "
                         f"processes")
    n = data // procs * model
    devices = [visible[i % len(visible)] for i in range(n)]
    return build_mesh(MeshConfig(data=data, model=model), devices)


def train_specs(cfg: PipelineConfig, with_translator: bool = False):
    """The placement of ``make_train_step``'s tree on a mesh."""
    specs = asr_param_specs(cfg)
    if with_translator:
        from ..models.translation import translator_specs

        specs = {"asr": specs, "translator": translator_specs()}
    return specs


def _check(cfg: PipelineConfig, mesh: Mesh, batch_rows: int) -> None:
    data, model = mesh.devices.shape
    check_tp_dims(cfg, model)
    if batch_rows % data:
        raise ValueError(f"a batch of {batch_rows} rows does not split over "
                         f"{data} data rows")


def _row_devices(mesh: Mesh) -> List[torch.device]:
    return [mesh.devices[r, 0] for r in range(mesh.devices.shape[0])]


def broadcast_batch(batch: Optional[Dict], device) -> Dict:
    """Rank 0's batch in every process, its tensors on ``device`` (the
    processes do not each make the same batch: only rank 0 draws one, and
    another process's ``batch`` is ignored). The keys, dtypes, shapes and
    the batch's other values (the ramp scalars, the host's unalignable
    rows) go as one object, then each tensor."""
    rank0 = process_index() == 0
    layout = None
    if rank0:
        layout = {k: (("tensor", v.dtype, tuple(v.shape))
                      if isinstance(v, torch.Tensor) else ("value", v))
                  for k, v in batch.items()}
    layout = process_broadcast_object(layout)
    out = {}
    for k, (kind, *rest) in layout.items():
        if kind == "value":
            out[k] = rest[0]
            continue
        t = (to_device(batch[k], device) if rank0 else
             torch.empty(rest[1], dtype=rest[0], device=device))
        out[k] = process_broadcast(t)
    return out


def mesh_mel(batch: Dict, mesh: Mesh, frontends: Dict,
             part=(0, 1)) -> Dict:
    """The batch's sample wire -> ``mel`` on shard (0, 0)'s device: each
    data row decodes its rows and runs the log-mel (K1, once a row) on its
    device; the rows' mels are gathered (``part``: this process's rows and
    its block of the batch, the mel gathered over the processes too)."""
    from .step import mel_from_samples

    firsts = _row_devices(mesh)
    samples = scatter(block_of(batch["samples"], *part), firsts)
    masks = scatter(block_of(batch["mask"], *part), firsts)
    mels = [mel_from_samples({"samples": s, "mask": m}, frontends[d])["mel"]
            for s, m, d in zip(samples, masks, firsts)]
    out = dict(batch)
    out.pop("samples")
    out["mel"] = process_all_gather(gather(mels, dim=0, device=firsts[0]))
    return out


def mesh_outputs(params: MeshParams, batch: Dict, cfg: PipelineConfig,
                 with_translator: bool,
                 dropout_seed: Optional[int] = None,
                 part=(0, 1)) -> List[Dict]:
    """Each data row's outputs (``asr_forward``'s keys, and
    ``trans_logits`` with the translator), on its row's first device
    (``part``: the rows are this process's, on its block of the batch)."""
    data = len(params.grid)
    asr = [[g["asr"] if with_translator else g for g in row]
           for row in params.grid]
    rows = mesh_asr_forward(asr, batch["mel"], batch["mask"], cfg,
                            dropout_seed=dropout_seed, part=part)
    if with_translator and "trans_in" in batch:
        from ..models.translation import tp_decoder_forward

        tins = scatter(block_of(batch["trans_in"], *part),
                       _row_devices(params.mesh))
        for r in range(data):
            rows[r]["trans_logits"] = tp_decoder_forward(
                [g["translator"] for g in params.grid[r]], tins[r],
                rows[r]["encoder_states"], rows[r]["mask"], cfg)
    return rows


def loss_tree(p0, part=(0, 1)):
    """The tree whose leaves the loss reads directly (the speaker
    projection and the AAM classes, ``step.loss_fn``): shard (0, 0)'s. Over
    processes every process runs the same loss, so only rank 0's copies
    take that term's gradient, and the others' are detached: the sum over
    processes then counts it once."""
    if part[0] == 0:
        return p0
    from .step import tree_map

    return tree_map(lambda t: t.detach(), p0)


def global_loss(p0, batch: Dict, cfg: PipelineConfig, rows: List[Dict],
                part=(0, 1)):
    """The rows' outputs gathered onto shard (0, 0)'s device, then the
    one-device ``loss_fn`` over the whole batch: CTC per label token over
    the batch's tokens, the pooled CEs as means over the batch, the frame
    CEs over the batch's valid frames, the translation CE over its mask,
    and with experts the load-balance term over every frame of the batch
    (``mesh_moe_aux``). ``p0``: shard (0, 0)'s ASR tree (the speaker
    leaves it reads are replicated). ``part``: the rows are this
    process's, and the outputs are gathered over the processes as well
    (:func:`loss_tree` keeps the speaker leaves' term on rank 0). ->
    (total, metrics)."""
    from .step import loss_fn

    dev = p0["spk_aam"].device
    out = {k: process_all_gather(gather([o[k] for o in rows], dim=0,
                                        device=dev))
           for k in _OUT_KEYS + (("trans_logits",)
                                 if "trans_logits" in rows[0] else ())}
    out["moe_aux"] = mesh_moe_aux(rows, dev, part[1])
    return loss_fn(loss_tree(p0, part), batch, cfg, out=out)


def make_mesh_train_step(cfg: PipelineConfig, mesh: Mesh, tx,
                         from_samples: bool = False, augment=None,
                         with_translator: bool = False,
                         dropout: bool = False):
    """``make_train_step`` over ``mesh``: the same ``(init_state,
    train_step, loss_and_grads)``, with :class:`MeshParams` in place of the
    parameter tree. ``loss_and_grads``' gradients align with
    ``params.leaves`` and are already summed over each block's copies
    (``params.merge`` gives the whole leaves'). The batch is the global
    batch on shard (0, 0)'s device; over processes, rank 0's (the others
    may pass None), and each process's ``MeshParams`` holds its rows."""
    from .step import _AUG_SALT, _DROPOUT_SALT, TrainState

    local, part = mesh.local(), mesh.process_block()
    check_tp_dims(cfg, mesh.devices.shape[1])
    exact_f32(local.distinct_devices())
    specs = train_specs(cfg, with_translator)
    dev0 = local.devices[0, 0]
    frontends = {}
    if from_samples:
        from ..ops.mel import MelFrontend

        frontends = {d: MelFrontend(cfg.frontend, d)
                     for d in _row_devices(local)}

    def place(params, copy_per_shard: bool = False) -> MeshParams:
        """A whole tree (tensors or arrays) placed on the mesh."""
        return MeshParams(params, specs, mesh, copy_per_shard)

    def init_state(seed: int = 0) -> TrainState:
        params = asr_init(torch.Generator().manual_seed(seed), cfg)
        if with_translator:
            from ..models.translation import translator_init

            params = {"asr": params, "translator": translator_init(
                torch.Generator().manual_seed(seed + 1), cfg)}
        placed = place(params)
        return TrainState(placed, tx.init(placed.leaves), 0)

    def loss_and_grads(params: MeshParams, batch, step: int):
        if part[1] > 1:
            batch = broadcast_batch(batch, dev0)
        _check(cfg, mesh, batch["mask"].shape[0])
        if from_samples:
            batch = mesh_mel(batch, local, frontends, part)
        if augment is not None:
            from .augment import spec_augment

            gen = torch.Generator(device=dev0).manual_seed(
                _AUG_SALT + int(step))
            aug = spec_augment(gen, batch["mel"], batch["mask"], augment)
            w = batch.get("w_aug", 1.0)
            batch = dict(batch, mel=batch["mel"] + w * (aug - batch["mel"]))
        seed = _DROPOUT_SALT + int(step) if dropout else None
        rows = mesh_outputs(params, batch, cfg, with_translator, seed, part)
        p0 = params.grid[0][0]
        total, metrics = global_loss(p0["asr"] if with_translator else p0,
                                     batch, cfg, rows, part)
        grads = torch.autograd.grad(total, params.leaves, allow_unused=True)
        return ({k: v.detach() for k, v in metrics.items()},
                params.reduce(grads))

    def train_step(params: MeshParams, opt_state, batch, step: int):
        metrics, grads = loss_and_grads(params, batch, step)
        tx.update(opt_state, grads, params.counted(grads))
        return params, opt_state, step + 1, metrics

    init_state.place = place
    return init_state, train_step, loss_and_grads


def pretrain_param_specs(cfg: PipelineConfig):
    """The reference's ``pretrain_param_specs``: the encoder as
    ``asr_param_specs``, the [d, codebook] head split over its codes."""
    from ..models.layers import dense_spec
    from ..parallel.mesh import AXIS_MODEL

    return {"encoder": asr_param_specs(cfg),
            "head": dense_spec(None, AXIS_MODEL)}


def make_mesh_pretrain_step(cfg: PipelineConfig, mesh: Mesh, pcfg, tx,
                            from_samples: bool = False):
    """``make_pretrain_step`` over ``mesh``: the same ``(init_state,
    pretrain_step, loss_and_grads)``, with :class:`MeshParams` in place of
    the parameter tree. The quantizer's targets and the step's draws come
    from the global batch on shard (0, 0)'s device; each row runs its
    encoder shards and its head columns, the rows' logits (each row's
    columns gathered over its model shards) are gathered onto shard (0,
    0)'s device (and over processes, whose batch is rank 0's) and the
    one-device masked CE runs there."""
    from .pretrain import (make_quantizer, pretrain_init, pretrain_loss,
                           step_draws)

    local, part = mesh.local(), mesh.process_block()
    check_tp_dims(cfg, mesh.devices.shape[1])
    exact_f32(local.distinct_devices())
    specs = pretrain_param_specs(cfg)
    dev0 = local.devices[0, 0]
    firsts = _row_devices(local)
    frontends = {}
    if from_samples:
        from ..ops.mel import MelFrontend

        frontends = {d: MelFrontend(cfg.frontend, d) for d in firsts}

    def place(params, copy_per_shard: bool = False) -> MeshParams:
        return MeshParams(params, specs, mesh, copy_per_shard)

    def init_state(seed: int = 0):
        params = place(pretrain_init(torch.Generator().manual_seed(seed),
                                     cfg, pcfg))
        quantizer = make_quantizer(torch.Generator().manual_seed(seed + 1),
                                   cfg, pcfg)
        quantizer = {k: v.to(dev0) for k, v in quantizer.items()}
        return params, quantizer, tx.init(params.leaves)

    def forward(params: MeshParams):
        def logits_of(corrupted, valid):
            rows = mesh_asr_forward([[g["encoder"] for g in row]
                                     for row in params.grid],
                                    corrupted, valid, cfg, part=part)
            out = []
            for r, o in enumerate(rows):
                shards = params.grid[r]
                devices = [g["head"]["w"].device for g in shards]
                xs = replicate(o["encoder_states"], devices)
                # bf16, as the reference's head (its dense_apply default)
                # at either encoder dtype.
                cols = tp.column_dense([g["head"] for g in shards], xs,
                                       torch.bfloat16)
                out.append(gather(cols, dim=-1, device=firsts[r]))
            return process_all_gather(gather(out, dim=0, device=dev0))
        return logits_of

    def loss_and_grads(params: MeshParams, quantizer, batch, step: int,
                       draws=None):
        if part[1] > 1:
            batch = broadcast_batch(batch, dev0)
        _check(cfg, mesh, batch["mask"].shape[0])
        if from_samples:
            batch = mesh_mel(batch, local, frontends, part)
        if draws is None:
            B, T = batch["mask"].shape
            draws = step_draws(step, B, T, cfg, pcfg, dev0)
        loss, metrics = pretrain_loss(params.grid[0][0], quantizer, batch,
                                      *draws, cfg, pcfg,
                                      forward=forward(params))
        grads = torch.autograd.grad(loss, params.leaves, allow_unused=True)
        return metrics, params.reduce(grads)

    def pretrain_step(params: MeshParams, quantizer, opt_state, batch,
                      step: int, draws=None):
        metrics, grads = loss_and_grads(params, quantizer, batch, step, draws)
        tx.update(opt_state, grads, params.counted(grads))
        return params, opt_state, step + 1, metrics

    init_state.place = place
    return init_state, pretrain_step, loss_and_grads
