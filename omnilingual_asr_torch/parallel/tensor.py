"""Tensor parallelism: column- and row-parallel layers over a mesh axis.

In the JAX package tensor parallelism is no module: GSPMD derives it from
the ``PartitionSpec`` trees (``models/layers.py``'s ``*_spec``,
``models/conformer.py::asr_param_specs``). The port has no GSPMD, so this
module is the explicit code those specs stand for, over
``parallel/mesh.py``'s collectives.

A tensor-parallel layer takes one parameter tree per shard of the model
axis (``shard_trees``) and one activation per shard. Activations that the
reference holds replicated are the same tensor object on every shard of
one device (``psum`` and ``all_gather`` share their results so), and
replicated work on them runs once per distinct object (:func:`per_copy`).

- column-parallel dense (q, k, v, FFN up, the subsampler, the LID head):
  each shard its block of output columns, bias included;
- row-parallel dense (the attention output, FFN down, the conv module's
  pw2): each shard its block of input rows gives a partial sum, the
  partials are summed over the shards (``psum``), and the replicated bias
  is added once, after the sum;
- attention: shard m takes heads [m H / n, (m + 1) H / n) (the
  contiguous column block), RoPE and attention on its heads only;
- the conv module: channels split, the GLU on each shard's value and gate
  columns, the depthwise taps on its channels, the second LayerNorm's
  statistics merged over the shards (Chan et al.'s update, exact in
  algebra), then pw2 row-parallel. ``ops/conv_module.py::
  fused_conv_module_split`` is the same split on kernel K3.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models import layers as L
from ..models.moe import expert_combine, route, routing_sums
from ..ops.attention import FlashAttention
from ..ops.conv_module import (layernorm_from_moments, merge_moments,
                               moments)
from .mesh import (AXIS_MODEL, Mesh, _sub, all_gather, as_split,
                   device_guard, merge_blocks, process_all_reduce_many, psum,
                   replicate, split_block, to_device)

F32 = torch.float32


def shard_trees(params, specs, devices: Sequence[torch.device]) -> List:
    """One parameter tree per shard of ``devices`` (one row of the model
    axis): tree m holds block m of every split leaf (contiguous, on
    ``devices[m]``) and every replicated leaf on its device, one copy a
    distinct device, shared by the shards there. ``params`` may hold
    torch tensors or numpy arrays (the JAX package's parameters carried
    across)."""
    n = len(devices)
    devices = [torch.device(d) for d in devices]
    copies = {}

    def visit(node, spec, m):
        if isinstance(node, dict):
            return {k: visit(v, _sub(spec, k), m) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [visit(v, _sub(spec, i), m) for i, v in enumerate(node)]
        t = node if isinstance(node, torch.Tensor) else torch.tensor(
            np.asarray(node))
        d = devices[m]
        if as_split(spec) is None:
            key = (id(node), d)
            if key not in copies:
                copies[key] = to_device(t, d)
            return copies[key]
        return to_device(split_block(t, spec, m, n), d).contiguous()

    return [visit(params, specs, m) for m in range(n)]


def _leaves_with_specs(tree, specs):
    """(leaf, spec) pairs of a tree in ``train.step.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves_with_specs(v, _sub(specs, k))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_specs(v, _sub(specs, i))]
    return [(tree, specs)]


def _rebuild(tree, values):
    """``tree``'s structure with its leaves taken from the iterator
    ``values`` in leaf order."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, values) for v in tree]
    return next(values)


class MeshParams:
    """A parameter tree placed on a (data, model) mesh for training.

    Leaf by leaf, as ``specs`` place it: a leaf split over the model axis
    has one block a model shard, a replicated leaf one block. Each block
    has one copy a distinct device that holds it (every data row's shard m
    holds block m), or, with ``copy_per_shard``, one copy a mesh position
    even where devices repeat (what distinct cards give, on one device).
    The copies are f32 tensors that require a gradient; ``leaves`` lists
    them once each, in leaf order (the optimizer's order), and
    ``grid[r][m]`` is the tree that data row r's model shard m computes
    with (``shard_trees``' layout). On one device a block's copy is one
    tensor shared by every row, so autograd sums the rows' gradients into
    it; on distinct devices each copy gets a partial gradient, which
    :meth:`reduce` sums over the copies (``psum`` over the group that
    holds the block) so that every copy takes the same update.

    On a mesh that spans processes (``parallel.mesh.init_distributed``)
    this process holds the copies of its own rows only (``mesh``,
    ``grid`` and ``leaves`` are its :meth:`Mesh.local`'s), and
    :meth:`reduce` sums each block over the processes as well. Each
    process holds a whole model row, so :meth:`counted`, :meth:`merge`,
    :meth:`full` and :meth:`assign` need no other process."""

    def __init__(self, params, specs, mesh: Mesh,
                 copy_per_shard: bool = False):
        if mesh.axis_names != ("data", AXIS_MODEL):
            raise ValueError(f"a (data, model) mesh, got {mesh.axis_names}")
        self.processes = mesh.process_block()[1]
        mesh = mesh.local()
        data, model = mesh.devices.shape
        self.mesh, self.specs, self._template = mesh, specs, params
        self.leaves: List[torch.Tensor] = []
        self._specs = []
        #: per leaf, per block: indices into ``leaves`` of its copies
        self.blocks: List[List[List[int]]] = []
        at = [[[] for _ in range(model)] for _ in range(data)]
        for t, spec in _leaves_with_specs(params, specs):
            sp = as_split(spec)
            if sp is not None and sp.axis != AXIS_MODEL:
                raise ValueError(f"training places leaves over the model "
                                 f"axis only, got {spec!r}")
            t = t if isinstance(t, torch.Tensor) else torch.tensor(
                np.asarray(t))
            t = t.detach()
            blocks = []
            for b in range(model if sp is not None else 1):
                value = split_block(t, sp, b, model) if sp is not None else t
                copies = {}
                for r in range(data):
                    for m in range(model):
                        if sp is not None and m != b:
                            continue
                        d = mesh.devices[r, m]
                        key = (r, m) if copy_per_shard else d
                        if key not in copies:
                            copies[key] = len(self.leaves)
                            self.leaves.append(
                                value.to(d, torch.float32).contiguous()
                                .clone().requires_grad_(True))
                        at[r][m].append(self.leaves[copies[key]])
                blocks.append(list(copies.values()))
            self.blocks.append(blocks)
            self._specs.append(spec)
        self.grid = [[_rebuild(params, iter(at[r][m])) for m in range(model)]
                     for r in range(data)]

    @property
    def device(self) -> torch.device:
        """Shard (0, 0)'s device: where the loss and the gathers run."""
        return self.mesh.devices[0, 0]

    def reduce(self, grads: Sequence[Optional[torch.Tensor]]
               ) -> List[torch.Tensor]:
        """Gradients aligned with ``leaves`` (None: zero) -> each copy's
        gradient summed over its block's copies (in every process), a
        tensor of its own on its copy's device."""
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(self.leaves, grads)]
        out = list(grads)
        for blocks in self.blocks:
            for idx in blocks:
                if len(idx) == 1:
                    continue
                sums = psum([grads[i] for i in idx])
                seen = set()
                for i, s in zip(idx, sums):
                    out[i] = s.clone() if id(s) in seen else s
                    seen.add(id(s))
        if self.processes > 1:
            idxs = [idx for blocks in self.blocks for idx in blocks]
            sums = process_all_reduce_many([out[idx[0]] for idx in idxs])
            for idx, s in zip(idxs, sums):
                seen = set()
                for i in idx:
                    g = to_device(s, self.leaves[i].device)
                    out[i] = g.clone() if id(g) in seen else g
                    seen.add(id(g))
        return out

    def counted(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients a global norm counts: one copy of each block, so
        that every logical element counts once (the split blocks of one
        model row, each replicated leaf once)."""
        return [grads[idx[0]] for blocks in self.blocks for idx in blocks]

    def merge(self, values: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-copy tensors aligned with ``leaves`` -> the whole leaves (in
        ``tree_leaves`` order of the full tree), each merged from its
        blocks' first copies on :attr:`device`."""
        return [to_device(merge_blocks([values[idx[0]] for idx in blocks],
                                       spec), self.device)
                for blocks, spec in zip(self.blocks, self._specs)]

    def split(self, whole: Sequence) -> List[torch.Tensor]:
        """The inverse of :meth:`merge`: whole leaves (tensors or arrays,
        in leaf order) -> one tensor a copy, aligned with ``leaves``."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.leaves)
        model = self.mesh.devices.shape[1]
        for t, blocks, spec in zip(whole, self.blocks, self._specs):
            t = t if isinstance(t, torch.Tensor) else torch.tensor(
                np.asarray(t))
            sp = as_split(spec)
            for b, idx in enumerate(blocks):
                value = split_block(t, sp, b, model) if sp is not None else t
                for i in idx:
                    out[i] = value.to(self.leaves[i].device,
                                      self.leaves[i].dtype).contiguous()
        return out

    def full(self):
        """The whole parameter tree on :attr:`device` (detached): the
        inverse of the placement, what a checkpoint saves."""
        merged = self.merge([p.detach() for p in self.leaves])
        return _rebuild(self._template, iter(merged))

    def assign(self, tree) -> None:
        """Copy a whole tree (tensors or arrays, the placed tree's
        structure) into every copy, in place, so that the optimizer keeps
        holding the same tensors."""
        whole = [t for t, _ in _leaves_with_specs(tree, self.specs)]
        if len(whole) != len(self.blocks):
            raise ValueError(f"a tree of {len(whole)} leaves for "
                             f"{len(self.blocks)} placed")
        with torch.no_grad():
            for p, v in zip(self.leaves, self.split(whole)):
                if tuple(p.shape) != tuple(v.shape):
                    raise ValueError(f"loaded block of shape "
                                     f"{tuple(v.shape)} for a copy of "
                                     f"{tuple(p.shape)}")
                p.copy_(v)


def per_copy(fn: Callable, *lists) -> List:
    """``fn`` over each shard's arguments, run once per distinct first
    argument: shards that share a replicated activation (the same tensor
    on one device) share the result. Use only where the other arguments
    are replicated too."""
    seen = {}
    out = []
    for args in zip(*lists):
        key = id(args[0])
        if key not in seen:
            seen[key] = fn(*args)
        out.append(seen[key])
    return out


def _no_bias(p):
    return {k: v for k, v in p.items() if k != "b"}


def column_dense(ps, hs, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """Each shard's block of output columns (its bias block added)."""
    return [L.dense_apply(p, h, dtype) for p, h in zip(ps, hs)]


def row_dense(ps, hs, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """Each shard's partial product over its input rows, summed over the
    shards; the replicated bias added once, after the sum."""
    sums = psum([L.dense_apply(_no_bias(p), h, dtype)
                 for p, h in zip(ps, hs)])
    if "b" not in ps[0]:
        return sums
    return per_copy(lambda s, p: s + p["b"].to(F32), sums, ps)


def tp_ffn_apply(ps, xs, dtype=torch.bfloat16,
                 half_step: bool = True) -> List[torch.Tensor]:
    """FFN (half-step by default): w1 column-parallel, SiLU, w2
    row-parallel."""
    hs = per_copy(lambda x, p: L.layernorm_apply(p["ln"], x), xs, ps)
    mids = [torch.nn.functional.silu(h)
            for h in column_dense([p["w1"] for p in ps], hs, dtype)]
    ys = row_dense([p["w2"] for p in ps], mids, dtype)
    scale = 0.5 if half_step else 1.0
    return per_copy(lambda x, y: x + scale * y, xs, ys)


def tp_mhsa_apply(ps, xs, n_heads: int, masks, cos, sin,
                  dtype=torch.bfloat16, use_flash: bool = False
                  ) -> List[torch.Tensor]:
    """Pre-LN RoPE self-attention with a residual, heads split over the
    shards (``models.layers.mhsa_apply`` on each shard's heads, then the
    output projection row-parallel)."""
    n = len(ps)
    hs = per_copy(lambda x, p: L.layernorm_apply(p["ln"], x), xs, ps)
    outs = []
    for p, h, mask, c, s in zip(ps, hs, masks, cos, sin):
        B, T, D = h.shape
        hd = D // n_heads
        heads = n_heads // n
        q, k, v = (L.dense_apply(p[name], h, dtype).reshape(B, T, heads, hd)
                   for name in ("wq", "wk", "wv"))
        q = L.apply_rope(q, c, s)
        k = L.apply_rope(k, c, s)
        if use_flash:
            with device_guard(h):
                o = FlashAttention.apply(q.to(dtype).contiguous(),
                                         k.to(dtype).contiguous(),
                                         v.to(dtype).contiguous(), mask)
            outs.append(o.to(F32).reshape(B, T, heads * hd))
            continue
        logits = torch.einsum("bthd,bshd->bhts", L.round_to(q, dtype),
                              L.round_to(k, dtype)) * (1.0 / math.sqrt(hd))
        neg = torch.finfo(F32).min
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full_like(logits, neg))
        attn = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", L.round_to(attn, dtype),
                         L.round_to(v, dtype))
        outs.append(o.reshape(B, T, heads * hd))
    ys = row_dense([p["wo"] for p in ps], outs, dtype)
    return per_copy(lambda x, y: x + y, xs, ys)


def tp_convmod_apply(ps, xs, masks, dtype=torch.bfloat16
                     ) -> List[torch.Tensor]:
    """The conv module with its channels split (the plain path of
    ``models.layers.convmod_apply`` on each shard's channels): LN over all
    D input channels, the shard's pw1 value and gate columns, GLU, mask,
    the depthwise taps on its D / n channels, the second LayerNorm with
    statistics merged over the shards, SiLU, pw2 row-parallel."""
    n = len(ps)
    D = xs[0].shape[-1]
    hs = per_copy(lambda x, p: L.layernorm_apply(p["ln"], x), xs, ps)
    cs, stats = [], []
    for p, h, mask in zip(ps, hs, masks):
        g = L.dense_apply(p["pw1"], h, dtype)
        dl = g.shape[-1] // 2
        u = g[..., :dl] * torch.sigmoid(g[..., dl:])
        u = torch.where(mask[:, :, None], u, torch.zeros_like(u))
        c = L.depthwise_conv(u, p["dw"])
        cs.append(c)
        stats.append(moments(c)[..., None, :])
    gathered = all_gather(stats, dim=-2)       # [B, T, n, 2] on each shard
    acts = []
    for m, (p, c, st) in enumerate(zip(ps, cs, gathered)):
        ln = p["dw_ln"]
        a = layernorm_from_moments(c, merge_moments(st, c.shape[-1]),
                                   torch.chunk(ln["scale"], n)[m],
                                   torch.chunk(ln["bias"], n)[m], D)
        acts.append(torch.nn.functional.silu(a))
    ys = row_dense([p["pw2"] for p in ps], acts, dtype)
    return per_copy(lambda x, y: x + y, xs, ys)


def tp_moe_dense(ps, xs):
    """Dense-dispatch mixture of experts with the experts split over the
    shards: the replicated router on each shard, each shard's experts over
    every token, the partial combines summed (exact: a token's partials
    are zero but on its expert's shard). Returns (xs, the routing's
    ``models.moe.routing_sums`` over these rows, from shard 0's router),
    from which the load-balance term of one row or of a whole batch
    follows."""
    hs = per_copy(lambda x, p: L.layernorm_apply(p["ln"], x), xs, ps)
    routed = per_copy(lambda h, p: route(p, h), hs, ps)
    e_local = ps[0]["w1"].shape[0]
    parts = [expert_combine(p, h, top, gate, m * e_local)
             for m, (p, h, (_, top, gate)) in enumerate(zip(ps, hs, routed))]
    ys = psum(parts)
    probs, top, _ = routed[0]
    return (per_copy(lambda x, y: x + 0.5 * y, xs, ys),
            routing_sums(probs, top))


def tp_moe_alltoall(ps, xs, capacity_factor: float) -> List[torch.Tensor]:
    """The all-to-all expert dispatch (``parallel/expert_dispatch.py``)
    over the shards' devices: the tokens of shard 0's copy split over the
    shards, each shard's own experts, the result replicated back."""
    from .expert_dispatch import ep_moe_apply

    devices = [x.device for x in xs]
    row = Mesh([devices], ("data", "model"))
    B, T, D = xs[0].shape
    y = ep_moe_apply(list(ps), xs[0].reshape(B * T, D), row,
                     capacity_factor=capacity_factor).reshape(B, T, D)
    return replicate(y, devices)
