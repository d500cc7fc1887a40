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
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..models import layers as L
from ..models.moe import expert_combine, load_balance, route
from ..ops.attention import FlashAttention
from ..ops.conv_module import (layernorm_from_moments, merge_moments,
                               moments)
from .mesh import (Mesh, _sub, all_gather, as_split, device_guard, psum,
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


def tp_ffn_apply(ps, xs, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """Half-step FFN: w1 column-parallel, SiLU, w2 row-parallel."""
    hs = per_copy(lambda x, p: L.layernorm_apply(p["ln"], x), xs, ps)
    mids = [torch.nn.functional.silu(h)
            for h in column_dense([p["w1"] for p in ps], hs, dtype)]
    ys = row_dense([p["w2"] for p in ps], mids, dtype)
    return per_copy(lambda x, y: x + 0.5 * y, xs, ys)


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
    are zero but on its expert's shard). Returns (xs, aux)."""
    hs = per_copy(lambda x, p: L.layernorm_apply(p["ln"], x), xs, ps)
    routed = per_copy(lambda h, p: route(p, h), hs, ps)
    e_local = ps[0]["w1"].shape[0]
    parts = [expert_combine(p, h, top, gate, m * e_local)
             for m, (p, h, (_, top, gate)) in enumerate(zip(ps, hs, routed))]
    ys = psum(parts)
    probs, top, _ = routed[0]
    return per_copy(lambda x, y: x + 0.5 * y, xs, ys), load_balance(probs,
                                                                    top)


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
