"""Mixture-of-experts FFN (top-1 router, Switch load-balance loss).

The PyTorch port of ``omnilingual_asr_tpu/models/moe.py``: with
``encoder.n_experts > 0`` each conformer block's second FFN becomes E
experts behind a learned top-1 router. This is the reference's dense
dispatch: every expert runs over every token and a one-hot combine keeps
the routed one, scaled by its gate (exact, and compute-redundant by a
factor E). ``parallel/expert_dispatch.py`` is the all-to-all alternative.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import layers as L

F32 = torch.float32


def moe_ffn_init(gen: torch.Generator, d_model: int, n_experts: int,
                 mult: int = 4):
    """Router (no bias), stacked expert weights [E, in, out] uniform in
    +-1/sqrt(fan_in), zero biases, an identity LayerNorm (the reference's
    distributions, drawn from ``gen``)."""
    s1 = 1.0 / math.sqrt(d_model)
    s2 = 1.0 / math.sqrt(d_model * mult)
    f = d_model * mult
    return {
        "ln": L.layernorm_init(d_model),
        "router": L.dense_init(gen, d_model, n_experts, use_bias=False),
        "w1": (torch.rand((n_experts, d_model, f), generator=gen) * 2 - 1)
        * s1,
        "b1": torch.zeros((n_experts, f)),
        "w2": (torch.rand((n_experts, f, d_model), generator=gen) * 2 - 1)
        * s2,
        "b2": torch.zeros((n_experts, d_model)),
    }


def moe_ffn_shapes(d_model: int, n_experts: int, mult: int = 4):
    """Shape tree of :func:`moe_ffn_init`'s parameters."""
    f = d_model * mult
    return {"ln": {"scale": (d_model,), "bias": (d_model,)},
            "router": {"w": (d_model, n_experts)},
            "w1": (n_experts, d_model, f), "b1": (n_experts, f),
            "w2": (n_experts, f, d_model), "b2": (n_experts, d_model)}


def route(p, h: torch.Tensor):
    """The f32 router over LayerNormed tokens ``h`` [..., D]: (probs
    [..., E], top-1 expert [...] (the first maximum, as ``argmax``),
    its gate [...])."""
    probs = torch.softmax(L.dense_apply(p["router"], h, F32).to(F32), dim=-1)
    top = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, -1, top[..., None])[..., 0]
    return probs, top, gate


def moe_ffn_spec():
    """Experts split over the model axis (shard m owns experts [m E / n,
    (m + 1) E / n)); the router and LayerNorm replicated."""
    from ..parallel.mesh import AXIS_MODEL

    return {"ln": L.layernorm_spec(),
            "router": L.dense_spec(None, None, use_bias=False),
            "w1": AXIS_MODEL, "b1": AXIS_MODEL, "w2": AXIS_MODEL,
            "b2": AXIS_MODEL}


def expert_combine(p, h: torch.Tensor, top: torch.Tensor, gate: torch.Tensor,
                   first: int = 0, dtype=F32) -> torch.Tensor:
    """sum_e out_e(h) * [top == first + e] * gate over the experts of
    ``p`` (experts ``first, first + 1, ...`` of the model): every expert
    over every token, the routed one kept. A token routed elsewhere gets
    exact zeros, so the partial sums of disjoint expert sets add up to the
    whole exactly."""
    E = p["w1"].shape[0]
    local = top - first
    hit = (local >= 0) & (local < E)
    onehot = (torch.nn.functional.one_hot(local.clamp(0, E - 1), E).to(F32)
              * hit[..., None].to(F32))
    hh = L.round_to(h, dtype)
    mid = L.round_to(torch.einsum("btd,edf->btef", hh,
                                  L.round_to(p["w1"], dtype)), dtype)
    mid = torch.nn.functional.silu(mid + p["b1"][None, None].to(F32))
    out = L.round_to(torch.einsum("btef,efd->bted", L.round_to(mid, dtype),
                                  L.round_to(p["w2"], dtype)), dtype)
    out = out + p["b2"][None, None].to(F32)
    return torch.einsum("bted,bte->btd", out, onehot) * gate[..., None]


def load_balance(probs: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """The Switch Transformer's load-balance term ``E * sum_e f_e * p_e``
    (f: the share of tokens routed to e, p: e's mean router
    probability), about 1 when balanced."""
    return load_balance_from_sums(*routing_sums(probs, top))


def routing_sums(probs: torch.Tensor, top: torch.Tensor):
    """One block's routing over some rows of a batch, in sums that add over
    rows: (the router probabilities summed over every (B, T) frame [E]
    (differentiable), the frames routed to each expert [E], the frames)."""
    E = probs.shape[-1]
    counts = torch.nn.functional.one_hot(top, E).to(F32).sum(dim=(0, 1))
    return probs.sum(dim=(0, 1)), counts, top.shape[0] * top.shape[1]


def load_balance_from_sums(prob_sum: torch.Tensor, counts: torch.Tensor,
                           frames: int) -> torch.Tensor:
    """:func:`load_balance` from :func:`routing_sums` added over the rows
    of the whole batch: f and p are means over every frame of the batch,
    padding included, so the term is not a mean of the rows' terms."""
    E = prob_sum.shape[-1]
    return E * torch.sum((counts / frames) * (prob_sum / frames))


def moe_ffn_apply(p, x: torch.Tensor, dtype=F32,
                  half_step: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, D] -> (y [B, T, D], aux scalar).

    aux is :func:`load_balance`'s term. ``dtype`` is the experts' compute
    dtype (f32 by default, as the reference's); their products are
    rounded to it as the reference's einsums round theirs.
    """
    h = L.layernorm_apply(p["ln"], x)
    probs, top, gate = route(p, h)
    y = expert_combine(p, h, top, gate, 0, dtype)
    return x + (0.5 * y if half_step else y), load_balance(probs, top)
