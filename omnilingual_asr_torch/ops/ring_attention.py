"""Ring attention: exact attention with the sequence split over a mesh axis.

The PyTorch port of ``omnilingual_asr_tpu/ops/ring_attention.py``. Each
shard holds its block of queries; the key, value and key-mask blocks
rotate around the ring (``parallel.mesh.ppermute``) while an online
softmax accumulates, so after ``n`` steps every query has seen every key.
The math is the reference's, in f32 outside any kernel (the JAX package
computes it in XLA, not Pallas): masked scores take the ``-1e30`` fill,
the probabilities are multiplied by the key mask, and the result is
divided by ``max(l, 1e-30)``.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from ..parallel.mesh import Mesh, gather, ppermute, ring_perm, scatter

NEG_INF = -1e30


def ring_attention_shards(q: Sequence[torch.Tensor],
                          k: Sequence[torch.Tensor],
                          v: Sequence[torch.Tensor],
                          mask: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
    """Ring attention over per-shard blocks.

    q, k, v: one [B, T_local, H, D] tensor a shard; mask: one [B, T_local]
    key mask a shard. Returns one [B, T_local, H, D] f32 tensor a shard.
    """
    n = len(q)
    scale = 1.0 / math.sqrt(q[0].shape[-1])
    fwd = ring_perm(n)
    qf = [x.to(torch.float32) * scale for x in q]
    kb = [x.to(torch.float32) for x in k]
    vb = [x.to(torch.float32) for x in v]
    mb = [x.to(torch.int32) for x in mask]
    state = []
    for x in qf:
        B, Tl, H, D = x.shape
        state.append([torch.zeros((B, H, Tl, D), dtype=torch.float32,
                                  device=x.device),
                      torch.full((B, H, Tl, 1), NEG_INF, dtype=torch.float32,
                                 device=x.device),
                      torch.zeros((B, H, Tl, 1), dtype=torch.float32,
                                  device=x.device)])
    for step in range(n):
        for i in range(n):
            acc, m, l = state[i]
            # The scores are this step's own tensor: masked, shifted,
            # exponentiated and masked again in place, so a step holds one
            # [B, H, T_local, T_local] block (the reference's math).
            s = torch.einsum("bthd,bshd->bhts", qf[i], kb[i])
            valid = mb[i][:, None, None, :] > 0
            s.masked_fill_(~valid, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = s.sub_(m_new).exp_().mul_(valid)
            alpha = torch.exp(m - m_new)
            state[i] = [acc * alpha + torch.einsum("bhts,bshd->bhtd", p,
                                                   vb[i]),
                        m_new, l * alpha + p.sum(dim=-1, keepdim=True)]
            del s, valid, p
        if step < n - 1:          # the last rotation would go unused
            kb, vb, mb = ppermute(kb, fwd), ppermute(vb, fwd), \
                ppermute(mb, fwd)
    return [(acc / torch.clamp(l, min=1e-30)).transpose(1, 2)
            for acc, _, l in state]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, mesh: Mesh,
                   axis: str = "data") -> torch.Tensor:
    """Exact attention with the sequence axis split over ``axis``.

    q, k, v: [B, T, H, D] (T divisible by the axis size); mask: [B, T] key
    validity. Returns [B, T, H, D] f32 on q's device.
    """
    devices = mesh.axis_devices(axis)
    out = ring_attention_shards(scatter(q, devices, 1),
                                scatter(k, devices, 1),
                                scatter(v, devices, 1),
                                scatter(mask, devices, 1))
    return gather(out, dim=1, device=q.device)
