"""Pipeline parallelism: conformer blocks split by stage over a mesh axis.

The PyTorch port of ``omnilingual_asr_tpu/parallel/pipeline.py``: L blocks
stack along a leading dimension, stage s holds blocks ``[s L/S, (s+1)
L/S)``, and M microbatches pass through the stages in the GPipe schedule
of S + M - 1 steps: at step t stage s works on microbatch t - s, stage 0
reading it from the input and every other stage the activation its left
neighbour sent (``ppermute``) at the step before. The last stage commits
each finished microbatch, and the outputs are broadcast to every stage
(the reference's ``psum`` of the last stage's outputs). With S = 1 the
schedule is sequential execution.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import PipelineConfig
from ..device import exact_f32
from ..models.conformer import compute_dtype, conformer_block_apply
from .mesh import Mesh, ppermute, psum, replicate, ring_perm, to_device


def stack_blocks(blocks: list):
    """L block trees of one structure -> one tree with a leading L axis."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_blocks([b[k] for b in blocks]) for k in first}
    return torch.stack(blocks)


def _index(stacked, i):
    if isinstance(stacked, dict):
        return {k: _index(v, i) for k, v in stacked.items()}
    return stacked[i]


def _n_blocks(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def _to(stacked, device):
    if isinstance(stacked, dict):
        return {k: _to(v, device) for k, v in stacked.items()}
    return to_device(stacked, device)


def apply_stacked_blocks(stacked, x, mask, cos, sin, cfg: PipelineConfig,
                         dtype) -> torch.Tensor:
    """The stacked blocks applied one after another."""
    for i in range(_n_blocks(stacked)):
        x, _ = conformer_block_apply(_index(stacked, i), x, mask, cos, sin,
                                     cfg.encoder, dtype)
    return x


def pipeline_forward(stacked, x_mb: torch.Tensor, mask: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     cfg: PipelineConfig, mesh: Mesh,
                     axis: str = "stage") -> torch.Tensor:
    """M microbatches through stage-split blocks.

    stacked: a block tree with leading dimension L (L % S == 0); x_mb:
    [M, B, T, D]; mask [B, T] bool; cos/sin the RoPE tables. Returns
    [M, B, T, D] after all L blocks, on x_mb's device.
    """
    devices = mesh.axis_devices(axis)
    S = len(devices)
    M = x_mb.shape[0]
    L = _n_blocks(stacked)
    if L % S:
        raise ValueError(f"{L} blocks do not split into {S} stages")
    per = L // S
    dtype = compute_dtype(cfg.encoder)
    exact_f32(devices)
    stages = [_to(_slice(stacked, s * per, (s + 1) * per), d)
              for s, d in enumerate(devices)]
    consts = [tuple(replicate(t, [d])[0] for t in (x_mb, mask, cos, sin))
              for d in devices]
    recv: List[torch.Tensor] = [torch.zeros(x_mb.shape[1:], dtype=x_mb.dtype,
                                            device=d) for d in devices]
    outputs = torch.zeros_like(consts[-1][0])
    for t in range(S + M - 1):
        outs = []
        for s in range(S):
            m = t - s
            xs, ms, cs, ss = consts[s]
            if 0 <= m < M:
                inp = xs[m] if s == 0 else recv[s]
                out = apply_stacked_blocks(stages[s], inp, ms, cs, ss, cfg,
                                           dtype).to(x_mb.dtype)
            else:
                out = recv[s]
            if s == S - 1 and 0 <= t - (S - 1) < M:
                outputs = outputs.index_copy(
                    0, torch.tensor([t - (S - 1)], device=out.device),
                    out[None])
            outs.append(out)
        recv = ppermute(outs, ring_perm(S))
    finished = [outputs if s == S - 1 else torch.zeros_like(consts[s][0])
                for s in range(S)]
    return to_device(psum(finished)[0], x_mb.device)


def _slice(stacked, a: int, b: int):
    if isinstance(stacked, dict):
        return {k: _slice(v, a, b) for k, v in stacked.items()}
    return stacked[a:b]
