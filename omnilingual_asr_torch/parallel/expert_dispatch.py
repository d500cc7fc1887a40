"""Expert-parallel mixture of experts with all-to-all token dispatch.

The PyTorch port of ``omnilingual_asr_tpu/parallel/expert_dispatch.py``.
Tokens and experts both split over one mesh axis. Each shard routes its
tokens, packs them into one capacity buffer per destination shard,
exchanges the buffers (``parallel.mesh.all_to_all``), runs only its own
experts on what it received, and sends the results back. Top-1 routing
with a per-(source, destination) capacity; a token past its
destination's capacity is dropped: its expert output is zero and the
residual carries it through.
"""

from __future__ import annotations

from typing import List

import torch

from ..models import layers as L
from ..models.moe import route
from .mesh import Mesh, all_to_all, gather, replicate, scatter

F32 = torch.float32


def capacity(capacity_factor: float, n_local: int, n_dev: int) -> int:
    """Tokens a source shard may send to one destination."""
    return max(1, int(capacity_factor * n_local / n_dev))


def _pack(h, dst, local_eid, n_dev: int, cap: int):
    """Send buffers [n_dev, cap, D] and expert ids [n_dev, cap] (-1: an
    empty slot), and each token's (destination, slot, kept).

    A token's slot is its rank among the tokens with its destination; a
    token ranked past ``cap`` is dropped. A dropped token adds a zero (its
    tokens) and takes the max with -1 (its expert id) at slot (0, 0), as
    the reference's ``.at[].add`` / ``.at[].max`` do, so it never
    overwrites a kept token there."""
    n_loc, D = h.shape
    one = torch.nn.functional.one_hot(dst, n_dev).to(torch.int64)
    pos = ((torch.cumsum(one, dim=0) - one) * one).sum(dim=-1)
    keep = pos < cap
    idx_d = torch.where(keep, dst, torch.zeros_like(dst))
    idx_p = torch.where(keep, pos, torch.zeros_like(pos))
    slot = idx_d * cap + idx_p
    tok = torch.zeros((n_dev * cap, D), dtype=h.dtype, device=h.device)
    tok = tok.index_add(0, slot, torch.where(keep[:, None], h,
                                             torch.zeros_like(h)))
    eid = torch.full((n_dev * cap,), -1, dtype=torch.int64, device=h.device)
    eid = eid.scatter_reduce(0, slot, torch.where(
        keep, local_eid, torch.full_like(local_eid, -1)), reduce="amax",
        include_self=True)
    return (tok.reshape(n_dev, cap, D), eid.reshape(n_dev, cap), idx_d,
            idx_p, keep)


def _local_experts(p, recv_tok, recv_eid, e_local: int):
    """Each received token through its local expert (f32); zeros in the
    empty slots."""
    n_dev, cap, D = recv_tok.shape
    flat = recv_tok.reshape(n_dev * cap, D).to(F32)
    eid = recv_eid.reshape(n_dev * cap)
    out = torch.zeros_like(flat)
    for e in range(e_local):
        rows = eid == e
        mid = torch.nn.functional.silu(flat @ p["w1"][e].to(F32)
                                       + p["b1"][e].to(F32))
        y = mid @ p["w2"][e].to(F32) + p["b2"][e].to(F32)
        out = torch.where(rows[:, None], y, out)
    return out.reshape(n_dev, cap, D).to(recv_tok.dtype)


def ep_moe_apply(p, x: torch.Tensor, mesh: Mesh, axis: str = "model",
                 capacity_factor: float = 2.0, data_axis: str = None,
                 stats: dict = None) -> torch.Tensor:
    """Expert-parallel MoE forward (half-step residual).

    p: ``models.moe.moe_ffn_init`` parameters; shard ``m`` of ``axis``
    owns experts ``[m * E / n, (m + 1) * E / n)``, and the router and
    LayerNorm are replicated. ``p`` may also be a list of the shards'
    own trees (``moe_ffn_spec``'s placement: shard m's experts and the
    replicated rest, as tensor parallelism holds them). x: [N, D] tokens
    on one device, split over ``axis`` (N divisible by its size); with
    ``data_axis``, over
    ``(data_axis, axis)`` with the exchange inside each data row. Returns
    [N, D] on x's device. With ``stats`` (a dict), its ``"dropped"`` gets
    the number of tokens past their capacity.
    """
    n_dev = mesh.shape[axis]
    local = p if isinstance(p, list) else None
    if local is not None:
        if len(local) != n_dev:
            raise ValueError(f"{len(local)} expert shards for {n_dev} "
                             f"devices")
        p = local[0]
    E = p["w1"].shape[0] * (n_dev if local is not None else 1)
    if E % n_dev:
        raise ValueError(f"{E} experts do not split over {n_dev} shards")
    e_local = E // n_dev
    N, D = x.shape
    rows = _rows(mesh, axis, data_axis)
    n_loc = N // (len(rows) * n_dev)
    cap = capacity(capacity_factor, n_loc, n_dev)
    shards = scatter(x, [d for row in rows for d in row], 0)
    dropped = []
    out: List[torch.Tensor] = []
    for r, devices in enumerate(rows):
        xs = shards[r * n_dev:(r + 1) * n_dev]
        packed, gates = [], []
        for xl, dev in zip(xs, devices):
            shared = {k: {n: replicate(v, [dev])[0] for n, v in p[k].items()}
                      for k in ("ln", "router")}
            h = L.layernorm_apply(shared["ln"], xl)
            _, top, gate = route(shared, h)
            packed.append(_pack(h, top // e_local, top % e_local, n_dev, cap))
            gates.append(gate)
            dropped.append((~packed[-1][4]).sum())
        recv_tok = all_to_all([pk[0] for pk in packed])
        recv_eid = all_to_all([pk[1] for pk in packed])
        results = []
        for m, dev in enumerate(devices):
            sl = slice(m * e_local, (m + 1) * e_local)
            mine = {k: replicate(local[m][k] if local is not None
                                 else p[k][sl], [dev])[0]
                    for k in ("w1", "b1", "w2", "b2")}
            results.append(_local_experts(mine, recv_tok[m], recv_eid[m],
                                          e_local))
        back = all_to_all(results)
        for m, xl in enumerate(xs):
            _, _, idx_d, idx_p, keep = packed[m]
            got = back[m][idx_d, idx_p]
            got = torch.where(keep[:, None], got, torch.zeros_like(got))
            y = got * gates[m][:, None].to(got.dtype)
            out.append(xl + 0.5 * y.to(xl.dtype))
    if stats is not None:
        stats["dropped"] = int(sum(int(d) for d in dropped))
        stats["capacity"] = cap
    return gather(out, 0, x.device)


def _rows(mesh: Mesh, axis: str, data_axis) -> List[List[torch.device]]:
    """The devices of ``axis`` in each data row (one row without a data
    axis); tokens split over the rows, row-major, as over
    ``(data_axis, axis)``."""
    if not data_axis:
        return [mesh.axis_devices(axis)]
    grid = mesh.devices
    if mesh.axis_names.index(data_axis) > mesh.axis_names.index(axis):
        grid = grid.T
    return [list(row) for row in grid]
