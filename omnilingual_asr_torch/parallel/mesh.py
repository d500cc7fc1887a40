"""Device mesh and the collectives between its shards.

The PyTorch port of ``omnilingual_asr_tpu/parallel/mesh.py``. The JAX
package is single-controller: one process drives every device of a
``jax.sharding.Mesh``, and XLA emits the collectives. The port keeps that
model. A :class:`Mesh` is a numpy object array of ``torch.device``s with
named axes; a sharded tensor is a Python list of per-shard tensors, one
per device along an axis, and the functions below are the only way one
shard reaches another:

- :func:`ppermute` (``jax.lax.ppermute``), :func:`all_to_all`
  (``jax.lax.all_to_all`` with ``tiled=False``), :func:`psum` and
  :func:`all_gather` (over a flat list of shards, or over one axis of the
  mesh within each group of the other axes);
- :func:`scatter` and :func:`gather` along a tensor dimension (what a
  ``shard_map`` in_spec / out_spec does).

A parameter's placement is a spec (:func:`shard_params`): replicated, or
one dimension split over one axis (:class:`Split`, the port's
``PartitionSpec``).

Devices may repeat: ``[cpu] * 4`` in the tests, ``[cuda:0] * 4`` on one
card, where the shards of a mesh run one after another on the same
device. No collective writes into a tensor it was given or returns, so a
result may alias an input (a shard that stays on its device is not
copied). Between distinct CUDA devices a copy is enqueued on the
consumer's current stream after an event recorded on the producer's, so
every cross-device ordering of the port lives in :func:`to_device`.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MeshConfig

AXIS_DATA = "data"
AXIS_MODEL = "model"


class Mesh:
    """Devices on a grid with named axes (``devices.shape`` follows
    ``axis_names``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            arr.flat[i] = _indexed(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device grid with axis names "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (the mesh's other axes at index 0)."""
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for k in range(self.devices.shape[i]):
            idx[i] = k
            out.append(self.devices[tuple(idx)])
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _indexed(device) -> torch.device:
    """``device`` as a ``torch.device``; a bare ``"cuda"`` gets the
    current device's index, so that equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _visible_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass the mesh's devices "
            "explicitly (devices=[torch.device('cpu')] * n on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-host start-up, by the JAX package's environment rules.

    Returns False on one host: no coordinator address (argument or
    ``COORDINATOR_ADDRESS``) and no ``TPU_WORKER_HOSTNAMES``. A mesh over
    several hosts needs one process per host, which a single controller
    cannot be, so any other case raises."""
    coordinator_address = coordinator_address or os.getenv(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None and os.getenv(
            "TPU_WORKER_HOSTNAMES") is None:
        return False
    raise NotImplementedError(
        "a multi-host mesh is not ported: the port drives every device of "
        "a mesh from one process (multi-host init_distributed, A10 in "
        "ROADMAP.md, Queue A)")


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device, as the JAX package spans ``jax.devices()``). Devices may
    repeat."""
    cfg = cfg or MeshConfig()
    devices = (list(devices) if devices is not None
               else _visible_cuda_devices())
    n = len(devices)
    data, model = cfg.resolve(n)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {n}")
    grid = np.empty((data, model), dtype=object)
    for i in range(data * model):
        grid.flat[i] = _indexed(devices[i])
    return Mesh(grid, (AXIS_DATA, AXIS_MODEL))


class Split(NamedTuple):
    """A leaf's dimension ``dim`` split into equal blocks over mesh axis
    ``axis``, block i on the axis's device i: ``PartitionSpec`` with
    ``axis`` at position ``dim``. With ``halves = 2`` the dimension is two
    equal halves and block i is block i of each half, side by side (a GLU
    weight's value | gate columns, so that each shard's GLU stays local)."""
    axis: str
    dim: int = 0
    halves: int = 1


def as_split(spec) -> Optional[Split]:
    """A spec as a :class:`Split`, or None for a replicated leaf. A spec is
    None, an axis name (the leading dimension), a :class:`Split`, or a
    tuple of axis names and Nones by dimension, as a ``PartitionSpec``
    (at most one dimension split)."""
    if spec is None or isinstance(spec, Split):
        return spec
    if isinstance(spec, str):
        return Split(spec, 0)
    named = [(i, a) for i, a in enumerate(spec) if a is not None]
    if not named:
        return None
    if len(named) > 1:
        raise ValueError(f"spec {spec!r} splits more than one dimension")
    return Split(named[0][1], named[0][0])


def split_block(t: torch.Tensor, spec, index: int, n: int) -> torch.Tensor:
    """Block ``index`` of ``n`` of ``t`` under ``spec`` (a view where the
    block is one slice); a replicated spec gives ``t``."""
    sp = as_split(spec)
    if sp is None:
        return t
    size = t.shape[sp.dim]
    if size % (n * sp.halves):
        raise ValueError(f"dimension {sp.dim} of {tuple(t.shape)} does not "
                         f"split into {n} shards"
                         + (f" of each of {sp.halves} halves"
                            if sp.halves > 1 else ""))
    halves = torch.chunk(t, sp.halves, dim=sp.dim)
    blocks = [torch.chunk(h, n, dim=sp.dim)[index] for h in halves]
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=sp.dim)


def shard_params(params, specs, mesh: Mesh):
    """Place a parameter tree on the mesh by a tree of specs.

    A spec is None (replicated), an axis name (the leaf's leading
    dimension split over that axis, as ``PartitionSpec(axis)``), a
    :class:`Split` (any dimension, over an axis; a GLU's two halves each
    split), or a ``PartitionSpec``-like tuple such as ``(None, "model")``.
    Returns, for each leaf, a list with one tensor per device along the
    split axis (the axis's devices, the other axes at index 0) or per
    distinct mesh device (replicated; a device that repeats shares its
    copy). ``models.conformer.shard_for_tp`` places a whole tree for every
    shard of a (data, model) mesh."""
    if isinstance(params, dict):
        return {k: shard_params(v, _sub(specs, k), mesh)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_params(v, _sub(specs, i), mesh)
                for i, v in enumerate(params)]
    sp = as_split(specs)
    if sp is None:
        return replicate(params, mesh.distinct_devices())
    devices = mesh.axis_devices(sp.axis)
    return [to_device(split_block(params, sp, i, len(devices)), d)
            for i, d in enumerate(devices)]


def _sub(specs, key):
    """The spec of a subtree: a leaf spec (None, a name, a Split or a
    tuple) holds for every leaf below it; dicts and lists are trees."""
    if specs is None or isinstance(specs, (str, tuple)):
        return specs
    return specs[key]


# ---------------------------------------------------------------------------
# Moving tensors between shards
# ---------------------------------------------------------------------------

def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: ``t`` itself when it is there already. Between
    two CUDA devices the copy runs on the consumer's current stream after
    an event recorded on the producer's current stream, and the source's
    memory is kept for that stream."""
    device = torch.device(device)
    if t.device == device:
        return t
    if t.device.type == "cuda" and device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        with torch.cuda.device(device), torch.cuda.stream(consumer):
            out = torch.empty_like(t, device=device)
            out.copy_(t, non_blocking=True)
        t.record_stream(consumer)
        return out
    return t.to(device)


def device_guard(t: torch.Tensor):
    """A context in which ``t``'s CUDA device is the current one (what a
    hand-written kernel launches on); a no-op for a CPU tensor."""
    import contextlib

    return (torch.cuda.device(t.device) if t.is_cuda
            else contextlib.nullcontext())


def replicate(t: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """One copy of ``t`` per device (a repeated device shares its copy)."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = to_device(t, d)
        out.append(copies[d])
    return out


def scatter(t: torch.Tensor, devices: Sequence[torch.device],
            dim: int = 0) -> List[torch.Tensor]:
    """Split ``t`` into ``len(devices)`` equal blocks along ``dim``, block
    i on device i."""
    n = len(devices)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {n} shards")
    return [to_device(b, d) for b, d in zip(torch.chunk(t, n, dim=dim),
                                            devices)]


def gather(shards: Sequence[torch.Tensor], dim: int = 0,
           device: Optional[torch.device] = None) -> torch.Tensor:
    """Concatenate the shards along ``dim`` on ``device`` (default: the
    first shard's)."""
    device = torch.device(device) if device is not None else shards[0].device
    return torch.cat([to_device(s, device) for s in shards], dim=dim)


def ppermute(shards: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute``: shard ``dst`` receives shard ``src`` for each
    ``(src, dst)`` pair; a shard that receives nothing gets zeros. The
    result of shard ``dst`` lies on shard ``dst``'s device."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for src, dst in perm:
        out[dst] = to_device(shards[src], shards[dst].device)
    return [o if o is not None else torch.zeros_like(s)
            for o, s in zip(out, shards)]


def ring_perm(n: int, step: int = 1) -> List[Tuple[int, int]]:
    """The ring permutation ``i -> (i + step) % n``."""
    return [(i, (i + step) % n) for i in range(n)]


def all_to_all(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: shard i's block
    j (its leading index) goes to shard j, where it becomes block i."""
    n = len(shards)
    for s in shards:
        if s.shape[0] != n:
            raise ValueError(f"all_to_all over {n} shards needs a leading "
                             f"dimension of {n}, got {tuple(s.shape)}")
    return [torch.stack([to_device(shards[i][j], shards[j].device)
                         for i in range(n)]) for j in range(n)]


def _groups(n: int, mesh: Optional[Mesh], axis: Optional[str]
            ) -> List[List[int]]:
    """Indices of the shards that reduce together: all ``n`` without a
    mesh; with one, the shards are one per mesh device in row-major
    order and each group runs along ``axis`` with the other axes fixed."""
    if mesh is None:
        return [list(range(n))]
    if n != mesh.size:
        raise ValueError(f"{n} shards on a mesh of {mesh.size} devices")
    idx = np.arange(n).reshape(mesh.devices.shape)
    idx = np.moveaxis(idx, mesh.axis_names.index(axis), -1)
    return [list(map(int, g)) for g in idx.reshape(-1, idx.shape[-1])]


def psum(shards: Sequence[torch.Tensor], mesh: Optional[Mesh] = None,
         axis: Optional[str] = None) -> List[torch.Tensor]:
    """``jax.lax.psum``: every shard gets the sum of all shards (added in
    shard order; shards on one device share the sum). With ``mesh`` and
    ``axis`` the shards are one per mesh device (row-major) and the sums
    run over ``axis`` only: over the model axis, within each data row."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for g in _groups(len(shards), mesh, axis):
        sums: Dict[torch.device, torch.Tensor] = {}
        for i in g:
            d = shards[i].device
            if d not in sums:
                acc = to_device(shards[g[0]], d)
                for j in g[1:]:
                    acc = acc + to_device(shards[j], d)
                sums[d] = acc
            out[i] = sums[d]
    return out


def all_gather(shards: Sequence[torch.Tensor], dim: int = 0,
               mesh: Optional[Mesh] = None,
               axis: Optional[str] = None) -> List[torch.Tensor]:
    """``jax.lax.all_gather(..., tiled=True)``: every shard gets the shards
    concatenated along ``dim``, in shard order (shards on one device share
    the result). ``mesh`` and ``axis`` group the shards as in
    :func:`psum`."""
    out: List[Optional[torch.Tensor]] = [None] * len(shards)
    for g in _groups(len(shards), mesh, axis):
        cats: Dict[torch.device, torch.Tensor] = {}
        for i in g:
            d = shards[i].device
            if d not in cats:
                cats[d] = gather([shards[j] for j in g], dim, d)
            out[i] = cats[d]
    return out
