"""Device mesh and the collectives between its shards.

The PyTorch port of ``omnilingual_asr_tpu/parallel/mesh.py``. The JAX
package is multi-controller: one process a host, each driving its local
devices, joined by ``jax.distributed.initialize``; ``jax.devices()`` then
spans every host and XLA emits the collectives. The port has the same
shape. Within a process, a :class:`Mesh` is a numpy object array of
``torch.device``s with named axes; a sharded tensor is a Python list of
per-shard tensors, one per device along an axis, and the functions below
are the only way one shard reaches another:

- :func:`ppermute` (``jax.lax.ppermute``), :func:`all_to_all`
  (``jax.lax.all_to_all`` with ``tiled=False``), :func:`psum` and
  :func:`all_gather` (over a flat list of shards, or over one axis of the
  mesh within each group of the other axes);
- :func:`scatter` and :func:`gather` along a tensor dimension (what a
  ``shard_map`` in_spec / out_spec does).

Across processes (:func:`init_distributed`, over ``torch.distributed``), a
mesh built by :func:`build_mesh` spans every process's devices in rank
order, and each process holds whole data rows (a model group never spans
processes): :meth:`Mesh.local` is its own rows, on which the code above
runs unchanged. Only what crosses the ``data`` axis between processes goes
over ``torch.distributed``: :func:`process_all_gather`,
:func:`process_all_reduce`, :func:`process_all_reduce_many` and
:func:`process_broadcast`.

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
    ``axis_names``). ``processes``: the rank that drives each position,
    for a mesh that :func:`build_mesh` built over several processes (None:
    this process drives every position)."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for i, d in enumerate(src.flat):
            arr.flat[i] = _indexed(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device grid with axis names "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.processes = (None if processes is None else
                          np.asarray(processes, dtype=np.int64).reshape(
                              arr.shape))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        """Whether positions of this mesh lie in other processes."""
        return (self.processes is not None
                and len(set(self.processes.flat)) > 1)

    def local(self) -> "Mesh":
        """This process's data rows, as a mesh of their own (the whole
        mesh where one process drives it)."""
        if self.processes is None:
            return self
        rows = [r for r in range(self.devices.shape[0])
                if self.processes[r, 0] == process_index()]
        return Mesh(self.devices[rows], self.axis_names)

    def process_block(self) -> Tuple[int, int]:
        """(index, count): this process's block of a batch split into
        ``count`` equal blocks over the processes, in rank order (each
        process holds the same number of data rows); (0, 1) in one
        process."""
        if not self.spans_processes:
            return 0, 1
        return process_index(), len(set(self.processes.flat))

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
        procs = ("" if self.processes is None
                 else f", processes={self.processes.tolist()}")
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}{procs})")


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


#: The port of ``jax.distributed``'s default coordinator port, for a
#: coordinator named by ``TPU_WORKER_HOSTNAMES`` alone.
DEFAULT_COORDINATOR_PORT = 8476
#: How long a process waits for the others at start-up and in a
#: collective before the group fails.
DEFAULT_TIMEOUT_S = 1800.0
A10 = "multi-host mesh, A10 in ROADMAP.md, Queue A"


class _Processes:
    """This process's place among the processes :func:`init_distributed`
    joined: its rank, their count, its local devices, the backend chosen
    and the group that carries tensors, and the bytes it has handed to
    collectives."""

    def __init__(self, rank: int, count: int, devices, backend: str,
                 group, stage: torch.device):
        self.rank, self.count, self.devices = rank, count, devices
        self.backend, self.group, self.stage = backend, group, stage
        self.bytes = 0


_PROCESSES: Optional[_Processes] = None


def _process_setting(value, name: str, default=None) -> int:
    """An integer from the argument, else the environment variable
    ``name``, else ``default``; a ValueError naming ``name`` when none
    gives one."""
    if value is None:
        value = os.getenv(name) or default
    if value is None:
        raise ValueError(f"a multi-process start-up needs {name} (the "
                         f"argument or the environment variable)")
    return int(value)


def local_devices() -> List[torch.device]:
    """This process's devices (``jax.local_devices()``): those given to
    :func:`init_distributed`, else every visible CUDA device, else the
    CPU."""
    if _PROCESSES is not None:
        return list(_PROCESSES.devices)
    if torch.cuda.is_available():
        return _visible_cuda_devices()
    return [torch.device("cpu")]


def _device_facts(devices: Sequence[torch.device]) -> dict:
    """What the backend choice reads of one process's devices: whether
    one is not a card, and the cards' UUIDs."""
    cards = sorted({str(torch.cuda.get_device_properties(d).uuid)
                    for d in devices if d.type == "cuda"})
    return {"host": any(d.type != "cuda" for d in devices), "cards": cards}


def choose_backend(facts: Sequence[dict], nccl_available: bool) -> str:
    """The backend the tensors cross on, from every process's
    :func:`_device_facts`: ``gloo`` where a process's devices are not all
    cards, or where two processes share a card (NCCL refuses two ranks on
    one GPU; gloo stages each tensor through host memory while the kernels
    still run on the card); ``nccl`` where every process has cards of its
    own (and this PyTorch has NCCL)."""
    if any(f["host"] or not f["cards"] for f in facts):
        return "gloo"
    cards = [c for f in facts for c in f["cards"]]
    if len(cards) != len(set(cards)) or not nccl_available:
        return "gloo"
    return "nccl"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     devices: Optional[Sequence] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Multi-host start-up, by the JAX package's argument and environment
    rules: one process a host, called once in each before a mesh is built.

    Returns False on one host: no coordinator address (argument or
    ``COORDINATOR_ADDRESS``) and no ``TPU_WORKER_HOSTNAMES``. Otherwise the
    coordinator is ``host:port`` (``TPU_WORKER_HOSTNAMES``' first host at
    :data:`DEFAULT_COORDINATOR_PORT` where no address is given), the
    process count the argument, ``NUM_PROCESSES`` or the number of
    ``TPU_WORKER_HOSTNAMES``, the rank the argument or ``PROCESS_ID``; a
    missing one is a ValueError naming it. ``devices``: this process's
    devices (default: :func:`local_devices`).

    The group starts on gloo (``tcp://`` at the coordinator, every wait
    bounded by ``timeout_s``), over which the processes' device facts are
    gathered; :func:`choose_backend` then decides from them alone where
    tensors cross, and where it picks NCCL a group of that backend carries
    them. Afterwards :func:`build_mesh` spans every process's devices.
    Returns True."""
    global _PROCESSES
    import datetime

    import torch.distributed as dist

    hosts = os.getenv("TPU_WORKER_HOSTNAMES")
    coordinator_address = coordinator_address or os.getenv(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None and hosts is None:
        return False
    if _PROCESSES is not None:
        raise RuntimeError("init_distributed was already called in this "
                           "process")
    names = [h for h in (hosts or "").split(",") if h]
    if coordinator_address is None:
        coordinator_address = f"{names[0]}:{DEFAULT_COORDINATOR_PORT}"
    count = _process_setting(num_processes, "NUM_PROCESSES",
                             len(names) or None)
    rank = _process_setting(process_id, "PROCESS_ID")
    if not 0 <= rank < count:
        raise ValueError(f"process id {rank} outside 0..{count - 1}")
    local = [_indexed(d) for d in (devices if devices is not None
                                   else local_devices())]
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=count, rank=rank, timeout=timeout)
    facts: List[Optional[dict]] = [None] * count
    dist.all_gather_object(facts, _device_facts(local))
    backend = choose_backend(facts, dist.is_nccl_available())
    group, stage = None, torch.device("cpu")
    if backend == "nccl":
        stage = local[0]
        torch.cuda.set_device(stage)
        group = dist.new_group(backend="nccl", timeout=timeout)
    _PROCESSES = _Processes(rank, count, local, backend, group, stage)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``); a no-op in one process."""
    global _PROCESSES
    if _PROCESSES is None:
        return
    import torch.distributed as dist

    _PROCESSES = None
    dist.destroy_process_group()


def distributed_backend() -> Optional[str]:
    """``"gloo"`` or ``"nccl"``: what tensors cross processes on; None in
    one process."""
    return None if _PROCESSES is None else _PROCESSES.backend


def process_index() -> int:
    """This process's rank (``jax.process_index``)."""
    return 0 if _PROCESSES is None else _PROCESSES.rank


def process_count() -> int:
    """The number of processes (``jax.process_count``)."""
    return 1 if _PROCESSES is None else _PROCESSES.count


def require_one_process(mesh: Mesh, what: str) -> None:
    """NotImplementedError naming A10 where ``mesh`` spans processes and
    ``what`` runs only within one."""
    if mesh.spans_processes:
        raise NotImplementedError(f"{what} over a mesh that spans "
                                  f"processes is not ported ({A10})")


def _gathered_objects(obj) -> list:
    import torch.distributed as dist

    out: list = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible CUDA
    device, as the JAX package spans ``jax.devices()``). Devices may
    repeat.

    After :func:`init_distributed`, ``devices`` are this process's
    (default: :func:`local_devices`) and the mesh spans every process's,
    in rank order, as ``jax.devices()`` spans hosts: each process learns
    the whole grid and which positions are its own (``Mesh.processes``).
    Every process must then hold whole data rows, as many as each other
    process: a model group that would span processes raises
    NotImplementedError (A10)."""
    cfg = cfg or MeshConfig()
    if _PROCESSES is not None:
        return _process_mesh(cfg, devices)
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


def _process_mesh(cfg: MeshConfig, devices: Optional[Sequence]) -> Mesh:
    local = [str(_indexed(d)) for d in (devices if devices is not None
                                        else local_devices())]
    flat = [(rank, torch.device(d))
            for rank, names in enumerate(_gathered_objects(local))
            for d in names]
    n = len(flat)
    data, model = cfg.resolve(n)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} "
                         f"devices, have {n} over {process_count()} "
                         f"processes")
    grid = np.empty((data, model), dtype=object)
    procs = np.empty((data, model), dtype=np.int64)
    for i in range(data * model):
        procs.flat[i], grid.flat[i] = flat[i]
    for r in range(data):
        if len(set(procs[r])) > 1:
            raise NotImplementedError(
                f"data row {r} of a {data}x{model} mesh spans processes "
                f"{sorted(set(procs[r].tolist()))}: a model group over "
                f"processes is not ported ({A10})")
    rows = [int((procs[:, 0] == p).sum()) for p in range(process_count())]
    if len(set(rows)) > 1:
        raise ValueError(f"a {data}x{model} mesh gives the processes "
                         f"{rows} data rows: each needs as many as the "
                         f"others (their blocks of a batch are equal)")
    return Mesh(grid, (AXIS_DATA, AXIS_MODEL), processes=procs)


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


def merge_blocks(blocks: Sequence[torch.Tensor], spec) -> torch.Tensor:
    """The inverse of :func:`split_block`: the whole leaf from its ``n``
    blocks under ``spec``, on the first block's device (a replicated spec
    gives the first block)."""
    sp = as_split(spec)
    if sp is None:
        return blocks[0]
    dev = blocks[0].device
    parts = [torch.chunk(to_device(b, dev), sp.halves, dim=sp.dim)
             for b in blocks]
    return torch.cat([torch.cat([p[h] for p in parts], dim=sp.dim)
                      for h in range(sp.halves)], dim=sp.dim)


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


# ---------------------------------------------------------------------------
# Across processes (after init_distributed)
# ---------------------------------------------------------------------------
#
# Every process of a training step computes the same loss from the same
# gathered outputs, so the gradient of a gathered tensor is the same in
# every process: the backward of a gather is this process's own block of
# it, and that of a sum over processes passes the gradient through. What
# each process's parameters got is summed over the processes once, at the
# end (``parallel.tensor.MeshParams.reduce``).

#: The largest flat buffer :func:`process_all_reduce_many` sums in one
#: call (gloo pays per call; a bucket bounds the staging memory).
BUCKET_BYTES = 64 << 20


def block_of(t: torch.Tensor, index: int, count: int,
             dim: int = 0) -> torch.Tensor:
    """Block ``index`` of ``count`` equal blocks of ``t`` along ``dim`` (a
    process's part of a batch split over processes, as ``P("data")``
    splits it); ``t`` itself for one block."""
    if count == 1:
        return t
    if t.shape[dim] % count:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split into {count} processes' blocks")
    return torch.chunk(t, count, dim=dim)[index]


def _staged(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` where it crosses processes (the host for
    gloo, this process's first card for NCCL), counted in the bytes this
    process hands to collectives."""
    buf = t.detach().to(_PROCESSES.stage, copy=True).contiguous()
    _PROCESSES.bytes += buf.numel() * buf.element_size()
    return buf


class _ProcessAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim):
        import torch.distributed as dist

        ctx.dim = dim
        buf = _staged(t)
        parts = [torch.empty_like(buf) for _ in range(_PROCESSES.count)]
        dist.all_gather(parts, buf, group=_PROCESSES.group)
        return torch.cat(parts, dim=dim).to(t.device)

    @staticmethod
    def backward(ctx, g):
        return (torch.chunk(g, _PROCESSES.count, dim=ctx.dim)[
            _PROCESSES.rank].contiguous(), None)


class _ProcessAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        import torch.distributed as dist

        buf = _staged(t)
        dist.all_reduce(buf, group=_PROCESSES.group)
        return buf.to(t.device)

    @staticmethod
    def backward(ctx, g):
        return g


def process_all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) concatenated along ``dim`` in
    rank order, on ``t``'s device; ``t`` in one process. Differentiable:
    the backward is this process's block of the gradient (every process
    computes the same loss)."""
    if process_count() == 1:
        return t
    return _ProcessAllGather.apply(t, dim)


def process_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of every process's ``t``, on ``t``'s device; ``t`` in one
    process. Differentiable: the gradient passes through (every process
    computes the same loss from the sum)."""
    if process_count() == 1:
        return t
    return _ProcessAllReduce.apply(t)


def process_all_reduce_many(tensors: Sequence[torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Each tensor (of one dtype) summed over the processes, not
    differentiable: the tensors flattened into buckets of at most
    :data:`BUCKET_BYTES`, one collective a bucket; each sum on its
    tensor's device."""
    if process_count() == 1:
        return list(tensors)
    import torch.distributed as dist

    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("process_all_reduce_many sums tensors of one "
                         "dtype")
    out: List[torch.Tensor] = []
    bucket: List[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.detach().reshape(-1).to(_PROCESSES.stage)
                          for t in bucket])
        _PROCESSES.bytes += flat.numel() * flat.element_size()
        dist.all_reduce(flat, group=_PROCESSES.group)
        for t, part in zip(bucket, torch.split(
                flat, [t.numel() for t in bucket])):
            out.append(part.reshape(t.shape).to(t.device))
        bucket.clear()

    size = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if bucket and size + nb > BUCKET_BYTES:
            flush()
            size = 0
        bucket.append(t)
        size += nb
    if bucket:
        flush()
    return out


def process_broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Process ``src``'s ``t`` in every process, on ``t``'s device (``t``
    elsewhere gives only the shape and dtype); ``t`` in one process. The
    bytes cross as they are (gloo has no int16, the int16 sample wire's
    dtype)."""
    if process_count() == 1:
        return t
    import torch.distributed as dist

    buf = _staged(t).reshape(-1).view(torch.uint8)
    dist.broadcast(buf, src, group=_PROCESSES.group)
    return buf.view(t.dtype).reshape(t.shape).to(t.device)


def process_broadcast_object(obj, src: int = 0):
    """Process ``src``'s picklable ``obj`` in every process (over the gloo
    group that every process joined); ``obj`` in one process."""
    if process_count() == 1:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def process_barrier() -> None:
    """Wait until every process reaches this call (a no-op in one)."""
    if process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


def process_bytes(reset: bool = False) -> int:
    """The bytes this process has handed to collectives across processes
    since the last reset (0 in one process)."""
    if _PROCESSES is None:
        return 0
    n = _PROCESSES.bytes
    if reset:
        _PROCESSES.bytes = 0
    return n
