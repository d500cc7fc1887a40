"""Device mesh and the distributed strategies without tensor parallelism:
sequence parallelism (ring attention, halo exchange), expert parallelism
(all-to-all dispatch) and pipeline stages, over a single-controller mesh."""

from .mesh import build_mesh, init_distributed, shard_params  # noqa: F401
