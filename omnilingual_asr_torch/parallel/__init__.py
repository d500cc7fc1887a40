"""Device mesh and the distributed strategies over a single-controller
mesh: sequence parallelism (ring attention, halo exchange), expert
parallelism (all-to-all dispatch), pipeline stages and tensor parallelism
(column- and row-parallel layers, ``parallel/tensor.py``)."""

from .mesh import build_mesh, init_distributed, shard_params  # noqa: F401
