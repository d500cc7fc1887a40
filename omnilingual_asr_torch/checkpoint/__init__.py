"""Orbax checkpoints without JAX: zstd through the system's libzstd
(``zstd``), an OCDBT key-value reader (``ocdbt``), zarr v2 arrays
(``zarr``) and the checkpoint directory layout the JAX package writes
(``orbax``)."""
