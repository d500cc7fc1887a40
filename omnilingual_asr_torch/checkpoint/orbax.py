"""Orbax checkpoint directories, read and written without JAX.

The JAX package's ``models/zoo.py::save_checkpoint`` writes a parameter
tree with Orbax's ``StandardCheckpointer``. The directory holds:

- ``_METADATA``: JSON with ``tree_metadata`` (one entry a leaf, its path as
  ``key_metadata``: ``key_type`` 1 a sequence index, 2 a dict key) and the
  storage flags ``use_ocdbt`` (true) and ``use_zarr3`` (false);
- ``_CHECKPOINT_METADATA``: JSON naming the handler, with timestamps;
- an OCDBT database (``manifest.ocdbt``, ``d/``; Orbax adds per-process
  ones under ``ocdbt.process_0/``) holding each leaf as a zarr v2 array
  named by its path joined with ``.`` (``blocks.0.conv.dw``).

:func:`read_flat` returns ``{tree path: array}``, a tree path a tuple of
dict keys and sequence indices (``("blocks", 0, "w")``); :func:`write_flat`
writes that layout, uncompressed, atomically.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from . import ocdbt, zarr

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_SEQUENCE, _DICT = 1, 2


def is_checkpoint(path) -> bool:
    """True when ``path`` is an Orbax checkpoint directory."""
    return (Path(path) / METADATA).is_file()


def read_metadata(path) -> dict:
    """``_METADATA``, checked for the storage the reader supports."""
    meta = json.loads((Path(path) / METADATA).read_text())
    if meta.get("use_ocdbt") is not True:
        raise ValueError(f"{path}: use_ocdbt is {meta.get('use_ocdbt')!r}; "
                         f"only OCDBT checkpoints are read")
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 is true; only zarr v2 "
                         f"checkpoints are read")
    return meta


def _leaves(meta: dict, path) -> List[tuple]:
    """(tree path, zarr array name) of every stored leaf."""
    out = []
    for entry in meta["tree_metadata"].values():
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue
        parts = []
        for k in entry["key_metadata"]:
            if k["key_type"] == _SEQUENCE:
                parts.append(int(k["key"]))
            elif k["key_type"] == _DICT:
                parts.append(str(k["key"]))
            else:
                raise ValueError(f"{path}: key type {k['key_type']} of "
                                 f"{entry['key_metadata']} is not supported")
        out.append((tuple(parts), ".".join(str(p) for p in parts)))
    return out


def read_flat(path) -> Dict[Tuple, np.ndarray]:
    """Every leaf as ``{tree path: array}`` (bfloat16 widened to float32)."""
    path = Path(path)
    meta = read_metadata(path)
    store = ocdbt.Store(path)
    return {parts: zarr.read_array(store.get, name)
            for parts, name in _leaves(meta, path)}


def write_flat(path, flat: Dict[Tuple, np.ndarray]) -> None:
    """Write ``{tree path: array}`` as an Orbax checkpoint directory,
    replacing any directory at ``path`` (Orbax's ``force=True``) only once
    the new one is complete."""
    path = Path(path)
    tree, entries = {}, {}
    for parts, value in flat.items():
        name = ".".join(str(p) for p in parts)
        tree[str(tuple(str(p) for p in parts))] = {
            "key_metadata": [{"key": str(p), "key_type":
                              _SEQUENCE if isinstance(p, int) else _DICT}
                             for p in parts],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
        entries.update(zarr.array_entries(name, value))
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.tmp-{os.getpid()}-{time.time_ns()}"
    try:
        ocdbt.write_store(tmp, entries)
        (tmp / METADATA).write_text(json.dumps({
            "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}))
        now = time.time_ns()
        (tmp / CHECKPOINT_METADATA).write_text(json.dumps({
            "item_handlers": _HANDLER, "metrics": {},
            "performance_metrics": {}, "init_timestamp_nsecs": now,
            "commit_timestamp_nsecs": now, "custom_metadata": {}}))
        if path.exists():
            old = path.parent / f".{path.name}.old-{os.getpid()}-{now}"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
