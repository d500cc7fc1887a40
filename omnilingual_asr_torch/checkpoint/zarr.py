"""Zarr v2 arrays over a key-value store: what Orbax writes each leaf as.

An array ``name`` is the JSON ``name/.zarray`` (shape, chunk shape, dtype,
compressor, fill value, C order, dimension separator) and one value a chunk,
``name/i.j`` (``.`` or ``/`` between the chunk indices; ``name/0`` for a
0-d array). Every chunk is stored at the full chunk shape, edge chunks
included; a missing chunk reads as the fill value. Orbax compresses chunks
with zstd; :func:`array_entries` writes them uncompressed
(``"compressor": null``).

numpy has no bfloat16: a ``bfloat16`` array is widened to float32 by
shifting its 16 bits up, which is exact.
"""

from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, Optional

import numpy as np

from . import zstd

#: dtype strings written for numpy dtypes (the zarr v2 names Orbax uses)
_NAMES = {np.dtype(np.float32): "<f4", np.dtype(np.float16): "<f2",
          np.dtype(np.float64): "<f8", np.dtype(np.int32): "<i4",
          np.dtype(np.int64): "<i8", np.dtype(np.int8): "|i1",
          np.dtype(np.uint8): "|u1", np.dtype(np.bool_): "|b1"}


def _dtype(name: str) -> np.dtype:
    """The stored dtype of a zarr v2 dtype string (bfloat16 as uint16)."""
    if name == "bfloat16":
        return np.dtype("<u2")
    dt = np.dtype(name)
    if dt.kind not in "fiub":
        raise ValueError(f"zarr: unsupported dtype {name!r}")
    return dt


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):
        named = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in named:
            raise ValueError(f"zarr: fill value {value!r}")
        value = named[value]
    if bf16:
        f32 = np.asarray(value, np.float32).reshape(1).view(np.uint32)
        return int(f32[0] >> 16)
    return np.asarray(value).astype(dtype)


def read_array(get: Callable[[str], Optional[bytes]],
               name: str) -> np.ndarray:
    """Read the array ``name`` through ``get(key) -> bytes | None``.

    bfloat16 comes back as float32; other dtypes as stored, native byte
    order."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"zarr: no array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr {name}: zarr_format "
                         f"{meta.get('zarr_format')!r}, expected 2")
    if meta.get("filters"):
        raise ValueError(f"zarr {name}: filters are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr {name}: compressor {comp.get('id')!r}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr {name}: order {meta['order']!r}")
    sep = meta.get("dimension_separator", ".")
    bf16 = meta["dtype"] == "bfloat16"
    dt = _dtype(meta["dtype"])
    shape = tuple(int(s) for s in meta["shape"])
    chunks = tuple(int(c) for c in meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr {name}: chunks {chunks} for shape {shape}")
    out = np.empty(shape, dt.newbyteorder("="))
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    fill = _fill(meta.get("fill_value"), dt, bf16)
    whole = chunks == shape
    for idx in itertools.product(*[range(g) for g in grid]):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        data = get(key)
        if data is None:
            out[region] = fill
            continue
        if whole and dt.isnative and comp is not None:
            zstd.decompress_into(data, out)   # straight into the result
            continue
        chunk = np.empty(int(np.prod(chunks, dtype=np.int64)), dt)
        if comp is None:
            if len(data) != chunk.nbytes:
                raise ValueError(f"zarr {key}: {len(data)} bytes, a chunk "
                                 f"holds {chunk.nbytes}")
            chunk[:] = np.frombuffer(data, dt)
        else:
            zstd.decompress_into(data, chunk)
        chunk = chunk.reshape(chunks)
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def array_entries(name: str, array: np.ndarray) -> Dict[str, bytes]:
    """The ``.zarray`` and the single chunk of ``array`` as key-value
    entries, uncompressed, in the layout Orbax writes (C order, ``.``
    separator, null fill value)."""
    a = np.asarray(array)
    if a.dtype not in _NAMES:
        raise ValueError(f"zarr {name}: unsupported dtype {a.dtype}")
    a = np.asarray(a, a.dtype.newbyteorder("<"), order="C")
    meta = {"chunks": list(a.shape), "compressor": None,
            "dimension_separator": ".", "dtype": _NAMES[a.dtype],
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}
    chunk = ".".join("0" for _ in a.shape) or "0"
    return {f"{name}/.zarray": json.dumps(meta).encode(),
            f"{name}/{chunk}": a.tobytes()}
