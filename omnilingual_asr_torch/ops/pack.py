"""One-buffer device-to-host wire for a batch's outputs.

The PyTorch port of ``omnilingual_asr_tpu/ops/pack.py``. The engine's
per-batch program returns a dict of seven or more small tensors; copied
one by one, each is a device-to-host transfer of its own. With
``decode.wire_pack`` the dict is flattened on the device into one uint8
buffer (byte views of every leaf, sorted by key, bools as one byte), the
buffer comes back in one copy, and the host rebuilds the dict from a
layout fixed once per engine build. The bytes are the leaves' own, so
nothing changes in the result.

A bf16 leaf has no numpy dtype here (no ``ml_dtypes``): it is unpacked
through ``torch.bfloat16`` and given to the host widened to float32, the
exact values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["pack_tree", "layout_of", "unpack_buffer"]

_NUMPY = {torch.bool: np.dtype(np.bool_), torch.uint8: np.dtype(np.uint8),
          torch.int8: np.dtype(np.int8), torch.int16: np.dtype(np.int16),
          torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
          torch.float16: np.dtype(np.float16),
          torch.float32: np.dtype(np.float32),
          torch.float64: np.dtype(np.float64)}

Layout = List[Tuple[str, object, Tuple[int, ...], int, int]]


def _as_u8(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor (a bool as one byte)."""
    x = x.contiguous().reshape(-1)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x.view(torch.uint8)


def pack_tree(ret: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every leaf, sorted by key, in one flat uint8 tensor on the leaves'
    device (the order of :func:`layout_of`)."""
    return torch.cat([_as_u8(ret[k]) for k in sorted(ret)])


def _dtype_of(dt):
    """A leaf's dtype in the layout: the numpy dtype, or
    ``torch.bfloat16`` (numpy has none)."""
    if isinstance(dt, torch.dtype):
        if dt is torch.bfloat16:
            return dt
        return _NUMPY[dt]
    return np.dtype(dt)


def layout_of(spec) -> Layout:
    """[(name, dtype, shape, byte offset, n bytes)] in pack order for a
    dict of tensors or of (dtype, shape) pairs; dtype as
    :func:`_dtype_of` gives it."""
    out = []
    off = 0
    for k in sorted(spec):
        v = spec[k]
        dt, shape = ((v.dtype, tuple(v.shape)) if hasattr(v, "dtype")
                     else (v[0], tuple(v[1])))
        dt = _dtype_of(dt)
        itemsize = 2 if dt is torch.bfloat16 else dt.itemsize
        nb = int(np.prod(shape, dtype=np.int64)) * itemsize
        out.append((k, dt, shape, off, nb))
        off += nb
    return out


def unpack_buffer(buf: np.ndarray, layout: Layout) -> Dict[str, np.ndarray]:
    """The output dict from a packed host buffer (views where the
    alignment allows; bools re-widened from their bytes, bf16 widened to
    float32)."""
    buf = np.ascontiguousarray(buf)
    out: Dict[str, np.ndarray] = {}
    for name, dt, shape, off, nb in layout:
        raw = buf[off:off + nb]
        if dt is torch.bfloat16:
            arr = torch.from_numpy(raw.copy()).view(torch.bfloat16).to(
                torch.float32).numpy()
        elif dt == np.bool_:
            arr = raw.view(np.uint8).astype(np.bool_)
        else:
            arr = raw.view(dt)
        out[name] = arr.reshape(shape)
    return out
