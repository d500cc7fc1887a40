"""Zstandard decoding through the system's libzstd, and CRC-32C.

libzstd (``libzstd.so.1``) is the reference implementation of RFC 8878;
Debian's ``dpkg`` pre-depends on it, so Debian-based systems carry it. This
module binds the few functions it needs with ``ctypes`` and loads the
library the first time it is needed; importing it loads nothing. There is
no fallback: where the library cannot be loaded, every decode raises
:class:`LibraryNotFound`.

Corrupt input (a bad magic, a truncated frame, a checksum mismatch, output
beyond the declared size) raises ``ValueError`` with libzstd's message.

CRC-32C (Castagnoli), which OCDBT stamps on every manifest and node (a few
KB each), is computed here in Python.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

#: Refuse to allocate more than this for one call's output.
MAX_OUTPUT_BYTES = 1 << 36
_UNKNOWN = (1 << 64) - 1           # ZSTD_CONTENTSIZE_UNKNOWN
_ERROR = (1 << 64) - 2             # ZSTD_CONTENTSIZE_ERROR

_RESET_SESSION = 1                 # ZSTD_reset_session_only

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: one decoding context, reused (its buffers outlive a call, so small
#: frames do not pay for allocating them), one decode at a time
_dctx_lock = threading.Lock()
_dctx_ptr: Optional[int] = None


class LibraryNotFound(RuntimeError):
    """libzstd could not be loaded."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            name = ctypes.util.find_library("zstd") or "libzstd.so.1"
            try:
                lib = ctypes.CDLL(name)
            except OSError as e:
                raise LibraryNotFound(f"libzstd ({name}) could not be "
                                      f"loaded: {e}") from e
            vp, size = ctypes.c_void_p, ctypes.c_size_t
            for fn, res, args in (
                    ("ZSTD_isError", ctypes.c_uint, [size]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size]),
                    ("ZSTD_findDecompressedSize", ctypes.c_ulonglong,
                     [vp, size]),
                    ("ZSTD_createDCtx", vp, []),
                    ("ZSTD_DCtx_reset", size, [vp, ctypes.c_int]),
                    ("ZSTD_decompressDCtx", size, [vp, vp, size, vp, size]),
                    ("ZSTD_decompressStream", size,
                     [vp, ctypes.POINTER(_OutBuffer),
                      ctypes.POINTER(_InBuffer)]),
                    ("ZSTD_DStreamOutSize", size, [])):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _lib = lib
    return _lib


def _view(data) -> np.ndarray:
    """A contiguous uint8 view of ``data`` (bytes, bytearray, memoryview or
    a numpy array), without a copy where the input allows it."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def _dctx(lib):
    """The shared decoding context, reset; call with ``_dctx_lock`` held."""
    global _dctx_ptr
    if _dctx_ptr is None:
        _dctx_ptr = lib.ZSTD_createDCtx()
        if not _dctx_ptr:
            _dctx_ptr = None
            raise MemoryError("zstd: ZSTD_createDCtx failed")
    _check(lib, lib.ZSTD_DCtx_reset(_dctx_ptr, _RESET_SESSION))
    return _dctx_ptr


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def content_size(data) -> Optional[int]:
    """The total content size the frames of ``data`` declare; None when a
    frame declares none."""
    lib = _load()
    src = _view(data)
    n = lib.ZSTD_findDecompressedSize(src.ctypes.data, src.size)
    if n == _ERROR:
        raise ValueError("zstd: not a sequence of zstd frames")
    return None if n == _UNKNOWN else int(n)


def decompress(data) -> bytes:
    """Decode every frame of ``data`` (skippable frames skipped)."""
    src = _view(data)
    n = content_size(src)
    if n is None:
        return _stream(_load(), src)
    if n > MAX_OUTPUT_BYTES:
        raise ValueError(f"zstd: frames declare {n} bytes, more than the "
                         f"limit of {MAX_OUTPUT_BYTES}")
    out = np.empty(n, np.uint8)
    decompress_into(src, out)
    return out.tobytes()


def _stream(lib, src: np.ndarray) -> bytes:
    """Decode frames that declare no content size, growing the output."""
    inb = _InBuffer(src.ctypes.data, src.size, 0)
    out = np.empty(max(int(lib.ZSTD_DStreamOutSize()), 4 * src.size),
                   np.uint8)
    total = 0
    with _dctx_lock:
        dctx = _dctx(lib)
        while True:
            if total == out.size:
                if out.size >= MAX_OUTPUT_BYTES:
                    raise ValueError(f"zstd: output beyond the limit of "
                                     f"{MAX_OUTPUT_BYTES} bytes")
                out = np.concatenate([out, np.empty_like(out)])
            outb = _OutBuffer(out.ctypes.data + total, out.size - total, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                dctx, ctypes.byref(outb), ctypes.byref(inb)))
            total += outb.pos
            if inb.pos == inb.size:
                if not left:             # the last frame ended and flushed
                    return out[:total].tobytes()
                if outb.pos < outb.size:
                    raise ValueError("zstd: truncated frame")


def decompress_into(data, out: np.ndarray) -> None:
    """Decode ``data`` into the contiguous array ``out``, which it must fill
    exactly (ValueError otherwise)."""
    lib = _load()
    src = _view(data)
    if not out.flags.c_contiguous:
        raise ValueError("zstd: the destination must be contiguous")
    with _dctx_lock:
        n = _check(lib, lib.ZSTD_decompressDCtx(
            _dctx(lib), out.ctypes.data, out.nbytes, src.ctypes.data,
            src.size))
    if n != out.nbytes:
        raise ValueError(f"zstd: decoded {n} bytes, the destination holds "
                         f"{out.nbytes}")


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    table = _CRC32C
    crc ^= 0xFFFFFFFF
    for b in memoryview(_view(data)):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
