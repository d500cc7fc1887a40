"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object file (one ``nvcc`` process per source, all started together), and the
objects are linked into one shared library with a plain C interface, which
is loaded with ``ctypes``. Nothing includes PyTorch's headers, so a cold
build takes seconds.

The build happens at first use, into ``omnilingual_asr_torch/_build/<hash>/``
(listed in ``.gitignore``), keyed by a hash of the sources and flags; a later
process with the same sources loads the cached library. Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libomniasr_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600


@dataclass
class BuildInfo:
    """What one call of :func:`build` did."""

    lib_path: Path
    seconds: float
    cached: bool
    ptxas_log: str


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources() + _headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels (or find the cached build); returns BuildInfo."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0, True, "")
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for src in sources():
            obj = out_dir / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC_DIR),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, p in procs:
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
            logs.append(f"--- {src.name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=BUILD_TIMEOUT_S)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return BuildInfo(lib, time.perf_counter() - t0, False, "\n".join(logs))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argument types (every entry returns the
# cudaError_t of its launch as an int).
_SIGNATURES = {
    # frames, cw, sw, fb, out, n_frames, n_fft, n_bins, n_mels, floor, stream
    "omni_log_mel": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, o, lse, B, T, H, D, scale, stream
    "omni_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, dO, lse, delta, dq, B, T, H, D, scale, stream
    "omni_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, dO, lse, delta, dk, dv, B, T, H, D, scale, stream
    "omni_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _F, _P],
    # x, mask, ln_s, ln_b, pw1, dw, dwln_s, dwln_b, pw2, out, B, T, D, K,
    # stream
    "omni_conv_module": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P],
    # x, w_t, scale, bias (or NULL), out, M, N, K, stream
    "omni_q_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "omni_q8a8_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().lib_path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            lib.omni_error_string.argtypes = [_I]
            lib.omni_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().omni_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(t, name: str, dtype, shape=None, device=None) -> None:
    """Validate one kernel argument before its pointer goes to C."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
