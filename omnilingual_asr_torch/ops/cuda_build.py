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
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

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

    def kernels(self) -> List[Tuple[str, int, str]]:
        """(kernel, registers, spill line) for each entry function in
        ptxas's log (empty for a cached build)."""
        out, name, spills = [], None, ""
        for line in self.ptxas_log.splitlines():
            entry = re.search(r"(?:Compiling entry function|Function "
                              r"properties for) '?(\w+)", line)
            if entry:
                name = kernel_name(entry[1])
            elif "spill stores" in line:
                spills = line.strip()
            elif name and (used := re.search(r"Used (\d+) registers", line)):
                out.append((name, int(used[1]), spills))
                name = None
        return out


def kernel_name(mangled: str) -> str:
    """``name``, ``name<D>`` or ``name<D, flag>`` of a kernel from its
    mangled symbol: the length-prefixed identifier that ends in
    ``_kernel``, and its int and bool template arguments."""
    if "_kernel" not in mangled:
        return mangled
    end = mangled.find("_kernel") + len("_kernel")
    for start in range(end - 1, 0, -1):
        digits = re.search(r"\d+$", mangled[:start])
        if digits and any(int(digits[0][-k:]) == end - start
                          for k in range(1, len(digits[0]) + 1)):
            args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
            if not args:
                return mangled[start:end]
            vals = [v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(\d+)E", args[1])]
            return mangled[start:end] + f"<{', '.join(vals)}>"
    return mangled


def sources(csrc: Path = CSRC_DIR) -> List[Path]:
    return sorted(csrc.glob("*.cu"))


def _headers(csrc: Path) -> List[Path]:
    return sorted(csrc.glob("*.cuh"))


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source: not a transient fault,
    so the engine never re-dispatches a batch that raised it."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def source_hash(csrc: Path = CSRC_DIR) -> str:
    h = hashlib.sha256()
    for p in sources(csrc) + _headers(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC_DIR) -> BuildInfo:
    """Compile the kernels of ``csrc`` (or find the cached build); returns
    BuildInfo."""
    out_dir = BUILD_ROOT / source_hash(csrc)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildInfo(lib, 0.0, True, "")
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for src in sources(csrc):
            obj = out_dir / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(csrc),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, p in procs:
            out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
            logs.append(f"--- {src.name}\n{out}")
            if p.returncode != 0:
                raise KernelBuildError(f"nvcc failed on {src.name}:\n{out}")
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
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    return BuildInfo(lib, time.perf_counter() - t0, False, "\n".join(logs))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argument types (every entry returns the
# cudaError_t of its launch as an int).
_SIGNATURES = {
    # frames, window, n_win, twiddles, fb, bands, n_weights, out, n_frames,
    # n_fft, n_mels, floor, stream
    "omni_log_mel": [_P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _F, _P],
    # q, k, v, mask, o, lse, B, T, H, D, scale, stream
    "omni_flash_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, dO, lse, delta, dq, B, T, H, D, scale, stream
    "omni_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _P],
    # q, k, v, mask, dO, lse, delta, dk, dv, B, T, H, D, scale, stream
    "omni_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _F, _P],
    # the f32 variants (csrc/attention_f32.cu), the same arguments
    "omni_flash_fwd_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "omni_flash_bwd_dq_f32": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _F, _P],
    "omni_flash_bwd_dkv_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _F, _P],
    # the f16 variants (csrc/attention.cu, csrc/attention_bwd.cu), the
    # same arguments
    "omni_flash_fwd_f16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "omni_flash_bwd_dq_f16": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _F, _P],
    "omni_flash_bwd_dkv_f16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _F, _P],
    # x, mask, ln_s, ln_b, pw1, dw, dwln_s, dwln_b, pw2, scratch, out, B,
    # T, D, K, stream
    "omni_conv_module": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _P],
    # B, T, D, plan (int[6])
    "omni_conv_module_plan": [_I, _I, _I, _P],
    # the split over channels, a shard's steps:
    # x, mask, ln_s, ln_b, pw1, dw, scratch, c, stats, B, T, D, DL, K,
    # stream
    "omni_conv_split_stage1": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P],
    # c, stats, n, dwln_s, dwln_b, a, M, DL, D, stream
    "omni_conv_split_finish": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    # a, pw2, out, M, DL, D, stream
    "omni_conv_split_stage2": [_P, _P, _P, _I, _I, _I, _P],
    # B, T, D, DL, plan (int[6])
    "omni_conv_split_plan": [_I, _I, _I, _I, _P],
    # x, w_t, scale, bias (or NULL), out, scratch, M, N, K, stream
    "omni_q_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, w_t, scale, bias (or NULL), out, scratch, M, N, K, stream
    "omni_q8a8_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load(lib_path: Path) -> ctypes.CDLL:
    """A built kernel library, its C entry points typed (a library built
    from some of the sources, as the sweeps build, has only theirs)."""
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = _I
    lib.omni_error_string.argtypes = [_I]
    lib.omni_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build().lib_path)
        return _lib


def plan(entry: str, *dims: int, lib: Optional[ctypes.CDLL] = None
         ) -> List[int]:
    """The launch plan a kernel's ``*_plan`` entry reports for ``dims``
    (its grid and tiles; see the C source), from ``lib`` or the loaded
    library."""
    out = (ctypes.c_int * 6)()
    check(getattr(lib or library(), entry)(*dims, out), entry)
    return list(out)


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
