"""ctypes loader (and on-demand build) of the native C++ ``omniaudio``
decoder library.

The PyTorch port's own copy of ``omnilingual_asr_tpu/audio/native_lib.py``
(the port imports nothing of the JAX package), building from the port's own
``audio/native/omniaudio.cpp``. The C ABI is deliberately tiny:

    int32_t omniaudio_decode(const char* path, float** out, int64_t* n, int32_t* sr);
    int32_t omniaudio_decode_rate(const char* path, int32_t target_sr, ...);
    void    omniaudio_free(float* p);
    double  omniaudio_duration(const char* path);

The library is built with ``g++`` the first time it is needed, into
``omnilingual_asr_torch/_build/omniaudio-<hash>/`` (listed in
``.gitignore``), keyed by a hash of the source and the machine; nothing is
written beside the source. The flags are tried in the JAX loader's order:
``-march=native`` with libav (when the libavformat/libavcodec/libswresample
headers exist), then without ``-march=native``, then a WAV-only build. When
no build succeeds, or ``OMNIASR_DISABLE_NATIVE`` is set, the callers fall
back to the pure-Python decoders in ``decode.py``. Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "native" / "omniaudio.cpp"
BUILD_ROOT = PKG_DIR / "_build"
LIB_NAME = "libomniaudio.so"
BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional["NativeBuild"] = None
_tried = False


@dataclass
class NativeBuild:
    """What building (or finding) the library did."""

    lib_path: Path
    seconds: float
    cached: bool
    flags: List[str]

    @property
    def libav(self) -> bool:
        """True when the build links libav (MP3/FLAC/OGG/M4A and native
        resampling); False for the WAV-only build."""
        return "-DOMNIAUDIO_WITH_LIBAV" in self.flags


def _libav_flags() -> list:
    """Compile against system libavformat/libavcodec/libswresample when the
    dev headers exist (in-process replacement for the reference's ffmpeg
    subprocess, covering MP3/FLAC/OGG/M4A/AAC)."""
    for inc in ("/usr/include", "/usr/include/x86_64-linux-gnu"):
        if (Path(inc) / "libavcodec" / "avcodec.h").exists():
            return ["-DOMNIAUDIO_WITH_LIBAV", f"-I{inc}",
                    "-lavformat", "-lavcodec", "-lavutil", "-lswresample"]
    return []


def _flag_chain() -> List[List[str]]:
    libav = _libav_flags()
    chain = [["-march=native", *libav], libav]
    if libav:
        chain.append([])           # no system codecs: WAV-only build
    return chain


def build_dir() -> Path:
    """The build directory of this source on this machine."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(json.dumps([BASE_FLAGS, _flag_chain(), platform.machine(),
                         platform.node()]).encode())
    return BUILD_ROOT / f"omniaudio-{h.hexdigest()[:16]}"


def build() -> Optional[NativeBuild]:
    """Compile ``omniaudio.cpp`` (or find the cached build); None when no
    flag set of the chain compiles."""
    out_dir = build_dir()
    lib, meta = out_dir / LIB_NAME, out_dir / "build.json"
    if lib.is_file() and meta.is_file():
        return NativeBuild(lib, 0.0, True, json.loads(meta.read_text()))
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        for extra in _flag_chain():
            cmd = ["g++", *BASE_FLAGS, "-o", str(tmp), str(SOURCE), *extra]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            if proc.returncode == 0 and tmp.is_file():
                meta_tmp = meta.with_suffix(f".{os.getpid()}.tmp")
                meta_tmp.write_text(json.dumps(extra))
                os.replace(meta_tmp, meta)
                os.replace(tmp, lib)   # atomic: a loader sees all or nothing
                return NativeBuild(lib, time.perf_counter() - t0, False,
                                   extra)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        tmp.unlink(missing_ok=True)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _info, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.getenv("OMNIASR_DISABLE_NATIVE"):
            return None
        info = build()
        if info is None:
            return None
        try:
            lib = ctypes.CDLL(str(info.lib_path))
        except OSError:
            return None
        out_args = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.omniaudio_decode.restype = ctypes.c_int32
        lib.omniaudio_decode.argtypes = [ctypes.c_char_p, *out_args]
        lib.omniaudio_decode_rate.restype = ctypes.c_int32
        lib.omniaudio_decode_rate.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, *out_args]
        lib.omniaudio_free.restype = None
        lib.omniaudio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.omniaudio_duration.restype = ctypes.c_double
        lib.omniaudio_duration.argtypes = [ctypes.c_char_p]
        _lib, _info = lib, info
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_build() -> Optional[NativeBuild]:
    """The loaded library's build (building it if needed); None when the
    library is unavailable."""
    _load()
    return _info


def native_decode(path: Path,
                  target_sr: int = 0) -> Optional[Tuple[np.ndarray, int]]:
    """Decode via the native library; None if unsupported/failed.

    target_sr > 0 also resamples in native code (libswresample). The
    WAV-only build ignores it and returns the file's own rate."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64(0)
    sr = ctypes.c_int32(0)
    rc = lib.omniaudio_decode_rate(str(path).encode(), int(target_sr),
                                   ctypes.byref(out), ctypes.byref(n),
                                   ctypes.byref(sr))
    if rc != 0 or n.value <= 0 or not out:
        return None
    try:
        buf = np.ctypeslib.as_array(out, shape=(n.value,))
        samples = np.array(buf, dtype=np.float32, copy=True)
    finally:
        lib.omniaudio_free(out)
    return samples, int(sr.value)


def native_duration(path: Path) -> Optional[float]:
    lib = _load()
    if lib is None:
        return None
    d = lib.omniaudio_duration(str(path).encode())
    return float(d) if d > 0 else None
