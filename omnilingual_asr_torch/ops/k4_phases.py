"""Per-block phase times of kernel K4 on the card, from ``%globaltimer``.

ncu and nsys do not run on the card's machine, so this builds an
instrumented copy of ``csrc/quant.cu`` into ``_build/k4_phases/``: thread 0
of each block writes the global timer at the phase boundaries below into a
``__device__`` array, read back after the last call of a CUDA-graph replay
(20 calls, as ``chip_smoke.py`` times them). For each of
``card_cases.K4_SHAPES`` it prints one JSON line: the instrumented call's
device ms, and the min / median / max over blocks of each stamp in us from
the pre-pass's first block and of each phase's length:

- pre-pass (``bf16_rows_kernel``): ``pre_start``, ``pre_end`` (its last
  warp's stores);
- product (``q_matmul_kernel``): ``start``, ``waited`` (the pre-pass is
  complete), ``first_chunk`` (landed), ``products`` (the chunk loop done),
  ``staged`` (the tile in shared memory), ``written`` (its stores issued).

Run on the card from the repository root:

    python -m omnilingual_asr_torch.ops.k4_phases

Each text that ``EDITS`` replaces occurs once in the source; a source
without one raises ValueError (``tests/test_torch_conv_quant_sweep.py``
checks them on the CPU). The stamps themselves cost time: compare phases within one run, and
take K4's own time from ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys

from . import cuda_build

MAX_BLOCKS = 4096
STAMPS = ("start", "waited", "first_chunk", "products", "staged", "written")
PHASES = (("wait", "start", "waited"), ("first_chunk", "waited",
                                        "first_chunk"),
          ("chunk_loop", "first_chunk", "products"),
          ("stage", "products", "staged"), ("copy_out", "staged", "written"))

_TIMER = (
    "__device__ unsigned long long k4_stamp[%d][6];\n"
    "__device__ unsigned long long k4_pre[%d][2];\n"
    "__device__ __forceinline__ unsigned long long k4_now() {\n"
    "  unsigned long long t;\n"
    "  asm volatile(\"mov.u64 %%0, %%globaltimer;\" : \"=l\"(t));\n"
    "  return t;\n}\n" % (MAX_BLOCKS, MAX_BLOCKS))
_READ = (
    "\nOMNI_API int omni_k4_stamps(void* k4, void* pre, int reset) {\n"
    "  static unsigned long long zero[%d * 6] = {};\n"
    "  if (reset) {\n"
    "    cudaMemcpyToSymbol(k4_stamp, zero, sizeof(k4_stamp));\n"
    "    return static_cast<int>(\n"
    "        cudaMemcpyToSymbol(k4_pre, zero, sizeof(k4_pre)));\n"
    "  }\n"
    "  cudaMemcpyFromSymbol(k4, k4_stamp, sizeof(k4_stamp));\n"
    "  return static_cast<int>(\n"
    "      cudaMemcpyFromSymbol(pre, k4_pre, sizeof(k4_pre)));\n}\n"
    % MAX_BLOCKS)


def _rec(i: int) -> str:
    return f"  if (k4_rec) k4_stamp[k4_bid][{i}] = k4_now();\n"


_PRE_START = ("  launch_dependents();     // the product may start its weight "
              "loads\n  const long long i =")
_PRE_END = ("  dst[2] = make_uint2(omni::pack_bf16(v0.z, v0.w), "
            "omni::pack_bf16(v1.z, v1.w));\n")
_WAIT = ("  wait_prerequisites();\n#pragma unroll\n"
         "  for (int s = 0; s < K4_STAGES")
_LANDED = ("    __syncthreads();              // chunk s landed; slot (s - 1) "
           "is free\n    if (s + K4_STAGES - 1 < kc) {\n")
_LOOP_END = ("  omni::cp_async_wait<0>();\n  __syncthreads();                "
             "// the staged tile overwrites the ring\n\n  // (acc * scale)")
_STAGED = "  constexpr int V = K4_BN / 4;\n"
_END = ("          *reinterpret_cast<const float4*>(&staged[r * K4_LDO + "
        "c4]);\n  }\n")

# (a text that occurs once in quant.cu, what replaces it)
EDITS = (
    ("namespace {\n", "namespace {\n" + _TIMER),
    (_PRE_START, "  if (threadIdx.x == 0 && blockIdx.x < %d)\n"
     "    k4_pre[blockIdx.x][0] = k4_now();\n" % MAX_BLOCKS + _PRE_START),
    (_PRE_END, _PRE_END
     + "  if ((threadIdx.x & 31) == 0 && blockIdx.x < %d)\n"
     "    atomicMax(&k4_pre[blockIdx.x][1], k4_now());\n" % MAX_BLOCKS),
    ("  const int kc = K / K4_BK;\n",
     "  const int kc = K / K4_BK;\n"
     "  const int k4_bid = blockIdx.x + blockIdx.y * gridDim.x;\n"
     "  const bool k4_rec = tid == 0 && k4_bid < %d;\n" % MAX_BLOCKS
     + _rec(0)),
    (_WAIT, "  wait_prerequisites();\n" + _rec(1)
     + _WAIT[len("  wait_prerequisites();\n"):]),
    (_LANDED, _LANDED.replace("free\n", "free\n    if (s == 0)\n  "
                              + _rec(2), 1)),
    (_LOOP_END, _rec(3) + _LOOP_END),
    (_STAGED, _rec(4) + _STAGED),
    (_END, _END + _rec(5)),
)


def instrument(text: str) -> str:
    """``quant.cu``'s text with K4's stamps and the ``omni_k4_stamps``
    entry point."""
    for old, new in EDITS:
        if text.count(old) != 1:
            raise ValueError(f"quant.cu does not hold {old!r} once")
        text = text.replace(old, new)
    return text + _READ


def _stats(values):
    import numpy as np

    return [round(float(np.percentile(values, p)), 3) for p in (0, 50, 100)]


def main() -> int:
    import numpy as np
    import torch

    from .card_cases import K4_SHAPES
    from .conv_quant_sweep import QuantCase
    from .sweep import device_ms

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    out = cuda_build.BUILD_ROOT / "k4_phases"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for p in cuda_build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(p, out)
    shutil.copy(cuda_build.CSRC_DIR / "common.cu", out)
    (out / "quant.cu").write_text(
        instrument((cuda_build.CSRC_DIR / "quant.cu").read_text()))
    lib = cuda_build.load(cuda_build.build(out).lib_path)
    lib.omni_k4_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int]
    dev = torch.device("cuda", 0)
    for i, (name, shape) in enumerate(K4_SHAPES.items()):
        case = QuantCase(dev, *shape, seed=20 + i, mode="w8")
        stamps = np.zeros((MAX_BLOCKS, 6), np.uint64)
        pre = np.zeros((MAX_BLOCKS, 2), np.uint64)
        cuda_build.check(lib.omni_k4_stamps(None, None, 1), "reset")
        ms = device_ms(lambda: case.launch(lib))
        torch.cuda.synchronize()
        cuda_build.check(lib.omni_k4_stamps(stamps.ctypes.data,
                                            pre.ctypes.data, 0), "stamps")
        k = stamps[stamps[:, 0] > 0].astype(np.int64)
        p = pre[pre[:, 0] > 0].astype(np.int64)
        t0 = p[:, 0].min()
        row = {"case": name, "ms_instrumented": ms, "blocks": len(k),
               "pre_blocks": len(p),
               "pre_start": _stats((p[:, 0] - t0) / 1e3),
               "pre_end": _stats((p[:, 1] - t0) / 1e3)}
        row.update({s: _stats((k[:, j] - t0) / 1e3)
                    for j, s in enumerate(STAMPS)})
        row.update({f"{ph}_us": _stats((k[:, STAMPS.index(b)]
                                        - k[:, STAMPS.index(a)]) / 1e3)
                    for ph, a, b in PHASES})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
