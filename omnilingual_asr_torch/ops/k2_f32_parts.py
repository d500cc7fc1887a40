"""What each part of the f32 kernel K2 costs on the card.

ncu and nsys do not run on the card's machine, so this builds copies of
``csrc/attention_f32.cu`` into ``_build/k2_f32_parts/``, each with one part
of the forward (``flash_fwd_tf32_kernel``) taken out, and times each copy's
forward as ``chip_smoke.py`` times the kernel (device ms of one call, 20
calls in one CUDA graph) at every shape of ``card_cases.F32_FLASH_SHAPES``.
A copy without a part computes a wrong result by design: the time it saves
is what that part costs, with the rest of the kernel as it is. The parts:

- ``scores``: S = Q K^T (its products, loads and splits of Q);
- ``softmax``: the online softmax, O's rescale included;
- ``rescale``: O times alpha alone;
- ``pv``: O += P V (P's split, V's loads, the products);
- ``two_products``: two of each three TF32 products (a_lo b_hi and
  a_hi b_hi; the copy's K6 and K7 lose them too, and are not timed);
- ``split``: the split of each streamed K and V tile into (hi, lo);
- ``next_loads``: the copies of every streamed tile after the first.

Run on the card from the repository root (about a minute; run it after
``chip_smoke.py`` in a call, or that script's build is cached and prints
no registers):

    python -m omnilingual_asr_torch.ops.k2_f32_parts

Each text that ``EDITS`` replaces occurs once in the source; a source
without one raises ValueError (``tests/test_torch_flash_bwd_sweep.py``
checks them on the CPU). It prints the card's line, then one JSON line a
copy: its registers and spills and its device ms by shape.
"""

from __future__ import annotations

import json
import math
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

from . import cuda_build, sweep
from .card_cases import F32_FLASH_SHAPES

SOURCE = "attention_f32.cu"

# Part -> (text, replacement) pairs, each text once in the source. A part
# whose result later code reads keeps one value of it live, so that the
# compiler drops only the part.
EDITS = {
    "scores": (("  scores_tf32<D, NS, MT>(s, q, ksplit, L);\n",
                "  zero<NS>(s[0]);\n"
                "  s[0][0][0] = __uint_as_float(ksplit[L.brow[0]]);\n"
                "  q[0].load(0, L);\n"
                "  s[0][NS - 1][3] = __uint_as_float(q[0].hi[0]);\n"
                "  for (int mt = 1; mt < MT; ++mt) zero<NS>(s[mt]);\n"),),
    "softmax": (("  bool valid[NS][2];\n",
                 "  if (ms[0] == 12345) {\n  bool valid[NS][2];\n"),
                ("  pv_tf32<D, NS, MT>(acc, s, vsplit, L);\n",
                 "  }\n  pv_tf32<D, NS, MT>(acc, s, vsplit, L);\n")),
    "rescale": (("    if (__any_sync(0xffffffffu, alpha[0] != 1.f || "
                 "alpha[1] != 1.f)) {\n",
                 "    if (ms[0] == 12345) {\n"),),
    "pv": (("  pv_tf32<D, NS, MT>(acc, s, vsplit, L);\n",
            "  acc[0][0][0] += s[0][0][0] + s[MT - 1][NS - 1][3] +\n"
            "                  __uint_as_float(vsplit[L.brow[0]]);\n"),),
    "two_products": (("#pragma unroll\n"
                      "  for (int n = 0; n < N; ++n)\n"
                      "    omni::mma_tf32_1688(part[n], al, bh[n][0], "
                      "bh[n][1]);\n"
                      "#pragma unroll\n"
                      "  for (int n = 0; n < N; ++n)\n"
                      "    omni::mma_tf32_1688(part[n], ah, bh[n][0], "
                      "bh[n][1]);\n", ""),),
    "split": (("      split_tile<BN, D, NT>(Ksp, Kst, tid);\n"
               "      split_tile<BN, D, NT>(Vsp, Vst, tid);\n", ""),),
    "next_loads": (("      load_tile<BN, D, false, NT>(Kst, k + base, ts, "
                    "(j + 1) * BN, T, tid);\n"
                    "      load_tile<BN, D, false, NT>(Vst, v + base, ts, "
                    "(j + 1) * BN, T, tid);\n", ""),),
}


def edit(text: str, part: str) -> str:
    """``text`` (the source) with ``part`` taken out of the forward."""
    for old, new in EDITS[part]:
        if text.count(old) != 1:
            raise ValueError(f"{SOURCE} does not hold {old!r} once "
                             f"(part {part})")
        text = text.replace(old, new)
    return text


def build(part: str) -> cuda_build.BuildInfo:
    """common.cu, the headers and the source without ``part`` (``None``:
    the source as it is), built in ``_build/k2_f32_parts/<part>``."""
    text = (cuda_build.CSRC_DIR / SOURCE).read_text()
    out = cuda_build.BUILD_ROOT / "k2_f32_parts" / (part or "source")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for p in cuda_build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(p, out)
    shutil.copy(cuda_build.CSRC_DIR / "common.cu", out)
    (out / SOURCE).write_text(text if part is None else edit(text, part))
    return cuda_build.build(out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(sweep.card_line(), flush=True)
    parts = [None, *EDITS]
    with ThreadPoolExecutor(len(parts)) as pool:
        builds = list(pool.map(build, parts))
    cases = {}
    for i, (name, (B, T, H, D, valid)) in enumerate(
            F32_FLASH_SHAPES.items()):
        gen = torch.Generator(device=dev).manual_seed(i)
        q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   for _ in range(3))
        mask = (torch.arange(T, device=dev)[None]
                < torch.tensor(valid, device=dev)[:, None]).to(torch.int32)
        # q, k, v, mask in; o, lse out (kept alive with their pointers).
        tensors = (q, k, v, mask, torch.empty_like(q),
                   torch.empty(B, H, T, device=dev))
        cases[name] = (tensors, (B, T, H, D, 1.0 / math.sqrt(D)))
    for part, info in zip(parts, builds):
        lib = cuda_build.load(info.lib_path)
        row = {"without": part, "ptxas": [
            k for k in info.kernels() if k[0].startswith(
                "flash_fwd_tf32_kernel")], "ms": {}}
        for name, (tensors, dims) in cases.items():
            def call(ptrs=[t.data_ptr() for t in tensors], dims=dims):
                cuda_build.check(lib.omni_flash_fwd_f32(
                    *ptrs, *dims, torch.cuda.current_stream().cuda_stream),
                    "omni_flash_fwd_f32")
            row["ms"][name] = sweep.device_ms(call)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
