"""Time kernels K6 and K7 on the card at each choice of their launch bounds.

For each choice of the minimum blocks an SM in the ``__launch_bounds__`` of
``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``
(``csrc/attention_bwd.cu``; the source's own choice first), builds the
kernels with that choice into a library of its own under ``_build/``,
prints each kernel's registers and spills, checks K6 and K7 against their
plain versions (chip_smoke.py's tolerance) and times them as chip_smoke.py
does (device ms of one call, 20 calls in one CUDA graph) at the training
shape [16, 256, 8, 64] and at large_config's [4, 768, 8, 128]. Run on the
card from the repository root, before anything else has built the same
sources (a cached build prints no registers):

    python -m omnilingual_asr_torch.ops.flash_bwd_sweep 3,2,3,3 2,1,2,1

each argument giving K6 at D 64, K6 at D 128, K7 at D 64, K7 at D 128.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import attention, cuda_build

KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
BOUNDS = re.compile(r"__launch_bounds__\(THREADS, D == 128 \? (\d+) : (\d+)\)"
                    r"\n(flash_bwd_dq_kernel|flash_bwd_dkv_kernel)\(")
# (B, T, H, D, valid keys): chip_smoke.py's training and head-dim-128 cases.
SHAPES = {"train": (16, 256, 8, 64, [256] * 12 + [200, 77, 1, 0]),
          "d128": (4, 768, 8, 128, [768, 700, 300, 0])}


def source_bounds(text: str) -> tuple:
    """(K6 D 64, K6 D 128, K7 D 64, K7 D 128) as ``text`` has them."""
    got = {m[3]: (int(m[2]), int(m[1])) for m in BOUNDS.finditer(text)}
    return tuple(b for name in KERNELS for b in got[name])


def variant_dir(blocks: tuple):
    """A copy of csrc/ with the launch bounds set to ``blocks``."""
    want = dict(zip(KERNELS, (blocks[:2], blocks[2:])))

    def repl(m):
        b64, b128 = want[m[3]]
        return (f"__launch_bounds__(THREADS, D == 128 ? {b128} : {b64})"
                f"\n{m[3]}(")

    text, n = BOUNDS.subn(
        repl, (cuda_build.CSRC_DIR / "attention_bwd.cu").read_text())
    assert n == 2, n
    out = cuda_build.BUILD_ROOT / "sweep" / "_".join(map(str, blocks))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, out)
    (out / "attention_bwd.cu").write_text(text)
    return out


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median device ms of one ``fn()`` over ``reps`` replays of a CUDA
    graph of ``n`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


class Case:
    """Seeded inputs of one shape, the plain versions' gradients, and
    launches of a library's K6 and K7 into fixed outputs."""

    def __init__(self, dev, B, T, H, D, valid, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        mask = torch.arange(T, device=dev)[None] < torch.tensor(
            valid, device=dev)[:, None]
        o, lse = attention.flash_attention(q, k, v, mask)
        args = (q, k, v, mask, do, lse, attention.flash_delta(o, do))
        self.want = (attention.flash_attention_bwd_dq_plain(*args),
                     *attention.flash_attention_bwd_dkv_plain(*args))
        self.got = tuple(torch.empty_like(q) for _ in range(3))
        self.inputs = (q, k, v, mask.to(torch.int32), do, *args[5:])
        self.ptrs = [t.data_ptr() for t in self.inputs]
        self.dims = (B, T, H, D, 1.0 / math.sqrt(D))

    def k6(self, lib):
        cuda_build.check(lib.omni_flash_bwd_dq(
            *self.ptrs, self.got[0].data_ptr(), *self.dims,
            torch.cuda.current_stream().cuda_stream), "K6")

    def k7(self, lib):
        cuda_build.check(lib.omni_flash_bwd_dkv(
            *self.ptrs, self.got[1].data_ptr(), self.got[2].data_ptr(),
            *self.dims, torch.cuda.current_stream().cuda_stream), "K7")

    def correct(self) -> bool:
        torch.cuda.synchronize()
        for got, want in zip(self.got, self.want):
            got, want = got.float(), want.float()
            tol = 2.0 ** -10 * want.abs().max() + 2.0 ** -7 * want.abs()
            if not bool(((got - want).abs() <= tol).all()):
                return False
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("blocks", nargs="*",
                    help="K6@64,K6@128,K7@64,K7@128 minimum blocks an SM")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    choices = [source_bounds(
        (cuda_build.CSRC_DIR / "attention_bwd.cu").read_text())]
    for b in args.blocks:
        if tuple(map(int, b.split(","))) not in choices:
            choices.append(tuple(map(int, b.split(","))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(choices)) as pool:
        builds = list(pool.map(lambda b: cuda_build.build(variant_dir(b)),
                               choices))
    cases = {name: Case(dev, *shape, seed=i)
             for i, (name, shape) in enumerate(SHAPES.items())}
    ok = True
    for blocks, info in zip(choices, builds):
        lib = cuda_build.load(info.lib_path)
        row = {"blocks": dict(zip(("k6_64", "k6_128", "k7_64", "k7_128"),
                                  blocks)),
               "ptxas": [k for k in info.kernels()
                         if k[0].startswith(KERNELS)],
               "correct": True, "ms": {}}
        for name, case in cases.items():
            case.k6(lib)
            case.k7(lib)
            row["correct"] &= case.correct()
            row["ms"][f"k6_{name}"] = device_ms(lambda c=case: c.k6(lib))
            row["ms"][f"k7_{name}"] = device_ms(lambda c=case: c.k7(lib))
        ok &= row["correct"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
