"""Time kernels K3, K4 and K5 on the card at each candidate tiling.

Each candidate sets some of the tiling and launch-bound constants of
``csrc/conv_module.cu`` (K3: ``TT_SMALL`` / ``TT_LARGE`` the output frames
a stage-1 block owns, ``S1_WM`` its warps along the rows, ``PIPE`` the
operand tiles in flight, ``BM2`` x ``BN2`` the stage-2 tile and ``WM2`` a
stage-2 warp's rows, ``S1_MIN_BLOCKS`` / ``S2_MIN_BLOCKS`` the blocks an SM
in ``__launch_bounds__``) or of ``csrc/quant.cu`` (K4: ``K4_BM`` x
``K4_BN`` the output tile, ``K4_BK`` the depth of a chunk, ``K4_WM`` x
``K4_WN`` a warp's outputs, ``K4_STAGES`` the chunks in its cp.async ring,
``K4_MIN_BLOCKS``; K5: ``A8_BM`` x ``A8_BN`` the output tile of the
product, ``A8_STAGES`` the chunks in its cp.async ring, ``A8_MIN_BLOCKS``).
For each, the sweep builds
the kernel's source with those values into a library of its own under
``_build/`` (the source's own values first), prints the kernels' registers
and spills and K3's launch plan (blocks; rows computed per output frame),
checks the kernel against its plain version (K3 within
``card_cases.TOL_K3``, K4 within its per-element tolerance
``card_cases.k4_error_share``, K5 bit for bit) and times it as
chip_smoke.py does (device ms of one call, 20 calls in one CUDA graph) at
``card_cases``' shapes, the ones chip_smoke.py checks: K3 at serving
[4, 768, 256], training [16, 256, 512] and [4, 256, 1024]; K4 and K5 at
M 3072, K 256 and N 512, 1024, 2048. Run on the card from the repository
root:

    python -m omnilingual_asr_torch.ops.conv_quant_sweep \\
        --k3 TT_LARGE=64 PIPE=3 WM2=16,S2_MIN_BLOCKS=3 \\
        --k4 K4_STAGES=3 K4_BK=128 K4_WM=32,K4_WN=32 \\
        --k5 A8_STAGES=3 A8_BM=128,A8_MIN_BLOCKS=2

each argument one candidate (``NAME=VALUE`` pairs joined by commas). A
tiling that the source's static_asserts refuse is reported, not fatal.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import conv_module, cuda_build, quant, sweep
from .card_cases import (K3_SHAPES, K4_SHAPES, K5_SHAPES, TOL_K3,
                         k4_error_share)
from .sweep import CONST, device_ms, parse  # noqa: F401 (re-exported)

SOURCES = {"k3": "conv_module.cu", "k4": "quant.cu", "k5": "quant.cu"}
KERNELS = {"k3": ("conv_stage1_kernel", "conv_stage2_kernel"),
           "k4": ("bf16_rows_kernel", "q_matmul_kernel"),
           "k5": ("quantize_rows_kernel", "q8a8_matmul_kernel")}


def source_values(kernel: str, names) -> dict:
    """The source's own values of the constants ``names``."""
    return sweep.source_values(SOURCES[kernel], names)


def variant_dir(kernel: str, values: dict):
    """common.cu, the kernel's source with ``values`` set, and the headers,
    in a directory of their own."""
    return sweep.variant_dir(SOURCES[kernel], values, kernel)


class K3Case:
    """Seeded inputs of one shape (random weights as the card tests make
    them), the plain version's output, and launches into fixed outputs."""

    def __init__(self, dev, B, T, D, valid, seed, K=32):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def rnd(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device=dev)

        mask = torch.arange(T, device=dev)[None] < torch.tensor(
            valid, device=dev)[:, None]
        bf16 = torch.bfloat16
        args = (rnd(B, T, D), mask, 1 + rnd(D, scale=0.1),
                rnd(D, scale=0.1), rnd(D, 2 * D, scale=D ** -0.5).to(bf16),
                rnd(K, D, scale=K ** -0.5), 1 + rnd(D, scale=0.1),
                rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5).to(bf16))
        self.want = conv_module.conv_module_plain(*args)
        self.args = (args[0], mask.to(torch.int32), *args[2:])
        self.got = torch.empty_like(args[0])
        self.dims = (B, T, D, K)
        self.scratch = {}          # by library: its tiles size the scratch

    def launch(self, lib):
        if lib not in self.scratch:
            self.scratch[lib] = conv_module.kernel_scratch(
                *self.dims[:3], self.got.device, lib=lib)
        cuda_build.check(lib.omni_conv_module(
            *[t.data_ptr() for t in self.args], self.scratch[lib].data_ptr(),
            self.got.data_ptr(), *self.dims,
            torch.cuda.current_stream().cuda_stream), "K3")

    def error(self) -> float:
        torch.cuda.synchronize()
        if not bool(torch.isfinite(self.got).all()):
            return float("inf")
        return float((self.got - self.want).abs().max())

    def plan(self, lib):
        out = cuda_build.plan("omni_conv_module_plan", *self.dims[:3],
                              lib=lib)
        return {"stage1_blocks": out[0], "rows_per_frame": out[1] / out[2],
                "stage2_blocks": out[3]}


class QuantCase:
    """K4's or K5's inputs as chip_smoke.py makes them (an outlier row and
    an all-zero row), the plain version's output, and launches."""

    def __init__(self, dev, M, K, N, seed, mode):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(M, K, generator=gen, device=dev)
        x[0] *= 1000.0
        x[M - 1] = 0.0
        w_q, scale = quant.quantize_weight(
            0.05 * torch.randn(K, N, generator=gen, device=dev))
        bias = torch.randn(N, generator=gen, device=dev)
        plain = (quant.quantized_matmul_a8_plain if mode == "a8"
                 else quant.quantized_matmul_plain)
        self.want = plain(x, w_q, scale, bias)
        self.inputs = (x, w_q, scale, bias)
        self.args = (x, w_q.t().contiguous(), scale, bias)
        self.got = torch.empty(M, N, device=dev)
        self.scratch = quant.kernel_scratch(M, K, dev, mode)
        self.dims = (M, N, K)
        self.mode = mode

    def launch(self, lib):
        entry = "omni_q8a8_matmul" if self.mode == "a8" else "omni_q_matmul"
        cuda_build.check(getattr(lib, entry)(
            *[t.data_ptr() for t in self.args], self.got.data_ptr(),
            self.scratch.data_ptr(), *self.dims,
            torch.cuda.current_stream().cuda_stream), entry)

    def error(self) -> float:
        """K5: the elements that differ; K4: the largest share of its
        per-element tolerance (inf where not finite)."""
        torch.cuda.synchronize()
        if self.mode == "a8":
            return float((self.got != self.want).sum())
        if not bool(torch.isfinite(self.got).all()):
            return float("inf")
        return k4_error_share(self.got, self.want, *self.inputs)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k3", nargs="*", default=[],
                    help="K3 candidates, NAME=VALUE[,NAME=VALUE...]")
    ap.add_argument("--k4", nargs="*", default=[],
                    help="K4 candidates, NAME=VALUE[,NAME=VALUE...]")
    ap.add_argument("--k5", nargs="*", default=[],
                    help="K5 candidates, NAME=VALUE[,NAME=VALUE...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(sweep.card_line(), flush=True)
    jobs = []
    for kernel, specs in (("k3", args.k3), ("k4", args.k4),
                          ("k5", args.k5)):
        cands = [parse(s) for s in specs]
        names = sorted({k for c in cands for k in c})
        base = source_values(kernel, names)
        jobs.append((kernel, {}, base))
        jobs += [(kernel, c, {**base, **c}) for c in cands if c]
    # One build per distinct source and values: K4's and K5's own values
    # are the same quant.cu.
    builds = sweep.build_variants([(SOURCES[k], c, k) for k, c, _ in jobs])
    cases = {"k3": {n: K3Case(dev, *s, seed=i)
                    for i, (n, s) in enumerate(K3_SHAPES.items())},
             "k4": {n: QuantCase(dev, *s, seed=20 + i, mode="w8")
                    for i, (n, s) in enumerate(K4_SHAPES.items())},
             "k5": {n: QuantCase(dev, *s, seed=10 + i, mode="a8")
                    for i, (n, s) in enumerate(K5_SHAPES.items())}}
    ok = True
    for (kernel, cand, values), info in zip(jobs, builds):
        if not isinstance(info, cuda_build.BuildInfo):
            print(json.dumps({"kernel": kernel, "values": values,
                              "build_error": info}), flush=True)
            continue
        lib = cuda_build.load(info.lib_path)
        row = {"kernel": kernel, "values": values,
               "source": not cand,
               "ptxas": [k for k in info.kernels()
                         if k[0].startswith(KERNELS[kernel])],
               "correct": True, "err": {}, "plan": {}, "ms": {}}
        for name, case in cases[kernel].items():
            case.got.zero_()
            case.launch(lib)
            err = case.error()
            row["err"][name] = err
            row["correct"] &= {"k3": err <= TOL_K3, "k4": err <= 1.0,
                               "k5": err == 0}[kernel]
            if kernel == "k3":
                row["plan"][name] = case.plan(lib)
            row["ms"][name] = device_ms(lambda c=case: c.launch(lib))
        ok &= row["correct"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
