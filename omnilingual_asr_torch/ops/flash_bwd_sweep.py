"""Time kernels K6 and K7, bf16, f16 and f32, and the f32 and f16 K2 on
the card at each candidate of their tile and launch-bound constants.

Each candidate sets some constants of ``csrc/attention_bwd.cu`` (the bf16
K6 and K7 and, under ``--f16``, their f16 variants, which share the
source and its constants: ``DQ_MIN_BLOCKS_64`` / ``_128`` and
``DKV_MIN_BLOCKS_64`` / ``_128``, the blocks an SM in
``__launch_bounds__`` by head dim) or of
``csrc/attention_f32.cu`` (the f32 K2, K6 and K7 on 3xTF32 ``mma.sync``:
by head dim, ``FWD_TILE_*`` / ``DQ_TILE_*`` / ``DKV_TILE_*`` the rows of a
streamed tile, ``FWD_STEP_*`` / ``DQ_STEP_*`` / ``DKV_STEP_*`` the rows a
step of a warp takes, ``FWD_MIN_BLOCKS_*`` / ``DQ_MIN_BLOCKS_*`` /
``DKV_MIN_BLOCKS_*``, ``FWD_SPLIT_*`` the groups of 4 warps that share a
K2 tile's steps, ``FWD_MTILES_*`` the tiles of 16 query rows a K2 warp
owns, and at D 64 the tile, step, blocks (and K2's groups and row tiles)
under ``FWD_FEW_*`` / ``DQ_FEW_*`` / ``DKV_FEW_*`` for a grid too small to
fill every SM, as the serving batch's) or, under ``--f16fwd``, of
``csrc/attention_f16.cu`` (the f16 K2 on wgmma and TMA, by head dim:
``FWD16_STAGES_*`` the K/V ring's stages, ``FWD16_MIN_BLOCKS_*`` its
launch bounds, ``FWD16_OVERLAP_*`` 1 to issue a tile's S before the
previous tile's softmax; timed at every shape of
``card_cases.F16_FLASH_SHAPES`` beside SDPA's f16 forward, o held to
``card_cases.TOL_F16_*`` and lse to ``TOL_F16_LSE``). For each, the sweep
builds that source with those values through ``ops/sweep.py`` (the
source's own values first), prints the kernels' registers and spills,
checks the kernels against their plain versions (bf16: chip_smoke.py's
tolerance; f16: ``card_cases.TOL_F16_*`` per element, masked keys' dK, dV
and fully-masked rows' dQ exactly 0; f32: ``card_cases.TOL_F32_FLASH`` of
the largest element and
``TOL_F32_LSE``, masked keys' dK, dV and fully-masked rows' o and dQ
exactly 0, their lse +1e30) and times them as chip_smoke.py does (device
ms of one call, 20 calls in one CUDA graph) at the training shape
[16, 256, 8, 64], the serving batch [4, 768, 4, 64] and large_config's
head dim 128 ([4, 768, 8, 128]), SDPA's backward (and at f32 its
forward) at the same dtype beside them. Run on the card from the
repository root:

    python -m omnilingual_asr_torch.ops.flash_bwd_sweep \\
        --bf16 DQ_MIN_BLOCKS_64=3 DKV_MIN_BLOCKS_128=1 \\
        --f16 DKV_MIN_BLOCKS_128=1 \\
        --f32 DQ_TILE_64=64,DQ_MIN_BLOCKS_64=1 FWD_FEW_SPLIT_64=1 \\
        --f16fwd FWD16_OVERLAP_64=1,FWD16_OVERLAP_128=1

each argument one candidate (``NAME=VALUE`` pairs joined by commas). A
candidate that the source's static_asserts refuse is reported, not fatal.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from . import attention, cuda_build, sweep
from .card_cases import (F16_FLASH_SHAPES, F32_FLASH_SHAPES, TOL_F16_LSE,
                         TOL_F32_FLASH, TOL_F32_LSE, f16_share)

SOURCES = {"bf16": "attention_bwd.cu", "f16": "attention_bwd.cu",
           "f32": "attention_f32.cu", "f16fwd": "attention_f16.cu"}
KERNELS = {"bf16": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
           "f16": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
           "f32": ("flash_bwd_dq_tf32_kernel", "flash_bwd_dkv_tf32_kernel",
                   "flash_fwd_tf32_kernel"),
           "f16fwd": ("flash_fwd_f16_kernel",)}
ENTRIES = {"bf16": ("omni_flash_bwd_dq", "omni_flash_bwd_dkv"),
           "f16": ("omni_flash_bwd_dq_f16", "omni_flash_bwd_dkv_f16"),
           "f32": ("omni_flash_bwd_dq_f32", "omni_flash_bwd_dkv_f32"),
           "f16fwd": ()}
# The forward the sweep also checks and times, by group.
FWD_ENTRIES = {"f32": "omni_flash_fwd_f32", "f16fwd": "omni_flash_fwd_f16"}
DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16,
          "f32": torch.float32, "f16fwd": torch.float16}
# (B, T, H, D, valid keys): chip_smoke.py's training, serving and
# head-dim-128 cases (card_cases.F16_FLASH_SHAPES are the same); the f16
# K2 at every shape of F16_FLASH_SHAPES.
SHAPES = {"train": F32_FLASH_SHAPES["training"],
          "serving": F32_FLASH_SHAPES["serving"],
          "d128": F32_FLASH_SHAPES["d128"]}
GROUP_SHAPES = {"f16fwd": F16_FLASH_SHAPES}


class Case:
    """Seeded inputs of one shape at one dtype, the plain versions'
    gradients (and at f32 o and lse), SDPA's backward (and at f32 forward)
    time, and launches of a library's K6 and K7 (and f32 K2) into fixed
    outputs."""

    def __init__(self, dev, dtype, B, T, H, D, valid, seed, fwd=False):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        self.mask = torch.arange(T, device=dev)[None] < torch.tensor(
            valid, device=dev)[:, None]
        o, lse = attention.flash_attention_plain(q, k, v, self.mask)
        args = (q, k, v, self.mask, do, lse, attention.flash_delta(o, do))
        self.want = (attention.flash_attention_bwd_dq_plain(*args),
                     *attention.flash_attention_bwd_dkv_plain(*args))
        self.got = tuple(torch.empty_like(q) for _ in range(3))
        self.inputs = (q, k, v, self.mask.to(torch.int32), do, *args[5:])
        self.ptrs = [t.data_ptr() for t in self.inputs]
        self.dims = (B, T, H, D, 1.0 / math.sqrt(D))
        self.f32 = dtype == torch.float32
        self.f16 = dtype == torch.float16
        self.sdpa_ms = self._sdpa_ms(q, k, v, do)
        self.sdpa_fwd_ms = None
        if fwd:
            self.fwd_want = (o, lse)
            self.fwd_got = (torch.empty_like(q), torch.empty_like(lse))
            self.sdpa_fwd_ms = self._sdpa_fwd_ms(q, k, v)

    def _sdpa_fwd_ms(self, q, k, v):
        """SDPA's forward on the same inputs, the f32 K2's yardstick."""
        import torch.nn.functional as F

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        amask = self.mask[:, None, None, :]
        return sweep.device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask))

    def _sdpa_ms(self, q, k, v, do):
        """SDPA's backward (dQ, dK, dV), its forward outside the timed
        region; None where it cannot be captured in a CUDA graph."""
        import torch.nn.functional as F

        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), torch.enable_grad():
            ot = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=self.mask[:, None, None, :])
        dot = do.transpose(1, 2)
        try:
            return sweep.device_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True), stream=stream)
        except RuntimeError:    # the yardstick only
            return None

    def launch(self, lib, which: int, entries):
        outs = self.got[:1] if which == 0 else self.got[1:]
        cuda_build.check(getattr(lib, entries[which])(
            *self.ptrs, *[t.data_ptr() for t in outs], *self.dims,
            torch.cuda.current_stream().cuda_stream), entries[which])

    def launch_fwd(self, lib, entry):
        """The forward into fwd_got: q, k, v, mask in, o and lse out."""
        cuda_build.check(getattr(lib, entry)(
            *self.ptrs[:4], *[t.data_ptr() for t in self.fwd_got],
            *self.dims, torch.cuda.current_stream().cuda_stream), entry)

    def correct_fwd(self) -> bool:
        """The f32 or f16 K2's o and lse against the plain forward's."""
        torch.cuda.synchronize()
        (o, lse), (want_o, want_lse) = self.fwd_got, self.fwd_want
        live = want_lse < 1e29
        dead_row = ~self.mask.any(dim=1)
        if self.f16:
            close = (f16_share(o, want_o) <= 1.0 and bool(
                (lse - want_lse)[live].abs().max() <= TOL_F16_LSE))
        else:
            close = (bool((o - want_o).abs().max()
                          <= TOL_F32_FLASH * want_o.abs().max())
                     and bool((lse - want_lse)[live].abs().max()
                              <= TOL_F32_LSE))
        return (close
                and bool((o[dead_row] == 0).all())
                and bool((lse[~live] == 1e30).all()))

    def correct(self) -> bool:
        torch.cuda.synchronize()
        dead_row, dead_key = ~self.mask.any(dim=1), ~self.mask
        for i, (got, want) in enumerate(zip(self.got, self.want)):
            got, want = got.float(), want.float()
            if self.f16:
                ok = f16_share(got, want) <= 1.0
            else:
                tol = (TOL_F32_FLASH * want.abs().max() if self.f32 else
                       2.0 ** -10 * want.abs().max() + 2.0 ** -7 * want.abs())
                ok = bool(((got - want).abs() <= tol).all())
            if self.f32 or self.f16:
                zeros = got[dead_row if i == 0 else dead_key]
                ok = ok and bool((zeros == 0).all())
            if not ok:
                return False
        return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for group in SOURCES:
        ap.add_argument(f"--{group}", nargs="*", default=[],
                        help=f"{SOURCES[group]} candidates, "
                             f"NAME=VALUE[,NAME=VALUE...]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(sweep.card_line(), flush=True)
    jobs = []
    for group in SOURCES:
        cands = [sweep.parse(s) for s in getattr(args, group)]
        names = sorted({k for c in cands for k in c})
        base = sweep.source_values(SOURCES[group], names)
        jobs.append((group, {}, base))
        jobs += [(group, c, {**base, **c}) for c in cands if c]
    builds = sweep.build_variants([(SOURCES[g], c, g) for g, c, _ in jobs])
    cases = {group: {name: Case(dev, DTYPES[group], *shape[:4],
                                list(shape[4]), seed=i,
                                fwd=group in FWD_ENTRIES)
                     for i, (name, shape) in enumerate(
                         GROUP_SHAPES.get(group, SHAPES).items())}
             for group in SOURCES}
    for group, by_shape in cases.items():
        print(json.dumps({"group": group, "sdpa_backward_ms": {
            n: c.sdpa_ms for n, c in by_shape.items()}, "sdpa_forward_ms": {
            n: c.sdpa_fwd_ms for n, c in by_shape.items()}}), flush=True)
    ok = True
    for (group, cand, values), info in zip(jobs, builds):
        if not isinstance(info, cuda_build.BuildInfo):
            print(json.dumps({"group": group, "values": values,
                              "build_error": info}), flush=True)
            continue
        lib = cuda_build.load(info.lib_path)
        row = {"group": group, "values": values, "source": not cand,
               "ptxas": [k for k in info.kernels()
                         if k[0].startswith(KERNELS[group])],
               "correct": True, "ms": {}}
        for name, case in cases[group].items():
            if ENTRIES[group]:
                for which in (0, 1):
                    case.launch(lib, which, ENTRIES[group])
                row["correct"] &= case.correct()
            for which, kernel in enumerate(("k6", "k7")[:len(
                    ENTRIES[group])]):
                row["ms"][f"{kernel}_{name}"] = sweep.device_ms(
                    lambda c=case, w=which: c.launch(lib, w, ENTRIES[group]))
            if group in FWD_ENTRIES:
                entry = FWD_ENTRIES[group]
                case.launch_fwd(lib, entry)
                row["correct"] &= case.correct_fwd()
                row["ms"][f"k2_{name}"] = sweep.device_ms(
                    lambda c=case: c.launch_fwd(lib, entry))
        ok &= row["correct"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
