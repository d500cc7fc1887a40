#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``omnilingual_asr_torch``).

Run from the repository root on a machine with one NVIDIA H100 SXM:

    python3 chip_smoke.py              # phases 1-5
    python3 chip_smoke.py --profile    # and, before the report, phase 4b

Phases, each printed with its elapsed seconds; any failure exits non-zero
with no result line:

1. device  - card name and power limit; TF32 off for matmuls and cuDNN.
2. build   - nvcc builds the kernels from ``omnilingual_asr_torch/csrc``.
3. kernels - log-mel (K1), flash attention (K2), the fused conv module
             (K3) and the int8 matmuls W8A16 (K4) and W8A8 (K5, at the
             three widths of the quantized main path) on seeded inputs with
             masked rows, each held against its plain PyTorch version, and
             timed beside its plain version, a PyTorch yardstick where one
             exists, and the card's bound. Times are device times: 20 calls
             captured back to back in a CUDA graph, replayed between CUDA
             events (``call_ms`` adds one eager call's time, host launch
             included).
4. e2e     - ``TranscriptionEngine`` on the card with the release weights
             answers three ``transcribe`` requests (the golden fixture, the
             same audio tiled to two minutes = one full batch of 4 windows,
             and that again warm); the golden result is held to the JAX
             engine's stored result, and the kernel launch counters show
             that the requests ran through K1-K3. Then the int8 paths,
             each through the port's ``GeminiDiarizedTranscriptionPipeline``
             facade: ``quantize="a8"`` and ``"w8"`` answer the golden file
             and the tiled file, held to the JAX engine's int8 results, with
             10 K5 or K4 launches a batch; ``quantize=True`` answers the
             golden file with neither.
4b. profile - (``--profile`` only) median request seconds over 3 warm runs
             and the StageTrace stages at 30, 120 and 330 s of audio (1, 1
             and 3 batches); 120 s requests of the unquantized, a8 and w8
             engines in 7 turns; then one warm 120 s request of each under
             ``torch.profiler``: device time by kernel and the device's
             busy share of the request's wall time.
5. report  - one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and
             power limit, and the result line
             ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "omnilingual_asr_torch"
RELEASE = ROOT / "checkpoints" / "release"
SEED = 1234
N_TIMED = 20
WINDOWS_PER_BATCH = 4
TILED_SECONDS = 120.0
PROFILE_SECONDS = (30.0, 120.0, 330.0)
PROFILE_WARM_RUNS = 3
INT8_ROUNDS = 7

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): f32 on
# the CUDA cores, bf16 and int8 on the tensor cores, and HBM3 bandwidth. The
# SXM part names itself "NVIDIA H100 80GB HBM3".
H100_SXM_PEAKS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12,
                  "bytes": 3.35e12}

# Tolerances of each kernel against its plain version on the same inputs.
TOL_K1 = 1e-3   # log-mel, abs: both are f32; the sums run in another order
#                 (relative error ~1e-6 of a mel value); zero padding frames
#                 hit the log floor exactly in both
# attention output, per element |o - o_ref| <= ABS + REL * |o_ref|: both
# round an f32 result to bf16, and where the two f32 values (summed in
# another order) straddle a rounding boundary they land one bf16 ulp apart,
# which is at most 2^-7 |o_ref|; ABS covers the f32 difference itself
# (exp and sums over 768 keys in another order, ~1e-6), which matters only
# where o is near zero. A dropped key or a wrong V sum moves o by ~|o|.
TOL_K2_REL = 2.0 ** -7
TOL_K2_ABS = 1e-4
TOL_K2_LSE = 1e-3  # logsumexp, abs: f32 online softmax vs one pass
TOL_K3 = 5e-2   # conv module, abs: LN output and SiLU output are rounded to
#                 bf16 in both; f32 inputs that differ in summation order can
#                 round one bf16 ulp apart, and one flipped input moves a
#                 256-term pointwise sum by |w| * 2^-8 * |h|
# W8A16 matmul, per element: both sum the same exact bf16 x int8 products in
# f32 in another order, each within K * 2^-24 * sum|terms| of the exact sum,
# so |got - want| <= 2 K 2^-24 (|bf16(x)| @ |w_q|) scale[n], plus one f32
# rounding of the bias add (2^-23 |want|).
TOL_K4_ORDER = 2.0 ** -24
# W8A8 matmul, abs relative to max|ref|: the int32 sums are exact and every
# other step is the same f32 operation, so the kernel should equal its plain
# version bit for bit; any difference means an activation was quantized
# differently.
TOL_K5_REL = 1e-6
# The release layers that take K4/K5, by width N: the FFN up-projections
# (8 a batch), the CTC head and the LID head.
QUANT_LAYERS = {1024: ("blocks", 0, "ffn1", "w1"), 512: ("ctc_head",),
                2048: ("lid_head",)}


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def card_peaks(name: str) -> dict:
    """The bound's peak rates; only the H100 SXM's are known here."""
    if "H100" not in name or not ("HBM3" in name or "SXM" in name):
        raise PhaseError(f"no peak rates for {name!r}: the bounds assume an "
                         f"H100 SXM")
    return H100_SXM_PEAKS


def time_ms(fn, n: int = N_TIMED, reps: int = 5) -> float:
    """Device milliseconds of one ``fn()``: n calls captured back to back in
    one CUDA graph, so that no host launch time sits between them, and the
    graph replayed ``reps`` times between CUDA events; the median replay
    over n. Every kernel, plain version and yardstick is timed this way."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def call_ms(fn, n: int = N_TIMED) -> float:
    """Median milliseconds of one eager ``fn()`` between CUDA events, the
    wrapper's host launch time included (the first slice's measure)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops_by_type: dict, n_bytes: int, peaks: dict):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = n_bytes / peaks["bytes"]
    t_ops = sum(f / peaks[kind] for kind, f in flops_by_type.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def check_k1(dev, peaks, cfg):
    import torch
    from omnilingual_asr_torch.audio.frontend import hann_window
    from omnilingual_asr_torch.ops.mel import (MelFrontend, log_mel_frames,
                                               log_mel_frames_plain)

    fe_cfg = cfg.frontend
    fe = MelFrontend(fe_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_frames = 2998                       # valid frames of a 30 s window
    t_pad = 3072
    frames = 0.1 * torch.randn(WINDOWS_PER_BATCH, t_pad, fe_cfg.n_fft,
                               generator=gen, device=dev)
    frames[:, n_frames:] = 0.0            # padding rows, as on the main path
    frames = frames.reshape(-1, fe_cfg.n_fft).contiguous()
    floor = fe_cfg.log_floor
    got = log_mel_frames(frames, fe.cw, fe.sw, fe.fb, floor)
    want = log_mel_frames_plain(frames, fe.cw, fe.sw, fe.fb, floor)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > TOL_K1:
        raise PhaseError(f"K1 log-mel max abs err {err:.3e} > {TOL_K1}")
    # Yardstick: the same function through cuFFT (rfft of the windowed
    # frames), the library's way to a power spectrum.
    win = torch.zeros(fe_cfg.n_fft, device=dev)
    win[:fe_cfg.win_length] = torch.from_numpy(
        hann_window(fe_cfg.win_length)).to(dev)
    fb513 = fe.fb[:fe_cfg.n_freqs].contiguous()

    def library():
        spec = torch.fft.rfft(frames * win, n=fe_cfg.n_fft, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.log(torch.clamp(power @ fb513, min=floor))

    lib_err = float((library() - want).abs().max())
    n, n_fft = frames.shape
    n_mels = fe.fb.shape[1]
    # The function's work is over the real bins; the zero bins that pad
    # them to the kernel's chunk width are not counted.
    n_bins = fe_cfg.n_freqs
    flops = 2 * n * n_fft * n_bins * 2 + 2 * n * n_bins * n_mels
    b_ms, b_by = bound({"f32": flops},
                       nbytes(frames, fe.cw, fe.sw, fe.fb, got), peaks)
    return {
        "name": "log_mel", "route": "cuda",
        "source": "omnilingual_asr_torch/csrc/mel.cu",
        "replaces": "omnilingual_asr_tpu/ops/mel_pallas.py:66",
        "max_abs_err": err, "tol": TOL_K1,
        "ms": time_ms(lambda: log_mel_frames(frames, fe.cw, fe.sw, fe.fb,
                                             floor)),
        "call_ms": call_ms(lambda: log_mel_frames(frames, fe.cw, fe.sw,
                                                  fe.fb, floor)),
        "plain_ms": time_ms(lambda: log_mel_frames_plain(
            frames, fe.cw, fe.sw, fe.fb, floor)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library), "library_max_abs_err": lib_err,
        "shape": f"frames {list(frames.shape)} f32 -> [{n}, {n_mels}]",
        "gflop": flops / 1e9,
    }


def check_k2(dev, peaks, cfg):
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops.attention import (flash_attention,
                                                     flash_attention_plain)

    B, T = WINDOWS_PER_BATCH, 768
    H = cfg.encoder.n_heads
    D = cfg.encoder.d_model // H
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def rnd():
        return torch.randn(B, T, H, D, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v = rnd(), rnd(), rnd()
    # Row 0 whole, row 1 ragged (partial last key tile), row 2 short (whole
    # key tiles masked), row 3 a padded batch slot (every key masked).
    n_valid = torch.tensor([T, 700, 300, 0], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < n_valid[:, None]
    o, lse = flash_attention(q, k, v, mask)
    o_ref, lse_ref = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (o.float() - o_ref.float()).abs()
    err = float(diff.max())
    # Largest share of its own tolerance that any element uses (<= 1 passes).
    tol_share = float((diff / (TOL_K2_ABS + TOL_K2_REL
                               * o_ref.float().abs())).max())
    live = lse_ref < 1e29
    lse_err = float((lse - lse_ref)[live].abs().max())
    dead_ok = bool((lse[~live] == 1e30).all()) and bool(
        (o[3].float() == 0).all())
    if (tol_share > 1.0 or lse_err > TOL_K2_LSE or not dead_ok
            or not bool(torch.isfinite(o.float()).all())):
        raise PhaseError(f"K2 flash attention: o err {err:.3e} uses "
                         f"{tol_share:.2f} of its tolerance, lse err "
                         f"{lse_err:.3e} (tol {TOL_K2_LSE}), masked rows ok: "
                         f"{dead_ok}")
    # Yardstick: scaled_dot_product_attention with the same key mask (its
    # fully-masked slot is not comparable and is not checked).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    amask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    # Work this run's data needs: every query row against its valid keys.
    flops = 4 * H * D * T * int(n_valid.sum())
    b_ms, b_by = bound({"bf16": flops},
                       nbytes(q, k, v, mask.to(torch.int32), o, lse), peaks)
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "omnilingual_asr_torch/csrc/attention.cu",
        "replaces": "omnilingual_asr_tpu/ops/attention.py:34",
        "max_abs_err": err, "lse_max_abs_err": lse_err,
        "tol": f"{TOL_K2_ABS} + {TOL_K2_REL} |o|, max share {tol_share:.3f}",
        "ms": time_ms(lambda: flash_attention(q, k, v, mask)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v, mask)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library),
        "shape": f"q/k/v [{B}, {T}, {H}, {D}] bf16",
        "gflop": flops / 1e9,
    }


def check_k3(dev, peaks, cfg, params):
    import torch
    from omnilingual_asr_torch.ops.conv_module import (conv_module_plain,
                                                       fused_conv_module)

    B, T, D = WINDOWS_PER_BATCH, 768, cfg.encoder.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x = torch.randn(B, T, D, generator=gen, device=dev)
    n_valid = torch.tensor([T, 700, 301, 0], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < n_valid[:, None]
    p = params["blocks"][0]["conv"]          # release weights
    # pw1/pw2 in bf16, as the engine holds them for the kernel.
    pw1, pw2 = (p[k]["w"].to(torch.bfloat16) for k in ("pw1", "pw2"))
    args = (x, mask, p["ln"]["scale"], p["ln"]["bias"], pw1, p["dw"],
            p["dw_ln"]["scale"], p["dw_ln"]["bias"], pw2)
    got = fused_conv_module(*args)
    want = conv_module_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > TOL_K3:
        raise PhaseError(f"K3 conv module max abs err {err:.3e} > {TOL_K3}")
    K = p["dw"].shape[0]
    pw_flops = 2 * B * T * D * (2 * D + D)
    dw_flops = 2 * B * T * D * K
    b_ms, b_by = bound({"bf16": pw_flops, "f32": dw_flops},
                       nbytes(x, mask, got, pw1, pw2, p["dw"]) + 4 * 4 * D,
                       peaks)
    return {
        "name": "conv_module", "route": "cuda",
        "source": "omnilingual_asr_torch/csrc/conv_module.cu",
        "replaces": "omnilingual_asr_tpu/ops/conv_module.py:32",
        "max_abs_err": err, "tol": TOL_K3,
        "mean_abs_err": float((got - want).abs().mean()),
        "ms": time_ms(lambda: fused_conv_module(*args)),
        "call_ms": call_ms(lambda: fused_conv_module(*args)),
        "plain_ms": time_ms(lambda: conv_module_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"x [{B}, {T}, {D}] f32, K {K}",
        "gflop": (pw_flops + dw_flops) / 1e9,
    }


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_quant(dev, peaks, params):
    """K4 and K5 at (3072, 256, N) for the quantized main path's widths, on
    the release layers of those widths (quantized as the engine quantizes
    them) and seeded activations with an outlier row. Returns the two
    kernels' entries, their numbers at N = 1024 (8 of the 10 launches a
    batch) and every width under "widths"."""
    import torch
    from omnilingual_asr_torch.ops import quant

    M = WINDOWS_PER_BATCH * 768
    out = {"w8": [], "a8": []}
    for N, path in QUANT_LAYERS.items():
        leaf = _leaf(params, path)
        w_q, scale = quant.quantize_weight(leaf["w"])
        w_t = w_q.t().contiguous()
        bias = leaf["b"]
        K = w_q.shape[0]
        gen = torch.Generator(device=dev).manual_seed(SEED + 3 + N)
        x = torch.randn(M, K, generator=gen, device=dev)
        x[0] *= 1000.0                  # an outlier row
        x[M - 1] = 0.0                  # an all-zero row
        flops = 2 * M * N * K
        n_bytes = nbytes(x, w_q, scale, bias) + M * N * 4

        # K4: W8A16.
        got = quant.quantized_matmul(x, w_q, scale, bias, w_t)
        want = quant.quantized_matmul_plain(x, w_q, scale, bias)
        torch.cuda.synchronize()
        xb = x.to(torch.bfloat16).float().abs()
        tol = (2 * K * TOL_K4_ORDER * (xb.double() @ w_q.double().abs())
               * scale.double()).float() + 2.0 ** -23 * want.abs()
        diff = (got - want).abs()
        share = float((diff / tol.clamp(min=1e-30)).max())
        if share > 1.0 or not bool(torch.isfinite(got).all()):
            raise PhaseError(f"K4 W8A16 N={N}: max abs err "
                             f"{float(diff.max()):.3e} uses {share:.2f} of "
                             f"its per-element tolerance")
        xb16, wb16 = x.to(torch.bfloat16), w_q.to(torch.bfloat16)

        def lib_w8():
            return torch.mm(xb16, wb16) * scale

        b_ms, b_by = bound({"bf16": flops}, n_bytes, peaks)
        out["w8"].append({
            "N": N, "max_abs_err": float(diff.max()),
            "tol": f"2 K 2^-24 sum|terms| scale + 2^-23 |ref|, max share "
                   f"{share:.3f}",
            "ms": time_ms(lambda: quant.quantized_matmul(x, w_q, scale,
                                                         bias, w_t)),
            "call_ms": call_ms(lambda: quant.quantized_matmul(
                x, w_q, scale, bias, w_t)),
            "plain_ms": time_ms(lambda: quant.quantized_matmul_plain(
                x, w_q, scale, bias)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib_w8),
            "library": "GEMM only: torch.mm on bf16 copies made beforehand, "
                       "times the scale; leaves out the f32 -> bf16 "
                       "rounding of x, the int8 widening and the bias, and "
                       "rounds the product to bf16 before the scale",
        })

        # K5: W8A8.
        got = quant.quantized_matmul_a8(x, w_q, scale, bias, w_t)
        want = quant.quantized_matmul_a8_plain(x, w_q, scale, bias)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        err = float((got - want).abs().max())
        tol5 = TOL_K5_REL * float(want.abs().max())
        if err > tol5 or not bool(torch.isfinite(got).all()):
            raise PhaseError(f"K5 W8A8 N={N}: {n_diff} elements differ, max "
                             f"abs err {err:.3e} > {tol5:.3e}")
        xq, sx = quant.quantize_rows(x)
        xq8 = xq.to(torch.int8)
        lib_ok = bool(torch.equal(
            torch._int_mm(xq8, w_t.t()).float() * sx[:, None] * scale + bias,
            want))

        def lib_a8():
            return torch._int_mm(xq8, w_t.t())

        b_ms, b_by = bound({"int8": flops}, n_bytes, peaks)
        out["a8"].append({
            "N": N, "max_abs_err": err, "n_diff": n_diff,
            "tol": f"{TOL_K5_REL} max|ref| = {tol5:.3e}",
            "ms": time_ms(lambda: quant.quantized_matmul_a8(x, w_q, scale,
                                                            bias, w_t)),
            "call_ms": call_ms(lambda: quant.quantized_matmul_a8(
                x, w_q, scale, bias, w_t)),
            "plain_ms": time_ms(lambda: quant.quantized_matmul_a8_plain(
                x, w_q, scale, bias)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib_a8),
            "library": "GEMM only: torch._int_mm on int8 activations "
                       "quantized beforehand; leaves out the per-row "
                       "quantization of x and the f32 epilogue (scales, "
                       "bias) and writes int32",
            "library_epilogue_equal": lib_ok,
        })

    entries = []
    for mode, name, src_line in (
            ("w8", "q_matmul_w8a16", "omnilingual_asr_tpu/ops/quant.py:41"),
            ("a8", "q8a8_matmul", "omnilingual_asr_tpu/ops/quant.py:90")):
        head = out[mode][0]                # N = 1024
        entries.append({
            "name": name, "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/quant.cu",
            "replaces": src_line,
            **{k: head[k] for k in ("max_abs_err", "tol", "ms", "call_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "shape": f"x [{M}, {K}] f32, w_q [{K}, N] int8, numbers at "
                     f"N = 1024",
            "gflop": 2 * M * K * 1024 / 1e9,
            "widths": out[mode],
        })
    return entries


# ---------------------------------------------------------------------------
# Phase 4: end to end
# ---------------------------------------------------------------------------

def write_tiled_wav(src: Path, dst: Path, seconds: float) -> float:
    """``src`` repeated and cut to ``seconds``; returns the length in s."""
    with wave.open(str(src), "rb") as w:
        params = w.getparams()
        pcm = w.readframes(w.getnframes())
    n_frames = int(seconds * params.framerate)
    n = n_frames * params.sampwidth * params.nchannels
    dst.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(dst), "wb") as w:
        w.setparams(params)
        w.writeframes((pcm * (n // len(pcm) + 1))[:n])
    return n_frames / params.framerate


def _counters():
    from omnilingual_asr_torch.ops.attention import flash_attention
    from omnilingual_asr_torch.ops.conv_module import fused_conv_module
    from omnilingual_asr_torch.ops.mel import log_mel_frames
    from omnilingual_asr_torch.ops.quant import (quantized_matmul,
                                                 quantized_matmul_a8)

    return (log_mel_frames, flash_attention, fused_conv_module,
            quantized_matmul, quantized_matmul_a8)


def _n_batches(engine, paths) -> int:
    n = 0
    for path in paths:
        with wave.open(str(path), "rb") as w:
            n_win = math.ceil(w.getnframes() / engine.window_samples)
        n += math.ceil(n_win / engine.batch_size)
    return n


def drive_path(label, answer, engine, requests, per_batch):
    """One path of the port: every launch count is set to 0, the requests
    are answered through ``answer(path, progress_callback)`` (which returns
    a ``to_dict()``-form result), and the counts are read at once and held
    to ``per_batch`` launches of each kernel a batch. Returns (results,
    launches)."""
    counters = _counters()
    n_batches = _n_batches(engine, [p for _, p in requests])
    for fn in counters:
        fn.launches = 0
    results, report = [], []
    for name, path in requests:
        steps = []
        t0 = time.perf_counter()
        res = answer(path, lambda s, i: steps.append(i))
        secs = time.perf_counter() - t0
        tr = engine.last_trace
        results.append(res)
        report.append({"path": label, "request": name, "seconds": secs,
                       "audio_seconds": tr.audio_seconds,
                       "segments": len(res["segments"]),
                       "stages": {k: round(v, 4)
                                  for k, v in tr.stages.items()}})
        if steps != [0, 1, 2, 3]:
            raise PhaseError(f"{label}: progress steps {steps} for {name}")
    launches = {fn.__name__: fn.launches for fn in counters}
    for r in report:
        log(f"  request {json.dumps(r)}")
    log(f"  {label} launches {json.dumps(launches)} over {n_batches} "
        f"batches")
    for name, n in per_batch.items():
        if launches[name] != n * n_batches:
            raise PhaseError(f"{label}: {name} launched {launches[name]} "
                             f"times, expected {n} a batch x {n_batches}")
    return results, launches


def check_golden(label, engine, result, quantize=False) -> None:
    """``result`` and the greedy CTC ids on the golden file against the JAX
    engine's stored result in the same mode."""
    from omnilingual_asr_torch import testing as golden

    stored = golden.load_golden(quantize)
    bad = golden.result_mismatches(stored["result"], result,
                                   tone_mass=stored["tone_mass"])
    if bad:
        raise PhaseError(f"{label}: golden result mismatch: "
                         + "; ".join(bad))
    if result["summary"] != stored["result"]["summary"]:
        log(f"  {label}: summary tone within the fixture's tie "
            f"(tone mass {stored['tone_mass']}): {result['summary']!r}")
    samples = engine._load_audio(golden.GOLDEN_WAV)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    ids = [o["ctc_ids"].astype(int).tolist()
           for outs in engine._forward_batches(windows, n_last) for o in outs]
    agree = golden.ctc_agreement(stored["ctc_ids"], ids)
    log(f"  {label} golden: {len(result['segments'])} segments match the "
        f"JAX result ({golden.golden_json(quantize).name}); greedy CTC ids "
        f"agree on {agree:.4%} of frames")
    if agree < golden.MIN_CTC_AGREEMENT:
        raise PhaseError(f"{label}: CTC id agreement {agree:.4f} < "
                         f"{golden.MIN_CTC_AGREEMENT}")


def check_segment_times(label, results, audio_s) -> None:
    for res in results:
        if not res["segments"]:
            raise PhaseError(f"{label}: a request returned no segments")
        for s in res["segments"]:
            if not (0.0 <= s["start"] < s["end"] <= audio_s + 1.0):
                raise PhaseError(f"{label}: segment times {s['start']}-"
                                 f"{s['end']} outside [0, {audio_s}]")


def run_e2e(dev, cfg, params, xvector):
    """The unquantized main path through ``TranscriptionEngine``, then the
    int8 paths through the facade. Returns (engines by mode, launches of
    each kernel on its own path)."""
    import dataclasses

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.diarization.pipeline import (
        GeminiDiarizedTranscriptionPipeline)
    from omnilingual_asr_torch.engine import TranscriptionEngine

    L = cfg.encoder.n_layers
    tiled = PKG / "_build" / "smoke_tiled.wav"
    tiled_s = write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    requests = [("golden", golden.GOLDEN_WAV), ("tiled", tiled),
                ("tiled-warm", tiled)]
    engine = TranscriptionEngine(config=cfg, params=params,
                                 xvector_params=xvector, device=dev)
    unquantized = {"log_mel_frames": 1, "flash_attention": L,
                   "fused_conv_module": L, "quantized_matmul": 0,
                   "quantized_matmul_a8": 0}
    results, base = drive_path(
        "unquantized",
        lambda path, cb: engine.transcribe(path,
                                           progress_callback=cb).to_dict(),
        engine, requests, unquantized)
    check_golden("unquantized", engine, results[0])
    check_segment_times("unquantized", results[1:], tiled_s)
    if ([s["text"] for s in results[1]["segments"]]
            != [s["text"] for s in results[2]["segments"]]):
        raise PhaseError("the warm repeat of the tiled request differs")
    launches = {k: base[k] for k in ("log_mel_frames", "flash_attention",
                                     "fused_conv_module")}
    engines = {"unquantized": engine}

    # Int8 serving through the public facade: 2 FFN up-projections a layer,
    # the CTC and the LID head take the kernels (10 launches a batch).
    n_kernel_layers = 2 * L + 2
    for quantize, requests_q in (("a8", requests[:2]), ("w8", requests[:2]),
                                 (True, requests[:1])):
        pipe = GeminiDiarizedTranscriptionPipeline(
            config=cfg, params=params, xvector_params=xvector, device=dev,
            quantize=quantize)

        def answer(path, cb, pipe=pipe):
            segs = pipe.transcribe(str(path), word_timestamps=True,
                                   progress_callback=cb)
            return {"summary": pipe.summary,
                    "detected_languages": pipe.detected_languages,
                    "segments": [dataclasses.asdict(x) for x in segs]}

        label = f"quantize={quantize!r}"
        per_batch = dict(unquantized)
        per_batch["quantized_matmul_a8"] = (n_kernel_layers
                                            if quantize == "a8" else 0)
        per_batch["quantized_matmul"] = (n_kernel_layers
                                         if quantize == "w8" else 0)
        results, counts = drive_path(label, answer, pipe.gemini, requests_q,
                                     per_batch)
        if quantize is True:
            check_segment_times(label, results,
                                pipe.gemini.last_trace.audio_seconds)
            engines["q"] = pipe.gemini
            continue
        check_golden(label, pipe.gemini, results[0], quantize)
        check_segment_times(label, results[1:], tiled_s)
        key = "quantized_matmul_a8" if quantize == "a8" else \
            "quantized_matmul"
        launches[key] = counts[key]
        engines[quantize] = pipe.gemini
    return engines, launches


# ---------------------------------------------------------------------------
# Phase 4b (--profile): where a request's time goes
# ---------------------------------------------------------------------------

def request_seconds(label, engine, path, seconds) -> None:
    """Median wall seconds of warm requests (after one warm-up)."""
    engine.transcribe(path)                       # warm-up
    times = []
    for _ in range(PROFILE_WARM_RUNS):
        t0 = time.perf_counter()
        engine.transcribe(path)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log("  profile " + json.dumps({
        "engine": label, "audio_s": seconds, "request_s_median": med,
        "request_s_all": times, "rtf": seconds / med,
        "stages_last": {k: round(v, 5)
                        for k, v in engine.last_trace.stages.items()}}))


def device_profile(label, engine, path, top: int) -> None:
    """One warm request under ``torch.profiler``: device time by kernel and
    the device's busy share of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.transcribe(path)
        wall = time.perf_counter() - t0
    # Only the device's own events (kernels, copies): an operator's entry
    # repeats the time of the kernels it launched.
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    if not rows:
        log(f"  profiler ({label}): no device time recorded (not measured)")
        return
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    log(f"  profile {label} 120 s request: wall {wall * 1e3:.3f} ms, device "
        f"{total_ms:.3f} ms in {sum(r[1] for r in rows)} device events, "
        f"device busy share {total_ms / 1e3 / wall:.3f}")
    for dev_us, count, key in rows[:top]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def run_profile(engines) -> None:
    from omnilingual_asr_torch import testing as golden

    engine = engines["unquantized"]
    work = PKG / "_build" / "profile"
    paths = {}
    for seconds in PROFILE_SECONDS:
        path = work / f"t{int(seconds)}.wav"
        write_tiled_wav(golden.GOLDEN_WAV, path, seconds)
        paths[seconds] = path
        request_seconds("unquantized", engine, path, seconds)
    # The int8 engines at 120 s, in turns with the unquantized one.
    labels = ("unquantized", "a8", "w8")
    times = {label: [] for label in labels}
    for label in labels:
        engines[label].transcribe(paths[120.0])          # warm-up
    for _ in range(INT8_ROUNDS):
        for label in labels:
            t0 = time.perf_counter()
            engines[label].transcribe(paths[120.0])
            times[label].append(time.perf_counter() - t0)
    for label in labels:
        log("  profile " + json.dumps({
            "engine": label, "audio_s": 120.0, "in_turns": INT8_ROUNDS,
            "request_s_median": statistics.median(times[label]),
            "request_s_all": times[label]}))
    for label in labels:
        device_profile(label, engines[label], paths[120.0],
                       15 if label == "unquantized" else 8)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 4b: request seconds by length and a "
                         "torch.profiler device-time breakdown")
    args = ap.parse_args(argv)
    if not PKG.is_dir() or not RELEASE.is_dir():
        print("chip_smoke.py must run from the repository root (it needs "
              "omnilingual_asr_torch/ and checkpoints/release/)",
              file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ["OMNIASR_RELEASE_DIR"] = ""   # weights load by explicit path

    t_start = time.perf_counter()
    phase = "device"
    try:
        t0 = time.perf_counter()
        smi = nvidia_smi_line()
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        peaks = card_peaks(name)
        log(f"[device] {smi} | torch {torch.__version__} cuda "
            f"{torch.version.cuda} | peaks {peaks} "
            f"({time.perf_counter() - t0:.2f} s)")

        phase = "build"
        t0 = time.perf_counter()
        from omnilingual_asr_torch.ops import cuda_build

        info = cuda_build.build()
        cuda_build.library()
        for line in info.ptxas_log.splitlines():
            if "Used" in line or "spill" in line or line.startswith("---"):
                log("  " + line.strip())
        log(f"[build] {'cached' if info.cached else 'built'} "
            f"{info.lib_path.relative_to(ROOT)} in {info.seconds:.2f} s "
            f"({time.perf_counter() - t0:.2f} s)")

        phase = "kernels"
        t0 = time.perf_counter()
        from omnilingual_asr_torch.config import PipelineConfig
        from omnilingual_asr_torch.models.zoo import (load_checkpoint,
                                                      load_xvector)

        cfg = PipelineConfig.from_json(
            (RELEASE / "config.json").read_text(),
            checkpoint_path=str(RELEASE / "asr.npz"))
        params = load_checkpoint(RELEASE / "asr.npz", cfg, dev)
        xvector = load_xvector(RELEASE / "xvector.npz", cfg, dev)
        kernels = [check_k1(dev, peaks, cfg), check_k2(dev, peaks, cfg),
                   check_k3(dev, peaks, cfg, params),
                   *check_quant(dev, peaks, params)]
        for k in kernels:
            log(f"  {k['name']}: max abs err {k['max_abs_err']:.3e} (tol "
                f"{k['tol']}), {k['ms']:.4f} ms (one eager call "
                f"{k['call_ms']:.4f} ms), plain {k['plain_ms']:.4f} ms, "
                f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms "
                f"({k['bound_by']}), {k['shape']}")
            for w in k.get("widths", []):
                log(f"    {json.dumps(w)}")
        log(f"[kernels] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "e2e"
        t0 = time.perf_counter()
        engines, launches = run_e2e(dev, cfg, params, xvector)
        log(f"[e2e] ok ({time.perf_counter() - t0:.2f} s)")

        if args.profile:
            phase = "profile"
            t0 = time.perf_counter()
            run_profile(engines)
            log(f"[profile] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "report"
        by_fn = {"log_mel": "log_mel_frames",
                 "flash_attention_fwd": "flash_attention",
                 "conv_module": "fused_conv_module",
                 "q_matmul_w8a16": "quantized_matmul",
                 "q8a8_matmul": "quantized_matmul_a8"}
        line = {"kernels": [
            {"name": k["name"], "route": k["route"], "source": k["source"],
             "replaces": k["replaces"], "launches": launches[by_fn[k["name"]]],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
             "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
            for k in kernels]}
        log(f"[report] total {time.perf_counter() - t_start:.2f} s")
        print(json.dumps(line), flush=True)
        print(nvidia_smi_line(), flush=True)
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase {phase!r} failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
