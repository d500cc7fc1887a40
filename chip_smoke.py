#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``omnilingual_asr_torch``).

Run from the repository root on a machine with one NVIDIA H100 SXM:

    python3 chip_smoke.py              # phases 1-5
    python3 chip_smoke.py --profile    # and, before the report, phase 4b

Phases, each printed with its elapsed seconds; any failure exits non-zero
with no result line:

1. device  - card name and power limit; TF32 off for matmuls and cuDNN.
2. build   - nvcc builds the kernels from ``omnilingual_asr_torch/csrc``.
3. kernels - log-mel (K1), flash attention (K2) and the fused conv module
             (K3) at the main path's shapes on seeded inputs with masked
             rows, each held against its plain PyTorch version, and timed
             by CUDA events beside its plain version, a PyTorch yardstick
             where one exists, and the card's bound.
4. e2e     - ``TranscriptionEngine`` on the card with the release weights
             answers three ``transcribe`` requests (the golden fixture, the
             same audio tiled to two minutes = one full batch of 4 windows,
             and that again warm); the golden result is held to the JAX
             engine's stored result, and the kernel launch counters show
             that the requests ran through K1-K3.
4b. profile - (``--profile`` only) median request seconds over 3 warm runs
             and the StageTrace stages at 30, 120 and 330 s of audio (1, 1
             and 3 batches), then one warm 120 s request under
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

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): f32 on
# the CUDA cores, bf16 on the tensor cores, and HBM3 bandwidth. The SXM
# part names itself "NVIDIA H100 80GB HBM3".
H100_SXM_PEAKS = {"f32": 67e12, "bf16": 989e12, "bytes": 3.35e12}

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


def time_ms(fn, n: int = N_TIMED) -> float:
    """Median milliseconds of ``fn()`` over n runs, by CUDA events."""
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
        "plain_ms": time_ms(lambda: conv_module_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"x [{B}, {T}, {D}] f32, K {K}",
        "gflop": (pw_flops + dw_flops) / 1e9,
    }


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


def run_e2e(dev, cfg, params, xvector):
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.ops.attention import flash_attention
    from omnilingual_asr_torch.ops.conv_module import fused_conv_module
    from omnilingual_asr_torch.ops.mel import log_mel_frames

    counters = (log_mel_frames, flash_attention, fused_conv_module)
    engine = TranscriptionEngine(config=cfg, params=params,
                                 xvector_params=xvector, device=dev)
    tiled = PKG / "_build" / "smoke_tiled.wav"
    tiled_s = write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    requests = [("golden", golden.GOLDEN_WAV), ("tiled", tiled),
                ("tiled-warm", tiled)]
    n_batches = 0
    for _, path in requests:
        with wave.open(str(path), "rb") as w:
            n_win = math.ceil(w.getnframes() / engine.window_samples)
        n_batches += math.ceil(n_win / engine.batch_size)

    for fn in counters:
        fn.launches = 0
    results, report = [], []
    for name, path in requests:
        steps = []
        t0 = time.perf_counter()
        res = engine.transcribe(path,
                                progress_callback=lambda s, i: steps.append(i))
        secs = time.perf_counter() - t0
        tr = engine.last_trace
        results.append(res)
        report.append({"request": name, "seconds": secs,
                       "audio_seconds": tr.audio_seconds,
                       "segments": len(res.segments),
                       "stages": {k: round(v, 4)
                                  for k, v in tr.stages.items()}})
        if steps != [0, 1, 2, 3]:
            raise PhaseError(f"progress steps {steps} for {name}")
    launches = {fn.__name__: fn.launches for fn in counters}
    for r in report:
        log(f"  request {json.dumps(r)}")
    log(f"  launches {json.dumps(launches)} over {n_batches} batches")

    want_launch = {"log_mel_frames": n_batches,
                   "flash_attention": cfg.encoder.n_layers * n_batches,
                   "fused_conv_module": cfg.encoder.n_layers * n_batches}
    for name, n in want_launch.items():
        if launches[name] < n:
            raise PhaseError(f"{name} launched {launches[name]} times on the "
                             f"main path, expected at least {n}")

    stored = golden.load_golden()
    bad = golden.result_mismatches(stored["result"], results[0].to_dict())
    if bad:
        raise PhaseError("golden result mismatch: " + "; ".join(bad))
    samples = engine._load_audio(golden.GOLDEN_WAV)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    ids = [o["ctc_ids"].astype(int).tolist()
           for outs in engine._forward_batches(windows, n_last) for o in outs]
    agree = golden.ctc_agreement(stored["ctc_ids"], ids)
    log(f"  golden: {len(results[0].segments)} segments match the JAX "
        f"result; greedy CTC ids agree on {agree:.4%} of frames")
    if agree < golden.MIN_CTC_AGREEMENT:
        raise PhaseError(f"CTC id agreement {agree:.4f} < "
                         f"{golden.MIN_CTC_AGREEMENT}")
    for res in results[1:]:
        if not res.segments:
            raise PhaseError("tiled request returned no segments")
        for s in res.segments:
            if not (0.0 <= s.start < s.end <= tiled_s + 1.0):
                raise PhaseError(f"segment times {s.start}-{s.end} outside "
                                 f"[0, {tiled_s}]")
    if ([s.text for s in results[1].segments]
            != [s.text for s in results[2].segments]):
        raise PhaseError("the warm repeat of the tiled request differs")
    return engine, launches


# ---------------------------------------------------------------------------
# Phase 4b (--profile): where a request's time goes
# ---------------------------------------------------------------------------

def run_profile(engine) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from omnilingual_asr_torch import testing as golden

    work = PKG / "_build" / "profile"
    paths = {}
    for seconds in PROFILE_SECONDS:
        path = work / f"t{int(seconds)}.wav"
        write_tiled_wav(golden.GOLDEN_WAV, path, seconds)
        paths[seconds] = path
        engine.transcribe(path)                   # warm-up
        times = []
        for _ in range(PROFILE_WARM_RUNS):
            t0 = time.perf_counter()
            engine.transcribe(path)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log("  profile " + json.dumps({
            "audio_s": seconds, "request_s_median": med,
            "request_s_all": times, "rtf": seconds / med,
            "stages_last": {k: round(v, 5)
                            for k, v in engine.last_trace.stages.items()}}))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.transcribe(paths[120.0])
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
        log("  profiler: no device time recorded (not measured)")
        return
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    log(f"  profile 120 s request: wall {wall * 1e3:.3f} ms, device "
        f"{total_ms:.3f} ms in {sum(r[1] for r in rows)} device events, "
        f"device busy share {total_ms / 1e3 / wall:.3f}")
    for dev_us, count, key in rows[:15]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


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
                   check_k3(dev, peaks, cfg, params)]
        for k in kernels:
            log(f"  {k['name']}: max abs err {k['max_abs_err']:.3e} (tol "
                f"{k['tol']}), {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
                f"ms, library {k['library_ms']}, bound {k['bound_ms']:.4f} "
                f"ms ({k['bound_by']}), {k['shape']}")
        log(f"[kernels] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "e2e"
        t0 = time.perf_counter()
        engine, launches = run_e2e(dev, cfg, params, xvector)
        log(f"[e2e] ok ({time.perf_counter() - t0:.2f} s)")

        if args.profile:
            phase = "profile"
            t0 = time.perf_counter()
            run_profile(engine)
            log(f"[profile] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "report"
        by_fn = {"log_mel": "log_mel_frames",
                 "flash_attention_fwd": "flash_attention",
                 "conv_module": "fused_conv_module"}
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
