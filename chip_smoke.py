#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``omnilingual_asr_torch``).

Run from the repository root on a machine with one NVIDIA H100 SXM:

    python3 chip_smoke.py              # phases 1-5 (4, 4b, 4d-4h)
    python3 chip_smoke.py --profile    # and, before the report, phase 4c

Phases, each printed with its elapsed seconds; any failure exits non-zero
with no result line:

1. device  - card name and power limit; TF32 off for matmuls and cuDNN.
2. build   - nvcc builds the kernels from ``omnilingual_asr_torch/csrc``
             and each kernel's registers and spills are printed.
3. kernels - log-mel (K1, at the serving, the training path's and the
             crop re-embedding's frames, [16 x 768], the eval
             drivers' [4 x 1024] and [1 x 3072], and the trainers'
             [64 x 512], [64 x 1024] and [16 x 1024]; its bound counted for
             the function as an FFT computes it, the dense DFT's beside
             it), flash attention (K2, at head dims 64 and 128, at the
             training shape, at a ragged T of 200, at the d512 seed's
             [4, 768, 8, 64] and at the eval drivers' [4, 256, 4, 64] and
             [1, 768, 8, 64]), the fused conv module (K3, at the serving
             and the training shape, at large_config's width, D 1024, at
             the d512 seed's [4, 768, 512] and at the eval drivers'
             [4, 256, 256] and [1, 768, 512], each with its launch plan:
             both launches' blocks and pw1's rows a frame), the int8 matmuls W8A16 (K4) and W8A8 (K5, at the
             three widths of the quantized main path) and the
             flash-attention backward, dQ (K6) and dK/dV (K7), at the
             training shape, at large_config's head dim 128 and at a
             ragged T of 200 (with the o and lse they read held to the
             plain forward), on seeded inputs
             with masked rows, each held against its plain
             PyTorch version, and timed beside its plain version, a PyTorch
             yardstick where one exists, and the card's bound. Times are
             device times: 20 calls captured back to back in a CUDA graph,
             replayed between CUDA events (``call_ms`` adds one eager
             call's time, host launch included). K3's, K4's and K5's
             entries carry their kernels' registers; their previous
             design's recorded times (RECORDED_EARLIER_MS, not measured
             here) follow on a line of their own.
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
4b. train  - ``train_synth`` (the port's ``python -m
             omnilingual_asr_torch.train.synth_train --pallas-kernels``
             path) runs 4 steps at ``PipelineConfig()`` dims (d_model 512,
             12 layers, 8 heads), batch 16 of 8 s windows, from a seeded
             init: per step the loss and metrics, the step's seconds, the
             host's wait for ``SynthBatcher`` and the kernel launches
             (exactly K1 1, K2 12, K6 12, K7 12, K3 12, K4/K5 0), then the
             held-out evaluation. Then a gradient check: one batch of 2
             windows through the kernels on the card against the same step
             on the CPU (plain versions), leaf by leaf, beside the card's
             own floor and a planted fault that must miss the tolerance.
4d. decoders - ``TranscriptionEngine`` on the card with the release
             translator (text mode) and fact-conditioned summarizer given
             by explicit path answers the golden file and the tiled file,
             with the same K1-K3 launches a batch as phase 4. The golden
             result (translations and the neural summary included) is held
             to the JAX engine's ``golden_decoders.json``, and its decodes'
             tokens to the JAX engine's; every decode, replayed from its
             CUDA graph, is held to the same decode run eagerly. Then the
             decoders' seconds a request (warm, 3 rounds, graphs on and off
             in turns) beside the StageTrace's ``assemble.translate`` and
             ``assemble.summary``.
4e. server - the port's HTTP server (``serving/app.py``'s ``OmniServer``)
             in front of phase 4d's engine, on 127.0.0.1 with SQLite
             history. The native ``omniaudio`` library must have been built
             from the port's source under ``_build/`` (the phase fails on
             the Python fallback); it and the Python parser decode the
             tiled 120 s and 330 s files to equal samples, both timed.
             Then: ``/api/transcribe`` on the golden file, held to
             ``golden_decoders.json``; ``/api/transcribe-stream`` on the
             120 s file (progress steps, one result); the 44.1 kHz stereo
             golden audio and the 330 s file served alone (and an MP3 of
             the golden audio where libav is linked and ffmpeg can make
             one); the K1-K3 launches over those serial requests; the
             same files at once on ``/api/transcribe-batch-stream`` (the
             stereo one inside a .zip), each equal to the file served
             alone; ``/api/history`` and the five exports of every entry,
             each equal to ``export_transcript`` on the stored entry; the
             live route (``/api/transcribe-stream-live``) streaming the
             golden file, its result held to ``golden_decoders.json``.
             Then warm seconds through HTTP beside
             ``engine.transcribe`` (golden, 120 s), and the batch route's
             wall seconds under the engine's device lock, under a lock
             around whole requests, and served one after another.
4f. d512  - ``checkpoints/r5_d512x12_seed`` (d_model 512, 12 layers, 8
             heads, no x-vector) through ``config_for_checkpoint`` in crop
             speaker mode, greedy and with the beam search (beam 8, the
             "synth" lexicon, lm_alpha 0.3), answers the golden and the
             tiled file through ``transcribe`` and
             ``transcribe_streaming``, held to ``golden_d512_crop.json``
             (the beam texts of its stable decodes exact, the beam's
             top-K feed within ``testing.FEED_TOL`` of the JAX engine's,
             the search over the JAX feed giving every JAX text; every
             stream's final event equal to ``transcribe``'s); K1 launches a
             window batch and a crop batch ([16 x 768]), K2 and K3 12 a
             window batch. Then warm seconds (inline, crop and beam crop),
             the ``extract`` stage and the crop forward; the live route's
             first partial and final event against ``engine.transcribe``;
             the release engine with μ-law ingress and with the int8
             speaker wire at stride 2 on the golden file, held to the JAX
             engine's results in those modes; ``health_check``.
4g. evals  - the port's evaluation drivers (``omnilingual_asr_torch/
             eval/``) with the release weights, held to the JAX package's
             ``golden_evals.json`` (``testing.py``'s criteria):
             ``eval.synth`` on its 96 held-out files at 10 s windows (texts
             on at least 94, the files' greedy ids together on 99.5 %,
             WER and CER within 0.005), its first 32 files unquantized and
             under "w8" and "a8" (WER/CER, RTF, K4/K5 launches; reported,
             not held); ``eval.heads`` on 64 files and 8 conversations with
             the release translator and summarizer (languages and emotions
             equal but for one tied emotion, translation word accuracy
             within 0.01, summary accuracies equal); ``eval.diar`` on 16
             conversations (speaker counts equal on 15, each DER within
             0.02, the mean within 0.01); ``eval.long``'s engine on the
             420 s file (streamed; greedy ids on 99.5 %, the result's
             structure by ``testing.long_mismatches``: its tones are no
             speech, and the JAX result itself moves under 1-LSB noise);
             one K1, four K2 and four K3 launches a release batch. Then
             ``python -m omnilingual_asr_torch.eval.long --hours 1`` and
             ``eval.latency`` (d512 x 12, batch 1, 16 reps), each in a
             process of its own with the release discovered.
4h. trainers - the four trainers the release's other weight files come
             from, each through the port's own functions on the card from
             a seeded init: ``train_xvector`` (``PipelineConfig()``'s
             x-vector, 8 steps of 64 4 s windows, the 48-utterance eval at
             step 8), the text translator (``text_translator_train``, the
             release's dims, 20 steps of 128, 64 eval pairs a set), the
             audio translator (``translator_train``, a seeded decoder on
             the release ASR, 256 + 32 utterances, 20 steps of 64) and the
             summarizer (``summary_train`` on the release ASR, a pool of
             96, 64 + 8 conversations, 20 steps of 32). Each must give
             finite losses, exactly its K1 launches (one a x-vector step
             and eval batch, one a frozen-encoder batch of 64, one a
             conversation; no other kernel), one update on the card equal
             to the same update on the CPU (gradients within 5e-2 per
             leaf, the loss within 1e-3), and a file that the port's
             loaders read back equal. Each prints its steps per second,
             its seconds by part (host synthesis, encoding, steps, eval)
             and the card's peak memory. Then an engine with the trained
             x-vector, summarizer and each translator (text and audio
             mode) by explicit path answers the golden file: segments, a
             translation attempt on every non-English span, a summary.
4c. profile - (``--profile`` only) median request seconds over 3 warm runs
             and the StageTrace stages at 30, 120 and 330 s of audio (1, 1
             and 3 batches); 120 s requests of the unquantized, a8 and w8
             engines in 7 turns; then one warm 120 s request of each under
             ``torch.profiler``: device time by kernel and the device's
             busy share of the request's wall time, and the same for a
             120 s request of phase 4d's engine. Then a warm
             kernel-mode training step at ``PipelineConfig()`` dims, batch
             16: the host's batch wait, upload, forward + loss, backward
             and optimizer seconds, and one step under the profiler.
5. report  - one ``{"kernels": [...]}`` line (K1-K7; ``launches`` summed
             over the serving, training, decoders, server, d512, evals and
             trainers paths,
             by path beside it), the
             ``nvidia-smi`` name and power limit, and the result line
             ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
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
D512 = ROOT / "checkpoints" / "r5_d512x12_seed" / "asr.npz"
SEED = 1234
N_TIMED = 20
WINDOWS_PER_BATCH = 4
TILED_SECONDS = 120.0
PROFILE_SECONDS = (30.0, 120.0, 330.0)
PROFILE_WARM_RUNS = 3
INT8_ROUNDS = 7
DECODER_ROUNDS = 3       # warm requests a decoder mode in phase 4d
D512_ROUNDS = 3          # warm requests a d512 mode in phase 4f (medians)
TRAIN_STEPS = 4          # train_synth steps at PipelineConfig() dims
TRAIN_BATCH = 16         # 8 s windows a step
EVAL_WINDOW_SECONDS = 10.0  # eval.synth's windows (1024 frames, T' 256)
# Valid keys of the attention checks at the training shape (T' 256): 12
# whole rows, ragged, short, one valid key and a padded batch slot.
TRAIN_VALID_KEYS = [256] * 12 + [200, 77, 1, 0]

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
# Flash backward (K6, K7), per element |g - g_ref| <= ABS * max|g_ref| +
# 2^-7 |g_ref|: both round an f32 sum to bf16 (one ulp, 2^-8 relative,
# apart where they straddle a rounding boundary; 2^-7 covers the f32 sums
# differing on top of that), and the sums of p * (dp - delta) over up to
# 768 keys, whose terms cancel, are taken in another order, which ABS
# bounds relative to the largest element. Masked keys and fully-masked
# rows must be exactly 0. A dropped key or a wrong p moves g by ~|g|.
TOL_BWD_ABS = 2.0 ** -10
TOL_BWD_REL = 2.0 ** -7
# Training-step gradients on the card (K1-K3, K6, K7) against the same step
# on the CPU (plain versions), per leaf ||g - g_cpu|| / ||g_cpu||: q, k, v,
# o, dq, dk and dv are rounded to bf16 in both, from f32 sums taken in
# another order, so single elements differ by a bf16 ulp (2^-8) and the
# fused conv module's output by up to TOL_K3. Where such a difference flips
# a ReLU gate or a bf16 rounding of q or k, a gradient jumps: on the CPU
# tests' model a 1e-6 relative perturbation of the input moves single
# leaves by more than 1e-2 (tests/test_torch_train.py::
# test_kernel_mode_gradient_floor), so per-leaf errors of a few 1e-2 are
# the floor of the comparison, not a fault. The check prints the card's
# own floor (the same step with the parameters perturbed by 1e-6 relative)
# beside it, and plants a fault (delta dropped from the flash backward)
# whose reading must exceed the tolerance, or the check fails.
TOL_GRAD_REL = 5e-2
# K3's, K4's and K5's tolerances (TOL_K3, TOL_K4_ORDER with
# k4_error_share, TOL_K5_REL) and the shapes they are checked at are in
# omnilingual_asr_torch/ops/card_cases.py, which the tiling sweep reads too.
# The release layers that take K4/K5, by width N: the FFN up-projections
# (8 a batch), the CTC head and the LID head.
QUANT_LAYERS = {1024: ("blocks", 0, "ffn1", "w1"), 512: ("ctc_head",),
                2048: ("lid_head",)}
# Device ms of K3, K4 and K5 as designed before their current design (K3:
# 32 frames a block over 64 halo rows, both products as f32 FMAs on the
# CUDA cores; K5: every column tile re-quantizing its rows; K4: every
# column tile re-reading and re-rounding x, no cp.async, int8 widened a
# byte at a time), by D and by N at this script's shapes: the mean of two
# runs of this script at commit 622b750 (K3, K5) and a01c040 (K4) on an
# H100 80GB HBM3 at 700 W. Recorded, not measured by this run: logged on a
# line of its own after the kernel checks, and in no entry of the report.
RECORDED_EARLIER_MS = {"conv_module": {256: 0.1515119969844818,
                                       512: 0.5420583963394165,
                                       1024: 2.0611288070678713},
                       "q_matmul_w8a16": {512: 0.012005599960684777,
                                          1024: 0.01729839965701103,
                                          2048: 0.03151520043611526},
                       "q8a8_matmul": {512: 0.01579599976539612,
                                       1024: 0.027265599370002745,
                                       2048: 0.04393839985132217}}


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


def time_ms(fn, n: int = N_TIMED, reps: int = 5, stream=None) -> float:
    """Device milliseconds of one ``fn()``: n calls captured back to back in
    one CUDA graph, so that no host launch time sits between them, and the
    graph replayed ``reps`` times between CUDA events; the median replay
    over n. Every kernel, plain version and yardstick is timed this way.
    ``stream``: warm up and capture on it (a backward pass runs on the
    stream of its forward, so an autograd call is timed on that one)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
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
    """K1 at the serving path's shape (a batch of 4 x 30 s windows: 3072
    frames each, 2998 valid), and under "shapes" at the training path's
    (batch 16 of 8 s windows padded to 1024 frames, 798 valid), the
    crop re-embedding's (16 crops of 6 s padded to 768 frames, 598
    valid), eval.synth's (4 x 10 s windows: 1024 frames, 998 valid),
    eval.latency's (one 30 s window) and the trainers'
    (``card_cases.K1_TRAINER_SHAPES``)."""
    from omnilingual_asr_torch.engine import (SPK_CROP_BATCH,
                                              SPK_CROP_SECONDS)
    from omnilingual_asr_torch.ops import card_cases

    main = _k1_case(dev, peaks, cfg, WINDOWS_PER_BATCH, 3072, 2998, SEED)
    train = _k1_case(dev, peaks, cfg, TRAIN_BATCH, 1024, 798, SEED + 13)
    crop_frames = cfg.frontend.frames_for_samples(
        int(SPK_CROP_SECONDS * cfg.frontend.sample_rate))
    crop = _k1_case(dev, peaks, cfg, SPK_CROP_BATCH,
                    math.ceil(crop_frames / 256) * 256, crop_frames,
                    SEED + 17)
    # The eval drivers': eval.synth's 10 s windows (998 frames padded to
    # 1024) and eval.latency's one 30 s window at batch 1.
    eval10 = _k1_case(dev, peaks, cfg, WINDOWS_PER_BATCH, 1024,
                      cfg.frontend.frames_for_samples(
                          int(EVAL_WINDOW_SECONDS
                              * cfg.frontend.sample_rate)), SEED + 20)
    lat = _k1_case(dev, peaks, cfg, 1, 3072, 2998, SEED + 21)
    # The trainers' (phase 4h): the x-vector's 64 4 s windows, the audio
    # translator's 64 8 s utterances, the summarizer's 16 8 s windows.
    trainers = [_k1_case(dev, peaks, cfg, B, t_pad, valid, SEED + 22 + i)
                for i, (B, t_pad, valid) in enumerate(
                    card_cases.K1_TRAINER_SHAPES.values())]
    return {"name": "log_mel", "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/mel.cu",
            "replaces": "omnilingual_asr_tpu/ops/mel_pallas.py:66",
            **main, "shapes": [main, train, crop, eval10, lat, *trainers]}


def _k1_case(dev, peaks, cfg, B, t_pad, n_frames, seed):
    import torch
    from omnilingual_asr_torch.audio.frontend import hann_window
    from omnilingual_asr_torch.ops.mel import (MelFrontend, log_mel_frames,
                                               log_mel_frames_plain)

    fe_cfg = cfg.frontend
    fe = MelFrontend(fe_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = 0.1 * torch.randn(B, t_pad, fe_cfg.n_fft, generator=gen,
                               device=dev)
    frames[:, n_frames:] = 0.0            # padding rows, as on the main path
    frames = frames.reshape(-1, fe_cfg.n_fft).contiguous()
    floor = fe_cfg.log_floor
    plan = fe.plan
    got = log_mel_frames(frames, fe.cw, fe.sw, fe.fb, floor, plan)
    want = log_mel_frames_plain(frames, fe.cw, fe.sw, fe.fb, floor)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > TOL_K1:
        raise PhaseError(f"K1 log-mel {B} x {t_pad} frames: max abs err "
                         f"{err:.3e} > {TOL_K1}")
    # Yardstick: the same function through cuFFT (rfft of the windowed
    # frames), the library's way to a power spectrum.
    win = torch.zeros(fe_cfg.n_fft, device=dev)
    win[:fe_cfg.win_length] = torch.from_numpy(
        hann_window(fe_cfg.win_length)).to(dev)

    def library():
        spec = torch.fft.rfft(frames * win, n=fe_cfg.n_fft, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.log(torch.clamp(power @ fe.fb, min=floor))

    lib_err = float((library() - want).abs().max())
    n, n_fft = frames.shape
    n_mels = fe.fb.shape[1]
    n_bins = fe_cfg.n_freqs
    # The function as computed with a real FFT: ~2.5 n log2 n FLOP a frame,
    # plus the mel projection over the filterbank's nonzero weights (one
    # FMA each). Bytes it must move: the frames' samples under the window
    # (zero past it, so the rest cannot change the result), fb and the
    # output. The dense DFT's count (the TPU's algorithm, and this row's
    # yardstick before the FFT kernel) is kept beside it.
    fft_flops = n * (2.5 * n_fft * math.log2(n_fft) + 2 * plan.n_weights)
    n_win = plan.window.shape[0]
    b_ms, b_by = bound({"f32": fft_flops},
                       n * n_win * 4 + nbytes(fe.fb, got), peaks)
    dft_flops = 2 * n * n_fft * n_bins * 2 + 2 * n * n_bins * n_mels
    dft_ms, _ = bound({"f32": dft_flops},
                      nbytes(frames, fe.cw, fe.sw, fe.fb, got), peaks)
    all_ms, _ = bound({"f32": fft_flops}, nbytes(frames, fe.fb, got), peaks)
    return {
        "max_abs_err": err, "tol": TOL_K1,
        "ms": time_ms(lambda: log_mel_frames(frames, fe.cw, fe.sw, fe.fb,
                                             floor, plan)),
        "call_ms": call_ms(lambda: log_mel_frames(frames, fe.cw, fe.sw,
                                                  fe.fb, floor, plan)),
        "plain_ms": time_ms(lambda: log_mel_frames_plain(
            frames, fe.cw, fe.sw, fe.fb, floor)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library), "library_max_abs_err": lib_err,
        "shape": f"frames {list(frames.shape)} f32 ({B} x {t_pad}, "
                 f"{n_frames} valid) -> [{n}, {n_mels}]",
        "gflop": fft_flops / 1e9,
        "bound_all_samples_ms": all_ms,
        "dense_dft_gflop": dft_flops / 1e9, "dense_dft_bound_ms": dft_ms,
    }


def _flash_inputs(dev, B, T, H, D, n_valid, seed, n=3):
    """n seeded bf16 [B, T, H, D] tensors and the key mask of ``n_valid``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(B, T, H, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(n)]
    nv = torch.tensor(n_valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < nv[:, None]
    return xs, mask, nv


def _check_fwd(label, q, k, v, mask, o, lse):
    """K2's (o, lse) against ``flash_attention_plain`` on the same inputs:
    per element within TOL_K2_ABS + TOL_K2_REL |o_ref|, lse within
    TOL_K2_LSE on live rows, and on a fully masked row lse exactly +1e30
    and o exactly 0. Returns (max abs err of o, its largest share of the
    tolerance, max abs err of lse)."""
    import torch
    from omnilingual_asr_torch.ops.attention import flash_attention_plain

    o_ref, lse_ref = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (o.float() - o_ref.float()).abs()
    err = float(diff.max())
    # Largest share of its own tolerance that any element uses (<= 1 passes).
    tol_share = float((diff / (TOL_K2_ABS + TOL_K2_REL
                               * o_ref.float().abs())).max())
    live = lse_ref < 1e29
    lse_err = float((lse - lse_ref)[live].abs().max())
    dead_row = ~mask.any(dim=1)
    dead_ok = bool((lse[~live] == 1e30).all()) and bool(
        (o[dead_row].float() == 0).all())
    if (tol_share > 1.0 or lse_err > TOL_K2_LSE or not dead_ok
            or not bool(torch.isfinite(o.float()).all())):
        raise PhaseError(f"K2 flash attention {label}: o err {err:.3e} uses "
                         f"{tol_share:.2f} of its tolerance, lse err "
                         f"{lse_err:.3e} (tol {TOL_K2_LSE}), masked rows ok: "
                         f"{dead_ok}")
    return err, tol_share, lse_err


def _k2_case(dev, peaks, B, T, H, D, n_valid, seed):
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops.attention import (flash_attention,
                                                     flash_attention_plain)

    (q, k, v), mask, n_valid_t = _flash_inputs(dev, B, T, H, D, n_valid,
                                               seed)
    o, lse = flash_attention(q, k, v, mask)
    err, tol_share, lse_err = _check_fwd(f"{[B, T, H, D]}", q, k, v, mask,
                                         o, lse)
    # Yardstick: scaled_dot_product_attention with the same key mask (its
    # fully-masked slot is not comparable and is not checked).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    amask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    # Work this run's data needs: every query row against its valid keys.
    flops = 4 * H * D * T * int(n_valid_t.sum())
    b_ms, b_by = bound({"bf16": flops},
                       nbytes(q, k, v, mask.to(torch.int32), o, lse), peaks)
    return {
        "D": D, "max_abs_err": err, "lse_max_abs_err": lse_err,
        "tol": f"{TOL_K2_ABS} + {TOL_K2_REL} |o|, max share {tol_share:.3f}",
        "ms": time_ms(lambda: flash_attention(q, k, v, mask)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v, mask)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library),
        "shape": f"q/k/v [{B}, {T}, {H}, {D}] bf16, valid keys {n_valid}",
        "gflop": flops / 1e9,
    }


def check_k2(dev, peaks, cfg):
    """K2 at the serving path's shape (the release: head dim 64), and under
    "head_dims" also at large_config's head dim 128 (8 heads of 128), at
    the training path's shape (batch 16 of 8 s windows: T' 256, 8 heads of
    64), at the d512 seed's serving batch (T' 768, 8 heads of 64), at
    eval.synth's 10 s windows (T' 256, the release's heads) and at
    eval.latency's batch 1 (T' 768, 8 heads of 64). Rows whole, ragged
    (partial last key tile), short (whole key tiles masked) and a padded
    batch slot (every key masked)."""
    from omnilingual_asr_torch.config import PipelineConfig

    H = cfg.encoder.n_heads
    main = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 768, H,
                    cfg.encoder.d_model // H, [768, 700, 300, 0], SEED + 1)
    wide = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 768, 8, 128,
                    [768, 700, 300, 0], SEED + 11)
    enc = PipelineConfig().encoder
    train = _k2_case(dev, peaks, TRAIN_BATCH, 256, enc.n_heads,
                     enc.head_dim, TRAIN_VALID_KEYS, SEED + 14)
    # T not a multiple of the 64-key tile, a partly masked row and a fully
    # masked slot: the tiles' zero-filled edges.
    ragged = _k2_case(dev, peaks, 3, 200, 4, 64, [200, 130, 0], SEED + 15)
    d512 = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 768, 8, 64,
                    [768, 700, 300, 0], SEED + 18)
    # eval.synth's batch of 10 s windows at the release width (T' 256: one
    # window whole, three ragged or padded) and eval.latency's flagship
    # d512 x 12 at batch 1 (749 of 768 frames valid).
    eval10 = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 256, H,
                      cfg.encoder.d_model // H, [249, 200, 77, 0],
                      SEED + 22)
    lat = _k2_case(dev, peaks, 1, 768, enc.n_heads, enc.head_dim, [749],
                   SEED + 23)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/attention.cu",
            "replaces": "omnilingual_asr_tpu/ops/attention.py:34",
            **main, "head_dims": [main, wide, train, ragged, d512, eval10,
                                  lat]}


def _bwd_case(dev, peaks, B, T, H, D, n_valid, seed):
    """K6 and K7 on one shape against their plain versions; SDPA's
    backward (forward outside the timed region) as the pair's yardstick."""
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops import attention as A

    (q, k, v, do), mask, nv = _flash_inputs(dev, B, T, H, D, n_valid, seed,
                                            n=4)
    o, lse = A.flash_attention(q, k, v, mask)
    # K6 and K7 read K2's lse: hold it (and o) to the plain forward first.
    fwd = _check_fwd(f"{[B, T, H, D]} (backward's inputs)", q, k, v, mask,
                     o, lse)
    delta = A.flash_delta(o, do)
    args = (q, k, v, mask, do, lse, delta)
    dq = A.flash_attention_bwd_dq(*args)
    dk, dv = A.flash_attention_bwd_dkv(*args)
    dq_ref = A.flash_attention_bwd_dq_plain(*args)
    dk_ref, dv_ref = A.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    out = {}
    dead_key, dead_row = ~mask, ~mask.any(dim=1)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        share = float((diff / (TOL_BWD_ABS * w.abs().max()
                               + TOL_BWD_REL * w.abs())).max())
        zeros_ok = (bool((got[dead_row] == 0).all()) if name == "dq"
                    else bool((got[dead_key] == 0).all()))
        if share > 1.0 or not zeros_ok or not bool(torch.isfinite(g).all()):
            raise PhaseError(f"{name} D={D}: max abs err "
                             f"{float(diff.max()):.3e} uses {share:.2f} of "
                             f"its tolerance; masked entries exactly 0: "
                             f"{zeros_ok}")
        out[name] = (float(diff.max()), share)

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    amask = mask[:, None, None, :]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    def library():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    try:
        lib_ms = time_ms(library, stream=stream)
    except RuntimeError as e:     # the yardstick only; the port never calls it
        log(f"  SDPA backward could not be timed in a CUDA graph ({e}); "
            f"library_ms null")
        lib_ms = None
    work = H * T * D * int(nv.sum())
    io = nbytes(q, k, v, do, mask.to(torch.int32), lse, delta)
    b6 = bound({"bf16": 6 * work}, io + nbytes(dq), peaks)
    b7 = bound({"bf16": 8 * work}, io + nbytes(dk, dv), peaks)
    shape = f"q/k/v/dO [{B}, {T}, {H}, {D}] bf16, valid keys {n_valid}"
    k6 = {"D": D, "max_abs_err": out["dq"][0],
          "k2_o_max_abs_err": fwd[0], "k2_lse_max_abs_err": fwd[2],
          "tol": f"{TOL_BWD_ABS} max|ref| + {TOL_BWD_REL} |ref|, max share "
                 f"{out['dq'][1]:.3f}",
          "ms": time_ms(lambda: A.flash_attention_bwd_dq(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dq(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dq_plain(*args)),
          "bound_ms": b6[0], "bound_by": b6[1], "library_ms": lib_ms,
          "library": "SDPA backward (dQ, dK, dV together), forward "
                     "outside the timed region",
          "shape": shape, "gflop": 6 * work / 1e9}
    k7 = {"D": D, "max_abs_err": max(out["dk"][0], out["dv"][0]),
          "tol": f"{TOL_BWD_ABS} max|ref| + {TOL_BWD_REL} |ref|, max share "
                 f"dk {out['dk'][1]:.3f}, dv {out['dv'][1]:.3f}",
          "ms": time_ms(lambda: A.flash_attention_bwd_dkv(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dkv(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dkv_plain(
              *args)),
          "bound_ms": b7[0], "bound_by": b7[1], "library_ms": None,
          "shape": shape, "gflop": 8 * work / 1e9}
    return k6, k7


def check_flash_bwd(dev, peaks, cfg):
    """K6 and K7 at the training path's shape (batch 16 of 8 s windows:
    T' 256, 8 heads of 64; rows whole, ragged, short and one padded slot)
    and, under "head_dims", at large_config's (B 4, T 768, 8 heads of 128)
    and at a T of 200 (a partial last tile of queries and keys, a partly
    masked row and a fully masked slot)."""
    enc = cfg.encoder
    train = _bwd_case(dev, peaks, TRAIN_BATCH, 256, enc.n_heads,
                      enc.head_dim, TRAIN_VALID_KEYS, SEED + 21)
    wide = _bwd_case(dev, peaks, WINDOWS_PER_BATCH, 768, 8, 128,
                     [768, 700, 300, 0], SEED + 22)
    ragged = _bwd_case(dev, peaks, 3, 200, 4, 64, [200, 130, 0], SEED + 23)
    entries = []
    for i, (name, line) in enumerate((
            ("flash_attention_bwd_dq", 79), ("flash_attention_bwd_dkv", 110))):
        entries.append({
            "name": name, "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/attention_bwd.cu",
            "replaces": f"omnilingual_asr_tpu/ops/attention.py:{line}",
            **train[i], "head_dims": [train[i], wide[i], ragged[i]]})
    return entries


def check_k3(dev, peaks, cfg, params, ptxas):
    """K3 at the serving path's shape with the release weights, and at the
    training path's (batch 16, T' 256, D 512, random weights),
    large_config's width ([4, 256, 1024], random weights) and the d512
    seed's serving batch ([4, 768, 512], its block 0 weights),
    eval.synth's 10 s windows ([4, 256, 256], release weights) and
    eval.latency's batch 1 ([1, 768, 512], random weights) under
    "shapes"; each with its launch plan (blocks of each stage, rows pw1
    runs over per output frame). The shapes are card_cases.K3_SHAPES."""
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models.layers import convmod_init
    from omnilingual_asr_torch.ops.card_cases import K3_SHAPES

    p = params["blocks"][0]["conv"]          # release weights
    main = _k3_case(dev, peaks, K3_SHAPES["serving"], p, SEED + 2)
    enc = PipelineConfig().encoder
    pt = convmod_init(torch.Generator().manual_seed(SEED),
                      enc.d_model, enc.conv_kernel)
    pt = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
              else v.to(dev)) for k, v in pt.items()}
    train = _k3_case(dev, peaks, K3_SHAPES["training"], pt, SEED + 12)
    # large_config's width (d_model 1024), which a kernel-mode training run
    # at that width launches.
    pw = convmod_init(torch.Generator().manual_seed(SEED + 1), 1024,
                      enc.conv_kernel)
    pw = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
              else v.to(dev)) for k, v in pw.items()}
    wide = _k3_case(dev, peaks, K3_SHAPES["d1024"], pw, SEED + 16)
    from omnilingual_asr_torch.config import config_for_checkpoint
    from omnilingual_asr_torch.models.zoo import load_checkpoint

    p512 = load_checkpoint(D512, config_for_checkpoint(str(D512)),
                           dev)["blocks"][0]["conv"]
    d512 = _k3_case(dev, peaks, K3_SHAPES["d512"], p512, SEED + 19)
    # eval.synth's 10 s windows (release weights) and eval.latency's
    # flagship at batch 1 (seeded random weights, as that driver's).
    eval10 = _k3_case(dev, peaks, K3_SHAPES["eval10s"], p, SEED + 24)
    lat = _k3_case(dev, peaks, K3_SHAPES["latency"], pt, SEED + 25)
    return {"name": "conv_module", "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/conv_module.cu",
            "replaces": "omnilingual_asr_tpu/ops/conv_module.py:32",
            **main, "shapes": [main, train, wide, d512, eval10, lat],
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(("conv_stage1_kernel",
                                       "conv_stage2_kernel"))}}


def _k3_case(dev, peaks, shape, p, seed):
    import torch
    from omnilingual_asr_torch.ops import cuda_build
    from omnilingual_asr_torch.ops.card_cases import TOL_K3
    from omnilingual_asr_torch.ops.conv_module import (conv_module_plain,
                                                       fused_conv_module)

    B, T, D, valid = shape
    if p["dw"].shape[1] != D:
        raise PhaseError(f"K3: weights of width {p['dw'].shape[1]} for a "
                         f"case of width {D}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, D, generator=gen, device=dev)
    n_valid = torch.tensor(valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < n_valid[:, None]
    # pw1/pw2 in bf16, as the engine holds them for the kernel.
    pw1, pw2 = (p[k]["w"].to(torch.bfloat16) for k in ("pw1", "pw2"))
    args = (x, mask, p["ln"]["scale"], p["ln"]["bias"], pw1, p["dw"],
            p["dw_ln"]["scale"], p["dw_ln"]["bias"], pw2)
    got = fused_conv_module(*args)
    want = conv_module_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > TOL_K3:
        raise PhaseError(f"K3 conv module D={D}: max abs err {err:.3e} > "
                         f"{TOL_K3}")
    K = p["dw"].shape[0]
    plan = cuda_build.plan("omni_conv_module_plan", B, T, D)
    pw_flops = 2 * B * T * D * (2 * D + D)
    dw_flops = 2 * B * T * D * K
    b_ms, b_by = bound({"bf16": pw_flops, "f32": dw_flops},
                       nbytes(x, mask, got, pw1, pw2, p["dw"]) + 4 * 4 * D,
                       peaks)
    return {
        "D": D, "max_abs_err": err, "tol": TOL_K3,
        "mean_abs_err": float((got - want).abs().mean()),
        "ms": time_ms(lambda: fused_conv_module(*args)),
        "call_ms": call_ms(lambda: fused_conv_module(*args)),
        "plain_ms": time_ms(lambda: conv_module_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"x [{B}, {T}, {D}] f32, K {K}",
        "gflop": (pw_flops + dw_flops) / 1e9,
        "plan": {"stage1_blocks": plan[0], "stage2_blocks": plan[3],
                 "frames_a_block": plan[2],
                 "rows_per_frame": plan[1] / plan[2]},
    }


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_quant(dev, peaks, params, ptxas):
    """K4 and K5 at (3072, 256, N) for the quantized main path's widths, on
    the release layers of those widths (quantized as the engine quantizes
    them) and seeded activations with an outlier row. Returns the two
    kernels' entries, their numbers at N = 1024 (8 of the 10 launches a
    batch) and every width under "widths". The shapes are
    card_cases.K4_SHAPES (K5_SHAPES is the same), K5 on K4's inputs."""
    import torch
    from omnilingual_asr_torch.ops import quant
    from omnilingual_asr_torch.ops.card_cases import (K4_SHAPES, TOL_K5_REL,
                                                      k4_error_share)

    out = {"w8": [], "a8": []}
    for M, K, N in K4_SHAPES.values():
        leaf = _leaf(params, QUANT_LAYERS[N])
        if tuple(leaf["w"].shape) != (K, N):
            raise PhaseError(f"K4/K5: layer {QUANT_LAYERS[N]} is "
                             f"{tuple(leaf['w'].shape)}, not {(K, N)}")
        w_q, scale = quant.quantize_weight(leaf["w"])
        w_t = w_q.t().contiguous()
        bias = leaf["b"]
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
        err, share = k4_error_share(got, want, x, w_q, scale, bias)
        if share > 1.0 or not bool(torch.isfinite(got).all()):
            raise PhaseError(f"K4 W8A16 N={N}: max abs err {err:.3e} uses "
                             f"{share:.2f} of its per-element tolerance")
        again = quant.quantized_matmul(x, w_q, scale, bias, w_t)
        if not torch.equal(got, again):
            raise PhaseError(f"K4 W8A16 N={N}: two calls on the same inputs "
                             f"differ")
        xb16, wb16 = x.to(torch.bfloat16), w_q.to(torch.bfloat16)

        def lib_w8():
            return torch.mm(xb16, wb16, out_dtype=torch.float32)

        b_ms, b_by = bound({"bf16": flops}, n_bytes, peaks)
        out["w8"].append({
            "N": N, "max_abs_err": err,
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
            "library": "GEMM only: torch.mm(out_dtype=float32) on bf16 "
                       "copies made beforehand; leaves out the f32 -> bf16 "
                       "rounding of x, the int8 widening, the scale and the "
                       "bias",
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
        head = next(w for w in out[mode] if w["N"] == 1024)
        entries.append({
            "name": name, "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/quant.cu",
            "replaces": src_line,
            **{k: head[k] for k in ("max_abs_err", "tol", "ms", "call_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "ptxas": {k: v for k, v in ptxas.items()
                      if k in {"w8": ("bf16_rows_kernel", "q_matmul_kernel"),
                               "a8": ("quantize_rows_kernel",
                                      "q8a8_matmul_kernel")}[mode]},
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
    from omnilingual_asr_torch.ops.attention import (flash_attention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from omnilingual_asr_torch.ops.conv_module import fused_conv_module
    from omnilingual_asr_torch.ops.mel import log_mel_frames
    from omnilingual_asr_torch.ops.quant import (quantized_matmul,
                                                 quantized_matmul_a8)

    return (log_mel_frames, flash_attention, fused_conv_module,
            quantized_matmul, quantized_matmul_a8, flash_attention_bwd_dq,
            flash_attention_bwd_dkv)


def _read_counters(reset: bool = True) -> dict:
    counts = {}
    for fn in _counters():
        counts[fn.__name__] = fn.launches
        if reset:
            fn.launches = 0
    return counts


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
                   "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
                   "flash_attention_bwd_dkv": 0}
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
# Phase 4d: the decoders (text-mode translator, fact-conditioned summarizer)
# ---------------------------------------------------------------------------

def _timed_decoders(engine, calls) -> dict:
    """Wrap the engine's two decoders so that each call's seconds (host
    clock; a decode ends in a device-to-host copy) and inputs are kept in
    ``calls``: {"translate": [...], "summary": [...]} of (seconds, args,
    kwargs, tokens). Returns the unwrapped decode functions by key."""
    dec = {"translate": (engine._translator, "translate_text"),
           "summary": (engine._summarizer.decoder, "decode")}
    plain = {}
    for key, (obj, name) in dec.items():
        fn = plain[key] = getattr(obj, name)

        def timed(*args, _fn=fn, _key=key, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs).cpu()
            calls[_key].append((time.perf_counter() - t0, args, kwargs, out))
            return out

        setattr(obj, name, timed)
    return plain


def _set_graphs(engine, on: bool) -> None:
    engine._translator.use_graph = on
    engine._summarizer.decoder.use_graph = on


def run_decoders(dev, cfg, params, xvector):
    """``TranscriptionEngine`` on the card with the release translator and
    summarizer given by explicit path answers the golden and the tiled
    file; the golden result is held to ``golden_decoders.json`` and the
    K1-K3 launches to the main path's counts; every decode's CUDA-graph
    tokens are held to the same decode run eagerly; then the decoders'
    seconds a request, warm, with the graphs and without. Returns the
    launches of this path."""
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine

    L = cfg.encoder.n_layers
    tiled = PKG / "_build" / "smoke_tiled.wav"
    tiled_s = write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    engine = TranscriptionEngine(
        config=cfg, params=params, xvector_params=xvector, device=dev,
        translator_path=str(RELEASE / "translator.npz"),
        summarizer_path=str(RELEASE / "summarizer.npz"))
    if not (engine._translator.is_text and engine._translator.use_graph
            and engine._summarizer.fact_conditioned):
        raise PhaseError("the release decoders did not load as the text "
                         "translator and the fact-conditioned summarizer "
                         "with CUDA graphs")
    calls = {"translate": [], "summary": []}
    plain = _timed_decoders(engine, calls)
    per_batch = {"log_mel_frames": 1, "flash_attention": L,
                 "fused_conv_module": L, "quantized_matmul": 0,
                 "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0}
    results, launches = drive_path(
        "decoders",
        lambda path, cb: engine.transcribe(path,
                                           progress_callback=cb).to_dict(),
        engine, [("golden", golden.GOLDEN_WAV), ("tiled", tiled)],
        per_batch)
    stored = golden.load_golden_decoders()
    bad = golden.result_mismatches(stored["result"], results[0],
                                   tone_mass=stored["tone_mass"])
    if results[0]["summary"] != stored["result"]["summary"]:
        bad.append(f"summary {results[0]['summary']!r}")
    if bad:
        raise PhaseError("decoders: golden result mismatch: "
                         + "; ".join(bad))
    check_segment_times("decoders", results[1:], tiled_s)
    if not all(s["translation"] for r in results for s in r["segments"]
               if s["language_code"] != "en"):
        raise PhaseError("decoders: a non-English segment has no "
                         "translation")
    # The golden request's decodes: the tokens of the JAX engine's
    # decodes, and the same decodes run eagerly.
    (_, args, kwargs, toks), = calls["translate"][:1]
    want = [t["tokens"] for t in stored["translations"]]
    if toks[:len(want)].tolist() != want:
        raise PhaseError("decoders: the golden spans' tokens differ from "
                         "the JAX engine's")
    if calls["summary"][0][3][0].tolist() != stored["summary"]["tokens"]:
        raise PhaseError("decoders: the golden summary's tokens differ "
                         "from the JAX engine's")
    n_tokens = 0
    _set_graphs(engine, False)
    for key, fn in plain.items():
        for _, args, kwargs, toks in calls[key]:
            eager = fn(*args, **kwargs).cpu()
            if not torch.equal(eager, toks):
                raise PhaseError(f"decoders: {key} tokens from the CUDA "
                                 f"graph differ from the eager decode")
            n_tokens += toks.numel()
    log(f"  decoders: golden result equals golden_decoders.json; "
        f"{len(calls['translate'])} translation and "
        f"{len(calls['summary'])} summary decodes ({n_tokens} tokens) "
        f"equal the same decodes run eagerly")
    # Warm seconds a request, by decoder, graphs on and off, in turns.
    secs = {}
    for _ in range(DECODER_ROUNDS):
        for graphs in (True, False):
            _set_graphs(engine, graphs)
            for name, path in (("golden", golden.GOLDEN_WAV),
                               ("tiled", tiled)):
                for v in calls.values():
                    v.clear()
                engine.transcribe(path)
                st = engine.last_trace.stages
                row = secs.setdefault(f"{name} graphs={graphs}", {
                    "translate_s": [], "summary_s": [],
                    "assemble.translate": [], "assemble.summary": []})
                for key in ("translate", "summary"):
                    row[f"{key}_s"].append(sum(c[0] for c in calls[key]))
                    row[f"assemble.{key}"].append(st[f"assemble.{key}"])
    _set_graphs(engine, True)
    for label, row in secs.items():
        log("  decoder seconds " + json.dumps({
            "request": label, "rounds": DECODER_ROUNDS,
            "translate_s_median": statistics.median(row["translate_s"]),
            "summary_s_median": statistics.median(row["summary_s"]),
            **{k: v for k, v in row.items()}}))
    return engine, launches


# ---------------------------------------------------------------------------
# Phase 4f: the d512 x 12 seed in crop mode, the beam search, streaming,
# the live route, and the release engine's wire modes
# ---------------------------------------------------------------------------

def _sse_timed(port, path, name, data):
    """(seconds to the first ``segments`` event, seconds to the ``result``
    event, events) of one SSE POST, read line by line as it streams."""
    import http.client

    body, ctype = _multipart([(name, data)])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    t_first = t_final = None
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        if resp.status != 200:
            raise PhaseError(f"POST {path} answered {resp.status}")
        lines = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"event: segments") and t_first is None:
                t_first = time.perf_counter() - t0
            if line.startswith(b"event: result"):
                t_final = time.perf_counter() - t0
            lines.append(line)
    finally:
        conn.close()
    return t_first, t_final, _sse_events(b"".join(lines))


def run_d512(dev, smi, release_params, release_xvector):
    """Phase 4f. ``checkpoints/r5_d512x12_seed`` (d_model 512, 12 layers, no
    x-vector) through ``config_for_checkpoint`` with ``speaker_mode=
    "crop"``, greedy and with the fixture's beam search, answers the golden
    and the tiled 120 s file through ``transcribe`` and through
    ``transcribe_streaming``: held to ``golden_d512_crop.json``
    (``testing.d512_mismatches``; the stable beam decodes' texts exact;
    the beam feed within ``testing.FEED_TOL`` of the JAX engine's, and the
    search over the JAX feed giving every JAX text),
    each stream's final event equal to ``transcribe``'s result, and the
    launches read over these requests (K1 a window batch and a crop batch,
    K2 and K3 12 a window batch). Then warm seconds (medians of
    D512_ROUNDS): inline (trunk pooling), crop and beam-8 crop requests,
    the ``extract`` stage and the crop forward's seconds; the live route
    in front of the crop engine, its first partial and its final event
    against ``engine.transcribe``. Last, the release engine with μ-law
    ingress and with the int8 speaker wire at stride 2 answers the golden
    file, held to the fixture's ``release_wire``, and ``health_check``.
    Returns the launches."""
    import dataclasses
    import tempfile

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import (PipelineConfig,
                                              config_for_checkpoint)
    from omnilingual_asr_torch.engine import (SPK_CROP_BATCH,
                                              TranscriptionEngine)
    from omnilingual_asr_torch.models.zoo import load_checkpoint
    from omnilingual_asr_torch.serving.app import OmniServer
    from omnilingual_asr_torch.serving.schema import result_to_entry

    stored = golden.load_golden_d512()
    base = config_for_checkpoint(str(D512))
    L = base.encoder.n_layers
    beam = base.replace(decode=dataclasses.replace(base.decode,
                                                   **stored["beam"]))
    params = load_checkpoint(D512, base, dev)
    engines = {mode: TranscriptionEngine(config=cfg, params=params,
                                         device=dev, speaker_mode=speaker)
               for mode, cfg, speaker in (("greedy", base, "crop"),
                                          ("beam", beam, "crop"),
                                          ("inline", base, "inline"))}
    for eng in engines.values():
        icfg = eng.infer_config.encoder
        if not (icfg.use_flash_attention and icfg.use_fused_conv
                and eng._xvector is None):
            raise PhaseError("d512: the engine did not take K2 and K3, or "
                             "loaded an x-vector")
    tiled = PKG / "_build" / "smoke_tiled.wav"
    write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    files = {"golden": golden.GOLDEN_WAV, "tiled": tiled}
    rec = {"ids": {}, "feeds": {}, "crop_batches": 0, "crop_s": []}

    def watch(eng):
        """Record each request's greedy ids, beam feed, crop batches and
        crop seconds on ``eng``."""
        extract, crop = eng._extract_windows, eng._segment_crop_embeds

        def rec_extract(outs, *parts):
            rec["ids"].setdefault(rec["name"], []).extend(
                o["ctc_ids"].astype(int).tolist() for o in outs)
            rec["feeds"].setdefault(rec["name"], []).extend(
                o["ctc_topk"] for o in outs if o["ctc_topk"] is not None)
            return extract(outs, *parts)

        def rec_crop(samples, decoded):
            t0 = time.perf_counter()
            out = crop(samples, decoded)
            rec["crop_s"].append(time.perf_counter() - t0)
            rec["crop_batches"] += math.ceil(len(decoded) / SPK_CROP_BATCH)
            return out

        eng._extract_windows, eng._segment_crop_embeds = (rec_extract,
                                                          rec_crop)

    for eng in engines.values():
        watch(eng)
    counters = _counters()
    for fn in counters:
        fn.launches = 0
    rec["crop_batches"] = 0
    results = {}
    for mode in ("greedy", "beam"):
        eng = engines[mode]
        results[mode] = {}
        rec["ids"], rec["feeds"] = {}, {}
        for name, path in files.items():
            rec["name"] = name
            results[mode][name] = eng.transcribe(path).to_dict()
        bad = golden.d512_mismatches(mode, results[mode], rec["ids"])
        if mode == "beam":
            bad += golden.d512_feed_mismatches(rec["feeds"])
        if bad:
            raise PhaseError(f"d512 {mode}: golden mismatch: "
                             + "; ".join(bad))
        rec["name"] = "stream"
        for name, path in files.items():
            events = list(eng.transcribe_streaming(path))
            kinds = [k for k, _ in events]
            n_part = _n_batches(eng, [path])
            if kinds != ["partial"] * n_part + ["final"]:
                raise PhaseError(f"d512 {mode} stream of {name}: {kinds}")
            if events[-1][1].to_dict() != results[mode][name]:
                raise PhaseError(f"d512 {mode}: the stream's final result "
                                 f"for {name} differs from transcribe's")
    launches = {fn.__name__: fn.launches for fn in counters}
    n_batches = 4 * _n_batches(engines["greedy"], list(files.values()))
    want = {"log_mel_frames": n_batches + rec["crop_batches"],
            "flash_attention": L * n_batches,
            "fused_conv_module": L * n_batches}
    log(f"  d512 launches {json.dumps(launches)} over {n_batches} window "
        f"batches and {rec['crop_batches']} crop batches")
    for name, n in want.items():
        if launches[name] != n:
            raise PhaseError(f"d512: {name} launched {launches[name]} "
                             f"times, expected {n}")
    # The host half of the beam path alone: the port's search over the JAX
    # engine's own feed gives the JAX text of every decode.
    import numpy as np

    feed = np.load(golden.GOLDEN_D512_FEED)
    n_exact = n_dec = 0
    for name, f in stored["files"].items():
        for d in f["beam"]["decodes"]:
            topk = (feed[f"{name}/{d['window']}/lp"],
                    feed[f"{name}/{d['window']}/ids"])
            n_exact += engines["beam"]._beam_text(topk, d["f0"],
                                                  d["f1"]) == d["text"]
            n_dec += 1
    if n_exact != n_dec:
        raise PhaseError(f"d512: the beam search over the JAX feed gave "
                         f"the JAX text in {n_exact} of {n_dec} decodes")
    diffs, swaps, n_frames = [], 0, 0
    for name in files:
        for w, (lp, ids) in enumerate(rec["feeds"][name]):
            diffs.append(np.abs(lp - feed[f"{name}/{w}/lp"]).ravel())
            swaps += sum(set(a) != set(b) for a, b in zip(
                ids.tolist(), feed[f"{name}/{w}/ids"].tolist()))
            n_frames += len(ids)
    diffs = np.concatenate(diffs)
    log("  d512 beam feed against the JAX engine's " + json.dumps({
        "mean_abs_dlogp": float(diffs.mean()),
        "max_abs_dlogp": float(diffs.max()),
        "frames_with_another_class_set": swaps / n_frames}))
    log("  d512 beam decodes " + json.dumps([
        {"file": name, "gap": d["gap"], "stable": d["stable"],
         "text_equal": w["text"] == g["text"]}
        for name, f in stored["files"].items()
        for d, w, g in zip(f["beam"]["decodes"], f["beam"]["result"][
            "segments"], results["beam"][name]["segments"])]))
    texts = golden.d512_beam_texts(results["beam"])
    log(f"  d512 golden: greedy and beam results of both files match "
        f"golden_d512_crop.json; the beam feed is within "
        f"{golden.FEED_TOL} of the JAX engine's; over the JAX feed the "
        f"beam search gives the JAX text of all {n_dec} decodes; over the "
        f"run's own feed it gives the JAX text of {texts['stable']} "
        f"stable and {texts['unstable']} unstable decodes; streams' final "
        f"events equal transcribe's")
    for mode in ("greedy", "beam"):
        for name in files:
            segs = results[mode][name]["segments"]
            log(f"  d512 {mode} {name}: {len(segs)} segments, "
                f"{len({s['speaker'] for s in segs})} speakers")

    # Warm seconds a request, by mode and file, in turns.
    secs = {}
    for _ in range(D512_ROUNDS):
        for mode in ("inline", "greedy", "beam"):
            eng = engines[mode]
            for name, path in files.items():
                rec["crop_s"].clear()
                t0 = time.perf_counter()
                eng.transcribe(path)
                row = secs.setdefault(f"{mode} {name}", {
                    "request_s": [], "extract_s": [], "crop_s": []})
                row["request_s"].append(time.perf_counter() - t0)
                row["extract_s"].append(eng.last_trace.stages["extract"])
                row["crop_s"].append(sum(rec["crop_s"]))
    for label, row in secs.items():
        log("  d512 seconds " + json.dumps({
            "request": label, "rounds": D512_ROUNDS,
            **{f"{k}_median": statistics.median(v) for k, v in row.items()},
            **row, "card": smi}))

    # The live route in front of the crop engine.
    eng = engines["greedy"]
    with tempfile.TemporaryDirectory(dir=PKG / "_build") as d:
        srv = OmniServer(engine=eng, base_dir=Path(d), auth_required=False,
                         use_sqlite=True)
        port = srv.serve_background("127.0.0.1", 0)
        try:
            for name, path in files.items():
                data = path.read_bytes()
                row = {"first_partial_s": [], "final_s": [],
                       "transcribe_s": []}
                for _ in range(D512_ROUNDS):
                    t_first, t_final, events = _sse_timed(
                        port, "/api/transcribe-stream-live", f"{name}.wav",
                        data)
                    if events[-1][0] != "result" or t_first is None:
                        raise PhaseError(f"d512 live route: events "
                                         f"{[k for k, _ in events]}")
                    t0 = time.perf_counter()
                    res = eng.transcribe(path)
                    row["transcribe_s"].append(time.perf_counter() - t0)
                    row["first_partial_s"].append(t_first)
                    row["final_s"].append(t_final)
                    want = result_to_entry(res, file_name="", audio_url="")
                    got = events[-1][1]
                    if any(got.get(k) != want.get(k) for k in (
                            "segments", "summary", "detected_languages")):
                        raise PhaseError(f"d512 live route: the final entry "
                                         f"for {name} differs from "
                                         f"transcribe's result")
                log("  d512 live route " + json.dumps({
                    "file": name, "rounds": D512_ROUNDS,
                    **{f"{k}_median": statistics.median(v)
                       for k, v in row.items()}, **row, "card": smi}))
        finally:
            srv.shutdown()
            srv.app._httpd.server_close()

    # The release engine's wire modes on the golden file, and the probe.
    for mode, (kwargs, decode) in (
            ("mulaw", ({"ingress": "mulaw"}, {})),
            ("i8_stride2", ({}, {"spk_wire": "i8", "spk_frame_stride": 2}))):
        cfg = PipelineConfig.from_json(
            (RELEASE / "config.json").read_text(),
            checkpoint_path=str(RELEASE / "asr.npz"))
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, **decode))
        eng = TranscriptionEngine(config=cfg, params=release_params,
                                  xvector_params=release_xvector,
                                  device=dev, **kwargs)
        want = stored["release_wire"][mode]
        res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
        samples = eng._load_audio(golden.GOLDEN_WAV)   # one window
        ids = [o["ctc_ids"].astype(int).tolist()
               for outs in eng._forward_batches(eng._windows(samples),
                                                len(samples))
               for o in outs]
        bad = golden.result_mismatches(want["result"], res,
                                       tone_mass=want["tone_mass"])
        agree = golden.ctc_agreement(want["ctc_ids"], ids)
        if bad or agree < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"release {mode}: golden mismatch "
                             f"{bad}, ids agree {agree:.4f}")
        log(f"  release {mode}: golden result matches the JAX engine's in "
            f"the same mode; greedy ids agree on {agree:.4%}")
    report = engines["greedy"].health_check()
    if not report["ok"]:
        raise PhaseError(f"health_check: {report}")
    log(f"  health_check {json.dumps(report)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4g: the evaluation drivers (eval.synth, heads, diar, long, latency)
# ---------------------------------------------------------------------------

EVAL_QUANT_FILES = 32     # eval.synth files under each int8 kernel mode
EVAL_LONG_HOURS = 1.0     # the timed eval.long run (its own process)
EVAL_LATENCY_REPS = 16
EVAL_CLI_TIMEOUT_S = 600


@contextlib.contextmanager
def _batches(engine):
    """Counts the device batches ``engine`` dispatches within the block."""
    n = [0]
    inner = engine._dispatch_batch

    def counting(*args, **kwargs):
        n[0] += 1
        return inner(*args, **kwargs)

    engine._dispatch_batch = counting
    try:
        yield n
    finally:
        del engine._dispatch_batch


def _launches_since(label, before, n_batches, per_batch) -> dict:
    """The launches since ``before`` (``_read_counters(reset=False)``), held
    to ``per_batch`` launches of each kernel named a batch."""
    now = _read_counters(reset=False)
    got = {k: now[k] - before[k] for k in now}
    for name, n in per_batch.items():
        if got[name] != n * n_batches:
            raise PhaseError(f"{label}: {name} launched {got[name]} times, "
                             f"expected {n} a batch x {n_batches}")
    return got


def _driver_cli(name: str, argv) -> dict:
    """``python -m omnilingual_asr_torch.eval.<name> ARGV`` in a process of
    its own, with release discovery on as a user's run has it: its one
    JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "OMNIASR_RELEASE_DIR"}
    proc = subprocess.run(
        [sys.executable, "-m", f"omnilingual_asr_torch.eval.{name}", *argv],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=EVAL_CLI_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise PhaseError(f"eval.{name} {argv} exited {proc.returncode}: "
                         f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    return json.loads(lines[0])


def run_evals(dev, cfg, params, xvector) -> dict:
    """Phase 4g. The port's evaluation drivers with the release weights on
    the card, held to the JAX package's ``golden_evals.json`` by
    ``testing.py``'s criteria: eval.synth on its 96 files at 10 s windows
    (texts, greedy ids pooled over the files, WER/CER), then its first EVAL_QUANT_FILES files
    unquantized and under "w8" and "a8" (reported, not held: the fixture
    has no JAX int8 corpus run); eval.heads on its 64 files and 8
    conversations with the release translator and summarizer; eval.diar on
    its 16 conversations; eval.long's engine on the 420 s file (streamed:
    no ``decode`` stage; ``testing.long_mismatches``). Every release batch launches one K1, four K2 and
    four K3 (K4 or K5 ten under "w8" or "a8"). Then two drivers as a user
    runs them, each in a process of its own with the release discovered:
    ``eval.long --hours 1`` (wall, RTF, stages, peak RSS, the card's peak
    memory) and ``eval.latency`` (d512 x 12 at batch 1). Returns the
    launches of the in-process runs."""
    import tempfile

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.eval import diar, harness, heads, long, synth
    from omnilingual_asr_torch.utils.metrics import aggregate_wer

    want = golden.load_golden_evals()
    L = cfg.encoder.n_layers
    per_batch = {"log_mel_frames": 1, "flash_attention": L,
                 "fused_conv_module": L, "quantized_matmul": 0,
                 "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0}

    def engine(**kwargs):
        return TranscriptionEngine(config=cfg, params=params,
                                   xvector_params=xvector, device=dev,
                                   **kwargs)

    for fn in _counters():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # eval.synth: 96 files at 10 s windows.
        t0 = time.perf_counter()
        ws = want["synth"]["window_seconds"]
        eng = engine(window_seconds=ws)
        if (eng.window_frames != 1024
                or not eng.infer_config.encoder.use_flash_attention):
            raise PhaseError(f"eval.synth engine: {eng.window_frames} "
                             f"frames, flash "
                             f"{eng.infer_config.encoder.use_flash_attention}")
        folder = tmp / "synth"
        manifest = synth.build_manifest(folder, want["synth"]["n"],
                                        include_real=True)
        t_data = time.perf_counter() - t0
        before = _read_counters(reset=False)
        with golden.recorded_ctc_ids(eng) as ids, _batches(eng) as nb:
            sets, reports = synth.evaluate_sets(eng, manifest, folder)
        _launches_since("eval.synth", before, nb[0], per_batch)
        rep = reports["synth"]
        hyps = [r["hyp"] for r in rep.per_file]
        stored = want["synth"]["files"]
        differ = {i: golden.ctc_agreement(f["ctc_ids"], ids[i])
                  for i, (h, f) in enumerate(zip(hyps, stored))
                  if h != f["hyp"]}
        pooled = golden.ctc_agreement(
            [x for f in stored for x in f["ctc_ids"]],
            [x for got in ids for x in got])
        log(f"  eval.synth {json.dumps(sets)} over {nb[0]} batches "
            f"(data {t_data:.2f} s, {time.perf_counter() - t0:.2f} s); "
            f"fixture WER {want['synth']['wer']:.6f} CER "
            f"{want['synth']['cer']:.6f}, card WER {rep.wer:.6f} CER "
            f"{rep.cer:.6f}; texts differ on {len(differ)} of "
            f"{len(hyps)} files (file: its ids' agreement {differ}); the "
            f"files' greedy ids agree on {pooled:.4%} of frames")
        bad = golden.synth_mismatches(want["synth"], hyps, ids, rep.wer,
                                      rep.cer)
        if bad:
            raise PhaseError("eval.synth: " + "; ".join(bad))

        # The same corpus's first files unquantized and under the kernels.
        sub = folder / "manifest_quant.jsonl"
        sub.write_text("".join(
            (folder / "manifest_synth.jsonl").read_text().splitlines(True)
            [:EVAL_QUANT_FILES]))
        quant = {}
        for mode in (False, "w8", "a8"):
            e = eng if mode is False else engine(window_seconds=ws,
                                                 quantize=mode)
            pb = dict(per_batch)
            if mode:
                pb["quantized_matmul" if mode == "w8"
                   else "quantized_matmul_a8"] = 2 * L + 2
            before = _read_counters(reset=False)
            with _batches(e) as nb:
                r = harness.evaluate(e, sub)
            got = _launches_since(f"eval.synth quantize={mode!r}", before,
                                  nb[0], pb)
            quant[mode or "none"] = {
                "wer": r.wer, "cer": r.cer, "rtf": r.rtf,
                "n_files": r.n_files, "batches": nb[0],
                "k4": got["quantized_matmul"],
                "k5": got["quantized_matmul_a8"]}
        fixture32 = aggregate_wer([(f["text"], f["hyp"])
                                   for f in stored[:EVAL_QUANT_FILES]])
        log(f"  eval.synth first {EVAL_QUANT_FILES} files {json.dumps(quant)}"
            f"; the fixture's WER/CER there {fixture32['wer']:.4f} / "
            f"{fixture32['cer']:.4f}")

        # eval.heads with the release translator and summarizer.
        t0 = time.perf_counter()
        eng = engine(translator_path=str(RELEASE / "translator.npz"),
                     summarizer_path=str(RELEASE / "summarizer.npz"))
        before = _read_counters(reset=False)
        with _batches(eng) as nb:
            report, rows = heads.evaluate_heads(
                eng, want["heads"]["n"], tmp / "heads", translate=True,
                summarize=True)
        _launches_since("eval.heads", before, nb[0], per_batch)
        pairs = [(g, w) for g, w in zip(rows["files"],
                                        want["heads"]["files"])
                 if g and w and "translation" in w]
        same = sum(g.get("translation") == w["translation"]
                   for g, w in pairs)
        log(f"  eval.heads {json.dumps(report)} over {nb[0]} batches "
            f"({time.perf_counter() - t0:.2f} s); fixture "
            f"{json.dumps(want['heads']['report'])}; translations identical "
            f"on {same} of {len(pairs)} files")
        bad = golden.heads_mismatches(want["heads"], report, rows)
        if bad:
            raise PhaseError("eval.heads: " + "; ".join(bad))

        # eval.diar: 16 conversations on the serving engine's config.
        t0 = time.perf_counter()
        eng = engine()
        before = _read_counters(reset=False)
        with _batches(eng) as nb:
            report, _ = diar.diar_report(lambda c: eng, cfg,
                                         want["diar"]["n"],
                                         want["diar"]["seed"])
        _launches_since("eval.diar", before, nb[0], per_batch)
        details = report["details"]
        der_mean = float(sum(d["der"] for d in details) / len(details))
        log(f"  eval.diar DER {report['value']} speaker count acc "
            f"{report['speaker_count_acc']} over {nb[0]} batches "
            f"({time.perf_counter() - t0:.2f} s); fixture DER "
            f"{want['diar']['report']['value']} count acc "
            f"{want['diar']['report']['speaker_count_acc']}; largest DER "
            f"difference "
            f"{max(abs(g['der'] - w['der']) for g, w in zip(details, want['diar']['report']['details'])):.4f}")
        bad = golden.diar_mismatches(want["diar"], details, der_mean)
        if bad:
            raise PhaseError("eval.diar: " + "; ".join(bad))

        # eval.long's engine on the 420 s file: the streamed-WAV path.
        t0 = time.perf_counter()
        eng = engine(batch_windows_per_device=want["long"]["batch_windows"])
        long.warm_up(eng, tmp)
        seconds = want["long"]["seconds"]
        path = long.make_long_audio(seconds, tmp / "long.wav")
        before = _read_counters(reset=False)
        with golden.recorded_ctc_ids(eng) as ids, _batches(eng) as nb:
            report, result = long.long_report(eng, path, seconds,
                                              seconds / 3600)
        _launches_since("eval.long 420 s", before, nb[0], per_batch)
        agreement = golden.long_agreement(want["long"]["result"],
                                          result.to_dict())
        log(f"  eval.long 420 s {json.dumps(report)} over {nb[0]} batches "
            f"({time.perf_counter() - t0:.2f} s with the warm-up); greedy "
            f"ids agree on {golden.ctc_agreement(want['long']['ctc_ids'], ids[0]):.4%}"
            f"; against the JAX result {json.dumps(agreement)}; the JAX "
            f"engine's own under 1-LSB noise "
            f"{json.dumps(want['long']['perturbed'])}")
        bad = golden.long_mismatches(want["long"], result.to_dict(),
                                     report["stages_s"], ids[0])
        if bad:
            raise PhaseError("eval.long 420 s: " + "; ".join(bad))
    launches = _read_counters(reset=False)

    # The drivers as a user runs them, each in a process of its own.
    t0 = time.perf_counter()
    report = _driver_cli("long", ["--hours", str(EVAL_LONG_HOURS)])
    log(f"  eval.long --hours {EVAL_LONG_HOURS} {json.dumps(report)} "
        f"({time.perf_counter() - t0:.2f} s with process start, warm-up "
        f"and the WAV's writing)")
    if "decode" in report["stages_s"] or report["n_segments"] < 100:
        raise PhaseError(f"eval.long --hours {EVAL_LONG_HOURS}: {report}")
    t0 = time.perf_counter()
    report = _driver_cli("latency", ["--reps", str(EVAL_LATENCY_REPS)])
    log(f"  eval.latency {json.dumps(report)} "
        f"({time.perf_counter() - t0:.2f} s)")
    if report["model"] != {"d_model": 512, "n_layers": 12}:
        raise PhaseError(f"eval.latency: {report}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4e: the server (native decoding, HTTP routes, history, exports)
# ---------------------------------------------------------------------------

SERVER_SECONDS = (120.0, 330.0)  # tiled files decoded both ways and served
SERVER_ROUNDS = 3                # warm requests a timing (medians)
EXPORT_FORMATS = ("eaf", "textgrid", "srt", "txt", "json")
# What differs between two servings of one file: ids, clocks, upload names.
UNSTABLE_KEYS = ("id", "created_at", "audio_url", "audio_key", "file_name")


def _multipart(files, field="file"):
    """(body, content type) of a multipart form with ``files``: [(name,
    bytes)]."""
    boundary = "omnismokeboundary"
    parts = []
    for name, data in files:
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{field}\"; filename=\"{name}\"\r\nContent-"
                     f"Type: application/octet-stream\r\n\r\n".encode()
                     + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _http(port, method, path, body=None, ctype=None):
    """(status, body bytes) of one request to the local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _sse_events(data: bytes):
    events = []
    for block in data.decode().split("\n\n"):
        fields = dict(line.partition(": ")[::2]
                      for line in block.splitlines() if line)
        if "event" in fields:
            events.append((fields["event"], json.loads(fields["data"])))
    return events


def _stable(entry: dict) -> dict:
    return {k: v for k, v in entry.items() if k not in UNSTABLE_KEYS}


def _post_files(port, path, files, field="file"):
    """The body of a multipart POST of ``files``; any status but 200
    fails the phase."""
    status, body = _http(port, "POST", path, *_multipart(files, field))
    if status != 200:
        raise PhaseError(f"server: POST {path} answered {status}: "
                         f"{body[:300]!r}")
    return body


def write_resampled_stereo(src: Path, dst: Path, rate: int) -> None:
    """``src`` (16 kHz mono PCM-16) resampled to ``rate`` as a stereo file
    whose right channel is the left at half gain."""
    import numpy as np
    from omnilingual_asr_torch.audio.decode import decode_wav_bytes
    from omnilingual_asr_torch.audio.resample import resample

    x, sr = decode_wav_bytes(src.read_bytes())
    y = resample(x, sr, rate)
    pcm = np.clip(np.round(np.stack([y, 0.5 * y], axis=1) * 32767),
                  -32768, 32767).astype("<i2")
    with wave.open(str(dst), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def check_native(engine, work: Path, smi: str) -> dict:
    """The native library: built from the port's source under ``_build/``
    (failing the phase when it is not), then the tiled files decoded
    natively and by the Python parser, equal, with both times and the
    engine's own decode (``_load_audio``: native, at the engine's rate)."""
    import numpy as np
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.audio import native_lib
    from omnilingual_asr_torch.audio.decode import decode_wav_bytes

    if not native_lib.native_available():
        raise PhaseError("server: the native omniaudio library did not "
                         "build or load (g++ on "
                         f"{native_lib.SOURCE.relative_to(ROOT)})")
    info = native_lib.native_build()
    if info.lib_path.parent.parent != PKG / "_build":
        raise PhaseError(f"server: the native library {info.lib_path} is "
                         f"not under omnilingual_asr_torch/_build/")
    headers = bool(native_lib._libav_flags())
    log("  native " + json.dumps({
        "lib": str(info.lib_path.relative_to(ROOT)),
        "build_s": info.seconds, "cached": info.cached,
        "flags": info.flags, "libav_headers": headers,
        "libav_linked": info.libav, "card": smi}))
    paths = {}
    for seconds in SERVER_SECONDS:
        path = work / f"t{int(seconds)}.wav"
        write_tiled_wav(golden.GOLDEN_WAV, path, seconds)
        paths[seconds] = path
        times = {"native_s": [], "python_s": [], "engine_load_s": []}
        for _ in range(SERVER_ROUNDS):
            t0 = time.perf_counter()
            engine._load_audio(path)
            times["engine_load_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got, sr = native_lib.native_decode(path)
            times["native_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want, want_sr = decode_wav_bytes(path.read_bytes())
            times["python_s"].append(time.perf_counter() - t0)
            if sr != want_sr or not np.array_equal(got, want):
                raise PhaseError(f"server: the native decode of the "
                                 f"{seconds:.0f} s file differs from the "
                                 f"Python parser's")
        log("  decode " + json.dumps({
            "audio_s": seconds, "samples_equal": True,
            "native_s_median": statistics.median(times["native_s"]),
            "python_s_median": statistics.median(times["python_s"]),
            "engine_load_s_median": statistics.median(
                times["engine_load_s"]),
            **times, "card": smi}))
    return {"paths": paths, "libav": info.libav}


def _mp3_of(src: Path, dst: Path) -> bool:
    """An MP3 of ``src`` made on this machine, if an encoder is here."""
    import shutil

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    proc = subprocess.run([ffmpeg, "-loglevel", "error", "-y", "-i",
                           str(src), "-codec:a", "libmp3lame", "-b:a",
                           "128k", str(dst)], capture_output=True,
                          timeout=120)
    return proc.returncode == 0 and dst.is_file()


def run_server(engine, smi: str) -> dict:
    """Phase 4e. The port's ``OmniServer`` in front of phase 4d's engine
    (release weights and both decoders) on 127.0.0.1 with SQLite history:
    the golden file, the tiled files and a 44.1 kHz stereo file served
    alone, then all four at once on the batch route (each result equal to
    the same file served alone), history and the five exports, the live
    route streaming the golden file (its result held to
    ``golden_decoders.json``); the K1-K3 launches over the serial requests;
    warm seconds
    through HTTP beside ``engine.transcribe``, and the batch route's wall
    seconds under the engine's device lock beside a lock around whole
    requests. Returns the serial requests' launches."""
    import io
    import re
    import tempfile
    import threading
    import zipfile

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.exporters import export_transcript
    from omnilingual_asr_torch.serving.app import OmniServer

    work = PKG / "_build" / "server"
    work.mkdir(parents=True, exist_ok=True)
    native = check_native(engine, work, smi)
    t120, t330 = (native["paths"][s] for s in SERVER_SECONDS)
    stereo = work / "golden_44k1_stereo.wav"
    write_resampled_stereo(golden.GOLDEN_WAV, stereo, 44_100)
    files = {"golden.wav": golden.GOLDEN_WAV, "t120.wav": t120,
             "golden_44k1_stereo.wav": stereo, "t330.wav": t330}
    mp3 = work / "golden.mp3"
    if native["libav"] and _mp3_of(golden.GOLDEN_WAV, mp3):
        files["golden.mp3"] = mp3
        log("  mp3: libav linked and ffmpeg made golden.mp3 here; it is "
            "served alone and on the batch route")
    else:
        log(f"  mp3: not served (libav linked: {native['libav']}, an MP3 "
            f"encoder here: {bool(native['libav'] and mp3.is_file())})")
    data = {name: p.read_bytes() for name, p in files.items()}

    L = engine.config.encoder.n_layers
    per_batch = {"log_mel_frames": 1, "flash_attention": L,
                 "fused_conv_module": L}
    counters = _counters()
    with tempfile.TemporaryDirectory(dir=work) as base:
        srv = OmniServer(engine=engine, base_dir=Path(base),
                         auth_required=False, use_sqlite=True)
        port = srv.serve_background("127.0.0.1", 0)
        try:
            # Serial requests, each file alone; the launches are read over
            # these only (the counters are not atomic across threads).
            for fn in counters:
                fn.launches = 0
            alone = {}
            for name in files:
                if name == "t120.wav":
                    continue
                alone[name] = json.loads(_post_files(
                    port, "/api/transcribe", [(name, data[name])]))
            body = _post_files(port, "/api/transcribe-stream",
                              [("t120.wav", data["t120.wav"])])
            events = _sse_events(body)
            steps = []
            for kind, d in events:
                if kind == "progress" and (not steps or steps[-1]
                                           != d["step"]):
                    steps.append(d["step"])
            if (steps != ["uploading", "transcribing", "processing", "done"]
                    or [k for k, _ in events].count("result") != 1
                    or events[-1][0] != "result"):
                raise PhaseError(f"server: stream events {steps} + "
                                 f"{[k for k, _ in events][-2:]}")
            alone["t120.wav"] = events[-1][1]
            launches = {fn.__name__: fn.launches for fn in counters}
            n_batches = _n_batches(engine, [files[n] for n in files
                                            if n.endswith(".wav")])
            if "golden.mp3" in files:
                n_batches += 1
            log(f"  server launches {json.dumps(launches)} over "
                f"{n_batches} batches of serial requests")
            for name, n in per_batch.items():
                if launches[name] != n * n_batches:
                    raise PhaseError(f"server: {name} launched "
                                     f"{launches[name]} times, expected {n} "
                                     f"a batch x {n_batches}")

            stored = golden.load_golden_decoders()
            g = alone["golden.wav"]
            bad = golden.result_mismatches(stored["result"], g,
                                           tone_mass=stored["tone_mass"])
            if g.get("summary") != stored["result"]["summary"]:
                bad.append(f"summary {g.get('summary')!r}")
            if ([s.get("translation") for s in g["segments"]]
                    != [s["translation"]
                        for s in stored["result"]["segments"]]):
                bad.append("translations differ")
            if bad:
                raise PhaseError("server: golden entry mismatch: "
                                 + "; ".join(bad))
            log(f"  server golden: {len(g['segments'])} segments equal "
                f"golden_decoders.json (translations and summary exact)")

            # The batch route: the four files at once, the stereo one
            # inside a .zip; each result equals the file served alone.
            zbuf = io.BytesIO()
            with zipfile.ZipFile(zbuf, "w") as z:
                z.writestr("golden_44k1_stereo.wav",
                           data["golden_44k1_stereo.wav"])
            upload = [(n, data[n]) for n in files
                      if n != "golden_44k1_stereo.wav"]
            upload.insert(2, ("batch.zip", zbuf.getvalue()))

            def batch_route():
                t0 = time.perf_counter()
                body = _post_files(port, "/api/transcribe-batch-stream",
                                  upload, field="files")
                secs = time.perf_counter() - t0
                events = _sse_events(body)
                errors = [d for k, d in events if d.get("step") == "error"]
                if errors or events[-1][0] != "result":
                    raise PhaseError(f"server: batch route errors {errors}")
                return events[-1][1]["results"], secs

            results, _ = batch_route()
            by_name = {r["file_name"]: r for r in results}
            if sorted(by_name) != sorted(files):
                raise PhaseError(f"server: batch results for "
                                 f"{sorted(by_name)}, want {sorted(files)}")
            for name in files:
                if _stable(by_name[name]) != _stable(alone[name]):
                    raise PhaseError(f"server: {name} on the batch route "
                                     f"differs from the file served alone")
            log(f"  server batch route: {len(files)} files at once (one in "
                f"a .zip) equal the same files served alone")

            # History and the five exports of every stored entry.
            status, listed = _http(port, "GET", "/api/history")
            listed = json.loads(listed)
            if status != 200 or len(listed) != 2 * len(files):
                raise PhaseError(f"server: history lists {len(listed)} "
                                 f"entries, want {2 * len(files)}")
            for item in listed:
                status, entry = _http(port, "GET",
                                      f"/api/history/{item['id']}")
                entry = json.loads(entry)
                for fmt in EXPORT_FORMATS:
                    status, got = _http(
                        port, "GET",
                        f"/api/history/{item['id']}/export?format={fmt}")
                    kw = {}
                    if fmt == "eaf":
                        kw["date"] = re.search(rb'DATE="([^"]*)"',
                                               got)[1].decode()
                    want = export_transcript(entry, fmt, **kw)
                    if status != 200 or got != want.encode("utf-8"):
                        raise PhaseError(f"server: the {fmt} export of "
                                         f"{item['file_name']} differs from "
                                         f"export_transcript")
            log(f"  server history: {len(listed)} entries; all five exports "
                f"of each equal export_transcript on the stored entry")

            # The live route streams the golden file: progress, one
            # segments event (one batch), the entry held to the fixture.
            events = _sse_events(_post_files(
                port, "/api/transcribe-stream-live",
                [("g.wav", data["golden.wav"])]))
            kinds = [k for k, _ in events]
            live = events[-1][1]
            bad = golden.result_mismatches(stored["result"], live,
                                           tone_mass=stored["tone_mass"])
            if (kinds.count("segments") != 1 or kinds[-1] != "result"
                    or "error" in kinds):
                bad.append(f"events {kinds}")
            if live.get("summary") != stored["result"]["summary"]:
                bad.append(f"summary {live.get('summary')!r}")
            if ([s.get("translation") for s in live["segments"]]
                    != [s["translation"]
                        for s in stored["result"]["segments"]]):
                bad.append("translations differ")
            if bad:
                raise PhaseError("server: live route mismatch: "
                                 + "; ".join(bad))
            log(f"  server live route: {kinds.count('progress')} progress "
                f"events, 1 segments event, a result equal to "
                f"golden_decoders.json")

            # Warm seconds a request: HTTP against engine.transcribe.
            for name in ("golden.wav", "t120.wav"):
                http_s, direct_s = [], []
                for _ in range(SERVER_ROUNDS):
                    t0 = time.perf_counter()
                    _post_files(port, "/api/transcribe",
                               [(name, data[name])])
                    http_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    engine.transcribe(files[name])
                    direct_s.append(time.perf_counter() - t0)
                log("  server seconds " + json.dumps({
                    "request": name, "rounds": SERVER_ROUNDS,
                    "http_s_median": statistics.median(http_s),
                    "direct_s_median": statistics.median(direct_s),
                    "http_s": http_s, "direct_s": direct_s, "card": smi}))

            # The lock's cost on the batch route: the four files at once
            # under the device lock, then under a lock around each whole
            # request, beside the same files served one after another.
            whole = threading.Lock()
            plain = engine.transcribe

            def whole_request(*a, **kw):
                with whole:
                    return plain(*a, **kw)

            secs = {"device_lock_s": [], "whole_request_lock_s": [],
                    "serial_s": []}
            for _ in range(SERVER_ROUNDS):
                secs["device_lock_s"].append(batch_route()[1])
                engine.transcribe = whole_request
                try:
                    secs["whole_request_lock_s"].append(batch_route()[1])
                finally:
                    del engine.transcribe
                t0 = time.perf_counter()
                for name in files:
                    _post_files(port, "/api/transcribe",
                               [(name, data[name])])
                secs["serial_s"].append(time.perf_counter() - t0)
            log("  server batch seconds " + json.dumps({
                "files": len(files), "rounds": SERVER_ROUNDS,
                **{f"{k}_median": statistics.median(v)
                   for k, v in secs.items()}, **secs, "card": smi}))
        finally:
            srv.shutdown()
            srv.app._httpd.server_close()
    return launches


# ---------------------------------------------------------------------------
# Phase 4b: kernel-mode training through train_synth
# ---------------------------------------------------------------------------

def run_train(dev):
    """``train_synth`` with ``pallas_kernels=True`` for TRAIN_STEPS steps at
    ``PipelineConfig()`` dims from a seeded init. For this run only, a
    subclass of ``SynthBatcher`` times the host's wait for each batch, and
    the train step that ``make_train_step`` returns is wrapped to read the
    launch counts and the parameters after each update. Returns the
    training path's launches of each kernel."""
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.train import synth_train
    from omnilingual_asr_torch.train.step import tree_leaves

    L = PipelineConfig().encoder.n_layers
    per_step = {"log_mel_frames": 1, "flash_attention": L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "fused_conv_module": L, "quantized_matmul": 0,
                "quantized_matmul_a8": 0}
    waits = []

    class TimedBatcher(synth_train.SynthBatcher):
        def __next__(self):
            t0 = time.perf_counter()
            batch = super().__next__()
            waits.append(time.perf_counter() - t0)
            return batch

    total = {k: 0 for k in per_step}
    snaps, times = [], [time.perf_counter()]

    def after_step(step, params, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = _read_counters()
        m = {k: float(v) for k, v in metrics.items()}
        log("  train step " + json.dumps({
            "step": step, **m, "step_s": now - times[-1],
            "batch_wait_s": waits[-1], "launches": counts}))
        times.append(now)
        if not all(math.isfinite(v) for v in m.values()):
            raise PhaseError(f"step {step}: non-finite metrics {m}")
        for name, n in per_step.items():
            if counts[name] != n:
                raise PhaseError(f"step {step}: {name} launched "
                                 f"{counts[name]} times, expected {n}")
            total[name] += counts[name]
        if step <= 2:
            snaps.append([p.detach().clone() for p in tree_leaves(params)])

    make_train_step = synth_train.make_train_step

    def watched_make_train_step(*args, **kwargs):
        init_state, train_step, loss_and_grads = make_train_step(*args,
                                                                 **kwargs)

        def watched_train_step(params, opt_state, batch, step):
            out = train_step(params, opt_state, batch, step)
            after_step(step + 1, out[0], out[3])
            return out

        return init_state, watched_train_step, loss_and_grads

    _read_counters()
    synth_batcher = synth_train.SynthBatcher
    synth_train.SynthBatcher = TimedBatcher
    synth_train.make_train_step = watched_make_train_step
    try:
        params, best = synth_train.train_synth(
            steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, cfg=PipelineConfig(),
            seed=SEED, pallas_kernels=True, device=dev, log_every=1,
            eval_every=1000)
    finally:
        synth_train.SynthBatcher = synth_batcher
        synth_train.make_train_step = make_train_step
    torch.cuda.synchronize()
    log(f"  evaluation launches {json.dumps(_read_counters())}; best synth "
        f"WER {best}")
    if len(snaps) < 2:
        raise PhaseError(f"{len(snaps)} train steps were watched, expected "
                         f"{TRAIN_STEPS}")
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(*snaps))
    if moved == 0:
        raise PhaseError("the parameters after step 2 equal those after "
                         "step 1 (the first update has learning rate 0, the "
                         "second must move them)")
    log(f"  {moved} of {len(snaps[0])} parameter leaves moved in step 2; "
        f"host batch waits {[round(w, 4) for w in waits]} s")
    return total


def grad_check(dev):
    """One batch of 2 windows at ``PipelineConfig()`` dims through the
    kernels on the card (K1-K3, K6, K7) against the same step on the CPU
    (plain versions) from the same parameters: per-leaf relative L2 error
    of the gradients. Beside it, the card's own floor (the same step with
    the parameters perturbed by 1e-6 relative) and a planted fault (the
    same step with delta dropped from the flash backward, so that K6 and K7
    compute p * dp for p * (dp - delta)), which must miss the tolerance."""
    import dataclasses

    import numpy as np
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.ops import attention as A
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_train_step,
                                                  tree_leaves, tree_map)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = PipelineConfig()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    mult = A.REFERENCE_BLOCK_Q * cfg.encoder.subsample_factor
    batcher = SynthBatcher(cfg, batch_size=2, seed=SEED + 5,
                           frame_multiple=mult, n_threads=1)
    try:
        batch = next(iter(batcher))
    finally:
        batcher.close()
    batch["samples"] = np.clip(batch["samples"] * 32768.0, -32768,
                               32767).astype(np.int16)
    grads = {}
    params = None
    for where in (dev, torch.device("cpu")):
        init, _, loss_and_grads = make_train_step(
            cfg, where, from_samples=True, with_translator=True)
        if params is None:
            params = init(SEED).params
        p = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                     params)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        b[CTC_INFEASIBLE] = ctc_rows(batch, cfg)
        t0 = time.perf_counter()
        metrics, g = loss_and_grads(p, b, 0)
        grads[where.type] = [x.detach().cpu() if x is not None
                             else torch.zeros_like(y.cpu())
                             for x, y in zip(g, tree_leaves(p))]
        log(f"  grad check {where.type}: loss "
            f"{float(metrics['loss']):.6f} ({time.perf_counter() - t0:.2f} s)")
        if where.type == "cuda":      # the card's own floor, see above
            gen = torch.Generator(device=where).manual_seed(SEED)
            q = tree_map(lambda t: (t.detach() * (1 + 1e-6 * torch.randn(
                t.shape, generator=gen, device=where))).requires_grad_(True),
                p)
            _, g2 = loss_and_grads(q, b, 0)
            grads["floor"] = [x.detach().cpu() if x is not None
                              else torch.zeros_like(y.cpu())
                              for x, y in zip(g2, tree_leaves(q))]
            flash_delta = A.flash_delta           # the planted fault
            A.flash_delta = lambda o, do: torch.zeros_like(flash_delta(o,
                                                                       do))
            try:
                _, g3 = loss_and_grads(p, b, 0)
            finally:
                A.flash_delta = flash_delta
            grads["fault"] = [x.detach().cpu() if x is not None
                              else torch.zeros_like(y.cpu())
                              for x, y in zip(g3, tree_leaves(p))]

    def worst_of(got, want):
        worst, worst_i = 0.0, -1
        for i, (a, b) in enumerate(zip(got, want)):
            nb = float(b.norm())
            err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
            if not math.isfinite(err):
                raise PhaseError(f"grad check: leaf {i} is not finite")
            if err > worst:
                worst, worst_i = err, i
        return worst, worst_i

    worst, worst_i = worst_of(grads["cuda"], grads["cpu"])
    floor, floor_i = worst_of(grads["floor"], grads["cuda"])
    fault, fault_i = worst_of(grads["fault"], grads["cpu"])
    log(f"  grad check: worst per-leaf relative L2 error {worst:.3e} (leaf "
        f"{worst_i} of {len(grads['cpu'])}; tol {TOL_GRAD_REL}); the card's "
        f"own floor under a 1e-6 perturbation {floor:.3e} (leaf {floor_i}); "
        f"with delta dropped from the flash backward {fault:.3e} (leaf "
        f"{fault_i})")
    if worst > TOL_GRAD_REL:
        raise PhaseError(f"grad check: leaf {worst_i} relative error "
                         f"{worst:.3e} > {TOL_GRAD_REL}")
    if fault <= TOL_GRAD_REL:
        raise PhaseError(f"grad check: with delta dropped from the flash "
                         f"backward the worst leaf reads {fault:.3e}, within "
                         f"the tolerance {TOL_GRAD_REL}: the check cannot "
                         f"see such a fault")


# ---------------------------------------------------------------------------
# Phase 4h: the release's other trainers (x-vector, text and audio
# translators, summarizer)
# ---------------------------------------------------------------------------

# The trainers' runs, cut to fit the phase: (steps, batch) and the data.
XV_STEPS, XV_BATCH = 8, 64            # the full 48-utterance eval at step 8
TT_STEPS, TT_BATCH, TT_EVAL = 20, 128, 64
AT_STEPS, AT_BATCH, AT_TRAIN, AT_EVAL = 20, 64, 256, 32
SM_STEPS, SM_BATCH, SM_POOL, SM_TRAIN, SM_EVAL = 20, 32, 96, 64, 8
# One update on the card against the same update on the CPU: the gradients
# per leaf within TOL_GRAD_REL (phase 4b's criterion) and the loss within
# TOL_TRAINER_LOSS_REL (f32 sums in another order; bf16 roundings of the
# x-vector's convolution inputs flipped by them).
TOL_TRAINER_LOSS_REL = 1e-3


def _trainer_update_check(label, dev, loss, params, args_on) -> dict:
    """The gradient of ``loss(params, *args_on(device))`` on the card and
    on the CPU from the same parameters and batch, leaf by leaf."""
    import torch
    from omnilingual_asr_torch.train.step import (tree_leaves, trainable,
                                                  value_and_grads)

    got = []
    for where in (dev, torch.device("cpu")):
        p = trainable(params, where)
        t0 = time.perf_counter()
        value, grads = value_and_grads(loss, p, *args_on(where))
        got.append((float(value), [
            torch.zeros(x.shape) if g is None else g.detach().cpu()
            for g, x in zip(grads, tree_leaves(p))],
            time.perf_counter() - t0))
    (lc, gc, tc), (lp, gp, tp) = got
    worst, worst_i = 0.0, -1
    for i, (a, b) in enumerate(zip(gc, gp)):
        nb = float(b.norm())
        err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
        if not math.isfinite(err):
            raise PhaseError(f"{label}: gradient leaf {i} is not finite")
        if err > worst:
            worst, worst_i = err, i
    loss_rel = abs(lc - lp) / max(abs(lp), 1e-30)
    out = {"loss_cuda": lc, "loss_cpu": lp, "loss_rel": loss_rel,
           "grad_worst_rel": worst, "grad_worst_leaf": worst_i,
           "n_leaves": len(gp), "cuda_s": tc, "cpu_s": tp}
    if worst > TOL_GRAD_REL or loss_rel > TOL_TRAINER_LOSS_REL:
        raise PhaseError(f"{label}: one update on the card against the CPU: "
                         f"{out} (tol {TOL_GRAD_REL} per leaf, loss "
                         f"{TOL_TRAINER_LOSS_REL})")
    return out


def _trainer_drive(label, fn, k1) -> tuple:
    """Drives one trainer: every launch count set to 0 and the card's peak
    memory reset just before ``fn()``, both read just after. Its losses
    must be finite, K1 launched ``k1`` times and no other kernel."""
    import torch

    _read_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, run = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["log_mel_frames"] = k1
    if launches != want:
        raise PhaseError(f"{label}: launches {launches}, expected {want}")
    if not run.losses or not all(math.isfinite(x) for x in run.losses):
        raise PhaseError(f"{label}: losses {run.losses}")
    steps = len(run.losses)
    secs = {k: round(v, 4) for k, v in run.seconds.items()}
    log(f"  trainer {json.dumps({'trainer': label, 'wall_s': wall, 'steps': steps, 'steps_per_s': steps / run.seconds['steps'], 'seconds': secs, 'peak_card_gb': peak / 1e9, 'losses': [round(x, 4) for x in run.losses], 'evals': run.evals, 'launches': launches})}")
    return params, run, launches


def _loads_back(label, got, want, half=False) -> None:
    """The saved file's tree, loaded by the port's loader, equal to the
    trained parameters at the file's precision (f16 or f32)."""
    import torch
    from omnilingual_asr_torch.models.zoo import flatten

    a, b = flatten(got), flatten(want)
    if a.keys() != b.keys():
        raise PhaseError(f"{label}: the saved file's leaves differ")
    for k in a:
        w = b[k].detach().cpu()
        w = w.half().float() if half else w.float()
        if not torch.equal(a[k].cpu().float(), w):
            raise PhaseError(f"{label}: saved leaf {k} does not load back")


def run_trainers(dev, cfg, params, smi) -> dict:
    """Phase 4h. The four trainers the port lacked, each through its own
    functions on the card from a seeded init, cut as the constants above
    say: the x-vector (``PipelineConfig()``'s, batch 64 of 4 s, the eval
    at the last step), the text translator at the release's dims, the
    audio translator and the summarizer on the release ASR. Each must give
    finite losses, its count of K1 launches (one a x-vector step and eval
    batch, one a frozen-encoder batch of 64 utterances, one a
    conversation; no other kernel), one update equal to the CPU's, and a
    file that loads back. Then an engine with the trained x-vector,
    summarizer and each translator by explicit path answers the golden
    file with its structure whole. Returns the launches."""
    import tempfile

    import numpy as np
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models.translation import (
        load_translator, text_translator_init, translator_init)
    from omnilingual_asr_torch.models.xvector import xvector_init
    from omnilingual_asr_torch.models.zoo import load_xvector
    from omnilingual_asr_torch.ops.mel import MelFrontend
    from omnilingual_asr_torch.train import summary_train as sm
    from omnilingual_asr_torch.train import text_translator_train as tt
    from omnilingual_asr_torch.train import translator_train as at
    from omnilingual_asr_torch.train import xvector_train as xv
    from omnilingual_asr_torch.train.synth import LEXICON_SIZE

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def gen():
        return torch.Generator().manual_seed(SEED)

    asr = str(RELEASE / "asr.npz")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # The x-vector: PipelineConfig()'s embedder, batch 64 of 4 s.
        xcfg = PipelineConfig()
        x0 = xvector_init(gen(), xcfg)
        n_eval = xv.EVAL_SPEAKERS * xv.EVAL_PER_SPEAKER
        xp, _, launches = _trainer_drive(
            "xvector", lambda: xv.train_xvector(
                steps=XV_STEPS, batch_size=XV_BATCH, seed=SEED,
                ckpt_dir=str(tmp / "xv"), log_every=XV_STEPS,
                eval_every=XV_STEPS, device=dev, init_params=x0),
            XV_STEPS + math.ceil(n_eval / XV_BATCH))
        add(launches)
        win = int(4.0 * xcfg.frontend.sample_rate)
        wf = xv.window_frames(xcfg, win)
        batch = xv.BatchPool(xcfg, batch_size=XV_BATCH, win=win, wf=wf,
                             seed=SEED + 1).next_batch()
        check = _trainer_update_check(
            "xvector", dev, xv.loss_fn, x0, lambda d: (
                MelFrontend(xcfg.frontend, d), *xv.batch_tensors(batch, d),
                wf))
        log(f"  xvector update on the card against the CPU {json.dumps(check)}")
        _loads_back("xvector", load_xvector(tmp / "xv" / "xvector.npz",
                                            xcfg), xp, half=True)

        # The text translator at the release's dims (no real corpus where
        # humanize/babel give none).
        t0_params = text_translator_init(gen(), cfg, n_layers=4)
        tp, _, launches = _trainer_drive(
            "text_translator", lambda: tt.train_translator(
                str(tmp / "tt.npz"), steps=TT_STEPS, batch_size=TT_BATCH,
                n_eval=TT_EVAL, seed=SEED, eval_every=TT_STEPS,
                log_every=TT_STEPS, cfg=cfg, device=dev,
                init_params=t0_params), 0)
        add(launches)
        tables, english = tt._lang_tables()
        batch = tt.make_batch(np.random.default_rng(SEED), tables, english,
                              LEXICON_SIZE, cfg.vocab, TT_BATCH, noise=True,
                              g=tt._grammar_tables(tables, english))
        check = _trainer_update_check(
            "text_translator", dev, tt.loss_fn, t0_params,
            lambda d: (*tt.batch_tensors(batch, d), cfg))
        log(f"  text_translator update on the card against the CPU "
            f"{json.dumps(check)}")
        _loads_back("text_translator", load_translator(tmp / "tt.npz", cfg),
                    tp)

        # The audio translator on the release ASR (its bank kept for the
        # update check).
        banks = {}

        def keep(inner, key):
            def wrapped(*args, **kwargs):
                out = inner(*args, **kwargs)
                banks[key] = out
                return out
            return wrapped

        a0 = translator_init(gen(), cfg, n_layers=4)
        build_bank = at.build_bank
        at.build_bank = keep(build_bank, "translator")
        try:
            ap, _, launches = _trainer_drive(
                "translator", lambda: at.train_translator(
                    asr_ckpt=asr, out_dir=str(tmp / "at"), steps=AT_STEPS,
                    batch_size=AT_BATCH, n_train=AT_TRAIN, n_eval=AT_EVAL,
                    seed=SEED, cfg=cfg, log_every=AT_STEPS, device=dev,
                    init_params=a0),
                math.ceil((AT_TRAIN + AT_EVAL) / at.ENCODE_BATCH))
        finally:
            at.build_bank = build_bank
        add(launches)
        bank = banks["translator"][0]
        idx = torch.arange(AT_BATCH)
        check = _trainer_update_check(
            "translator", dev, at.loss_fn, a0, lambda d: (
                tuple(b.to(d) for b in bank), idx.to(d), cfg))
        log(f"  translator update on the card against the CPU "
            f"{json.dumps(check)}")
        _loads_back("translator", load_translator(
            tmp / "at" / "translator.npz", cfg), ap)

        # The summarizer on the release ASR.
        s0 = translator_init(gen(), cfg, n_layers=2)
        build_bank = sm.build_bank
        sm.build_bank = keep(build_bank, "summarizer")
        try:
            sp, _, launches = _trainer_drive(
                "summarizer", lambda: sm.train_summarizer(
                    asr_ckpt=asr, out_dir=str(tmp / "sm"), steps=SM_STEPS,
                    batch_size=SM_BATCH, pool_size=SM_POOL,
                    n_train=SM_TRAIN, n_eval=SM_EVAL, seed=SEED, cfg=cfg,
                    log_every=SM_STEPS, device=dev, init_params=s0),
                SM_TRAIN + SM_EVAL)
        finally:
            sm.build_bank = build_bank
        add(launches)
        bank = banks["summarizer"][0]
        rows = torch.arange(SM_BATCH)
        check = _trainer_update_check(
            "summarizer", dev, sm.loss_fn, s0, lambda d: (
                *(b.to(d)[rows.to(d)] for b in bank), cfg))
        log(f"  summarizer update on the card against the CPU "
            f"{json.dumps(check)}")
        _loads_back("summarizer", load_translator(
            tmp / "sm" / "summarizer.npz", cfg, n_layers=2), sp)

        # The trained files serve the golden file through the engine.
        for label, translator in (("text", tmp / "tt.npz"),
                                  ("audio", tmp / "at" / "translator.npz")):
            t0 = time.perf_counter()
            engine = TranscriptionEngine(
                config=cfg, params=params, device=dev,
                xvector_params=load_xvector(tmp / "xv" / "xvector.npz",
                                            cfg, dev),
                translator_path=str(translator),
                summarizer_path=str(tmp / "sm" / "summarizer.npz"))
            rows = []
            decode = engine._translator.decode

            def counting(enc, *args, **kwargs):
                rows.append(enc.shape[0])
                return decode(enc, *args, **kwargs)

            engine._translator.decode = counting
            res = engine.transcribe(golden.GOLDEN_WAV).to_dict()
            segs = res["segments"]
            foreign = [s for s in segs if s["language_code"] != "en"]
            if (not segs or not foreign or not rows
                    or sum(rows) < len(foreign)
                    or not isinstance(res["summary"], str)
                    or not res["summary"]
                    or any(s["translation"] is not None for s in segs
                           if s["language_code"] == "en")):
                raise PhaseError(f"trainers: the engine with the {label} "
                                 f"translator answered {res}")
            log(f"  engine with the trained files ({label} translator): "
                f"{len(segs)} segments, {len(foreign)} non-English, "
                f"{sum(rows)} spans decoded, translations "
                f"{[s['translation'] for s in foreign]}, summary "
                f"{res['summary']!r} ({time.perf_counter() - t0:.2f} s)")
    log(f"  trainers launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4c (--profile): where a request's and a train step's time goes
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


def device_profile(label, fn, top: int) -> None:
    """One warm ``fn()`` (a request, a train step) under ``torch.profiler``:
    device time by kernel and the device's busy share of its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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
    log(f"  profile {label}: wall {wall * 1e3:.3f} ms, device "
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
        device_profile(f"{label} 120 s request",
                       lambda e=engines[label]: e.transcribe(paths[120.0]),
                       15 if label == "unquantized" else 8)
    engines["decoders"].transcribe(paths[120.0])          # warm-up
    device_profile("decoders 120 s request",
                   lambda: engines["decoders"].transcribe(paths[120.0]), 15)


PROFILE_TRAIN_STEPS = 6


def profile_train(dev) -> None:
    """Where a warm kernel-mode training step's time goes, at
    ``PipelineConfig()`` dims, batch 16: the host's wait for the batch, the
    upload, forward + loss, backward and the optimizer, each closed by a
    synchronize (medians over PROFILE_TRAIN_STEPS steps after 2 warm-up
    steps), then one whole step under ``torch.profiler``."""
    import dataclasses

    import numpy as np
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.ops.attention import REFERENCE_BLOCK_Q
    from omnilingual_asr_torch.ops.mel import MelFrontend
    from omnilingual_asr_torch.train import step
    from omnilingual_asr_torch.train.augment import (SpecAugmentConfig,
                                                     spec_augment)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = PipelineConfig()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    aug = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                            n_time_masks=1, time_mask_width=24)
    batcher = SynthBatcher(cfg, batch_size=TRAIN_BATCH, seed=SEED + 7,
                           frame_multiple=REFERENCE_BLOCK_Q * 4, n_threads=2,
                           snr_range=(15.0, 40.0), reuse_pool=6144,
                           reuse_p=0.8)
    tx = step.make_optimizer(lr=2e-3)
    init, train_step, _ = step.make_train_step(
        cfg, dev, tx=tx, from_samples=True, with_translator=True,
        augment=aug)
    state = init(SEED)
    params, opt = state.params, state.opt_state
    leaves = step.tree_leaves(params)
    fe = MelFrontend(cfg.frontend, dev)
    phases = {k: [] for k in ("batch_wait", "upload", "forward_loss",
                              "backward", "optimizer")}
    it = iter(batcher)

    def upload(batch):
        batch["samples"] = np.clip(batch["samples"] * 32768.0, -32768,
                                   32767).astype(np.int16)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        b[step.CTC_INFEASIBLE] = step.ctc_rows(batch, cfg)
        return b

    try:
        for i in range(2 + PROFILE_TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            b = upload(batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            b = step.mel_from_samples(b, fe)
            gen = torch.Generator(device=dev).manual_seed(i)
            b["mel"] = spec_augment(gen, b["mel"], b["mask"], aug)
            total, _ = step.loss_fn(params["asr"], b, cfg,
                                    trans_params=params["translator"])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            tx.update(opt, list(grads))
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            if i >= 2:
                for k, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2,
                                          t4 - t3, t5 - t4)):
                    phases[k].append(dt)
        med = {k: statistics.median(v) for k, v in phases.items()}
        log("  profile train step " + json.dumps({
            "steps": PROFILE_TRAIN_STEPS, "median_s": med,
            "step_s_median": sum(med.values()), "all_s": phases}))
        batch = upload(next(it))
        device_profile("kernel-mode train step",
                       lambda: train_step(params, opt, batch, 0), 20)
    finally:
        batcher.close()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 4c: request seconds by length and a "
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
        ptxas = {}
        for name, regs, spills in info.kernels():
            log(f"  {name}: {regs} registers, {spills}")
            ptxas[name] = f"{regs} registers, {spills}"
        if info.cached:
            log("  (a cached build: registers not read in this run)")
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
                   check_k3(dev, peaks, cfg, params, ptxas),
                   *check_quant(dev, peaks, params, ptxas),
                   *check_flash_bwd(dev, peaks, PipelineConfig())]
        for k in kernels:
            log(f"  {k['name']}: max abs err {k['max_abs_err']:.3e} (tol "
                f"{k['tol']}), {k['ms']:.4f} ms (one eager call "
                f"{k['call_ms']:.4f} ms), plain {k['plain_ms']:.4f} ms, "
                f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms "
                f"({k['bound_by']}), {k['shape']}")
            for w in (k.get("widths", []) + k.get("head_dims", [])
                      + k.get("shapes", [])):
                log(f"    {json.dumps(w)}")
        log(f"  recorded, not measured in this run: the earlier designs' "
            f"device ms {json.dumps(RECORDED_EARLIER_MS)}")
        log(f"[kernels] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "e2e"
        t0 = time.perf_counter()
        engines, serving = run_e2e(dev, cfg, params, xvector)
        log(f"[e2e] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "train"
        t0 = time.perf_counter()
        training = run_train(dev)
        grad_check(dev)
        log(f"[train] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "decoders"
        t0 = time.perf_counter()
        engines["decoders"], decoding = run_decoders(dev, cfg, params,
                                                     xvector)
        log(f"[decoders] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "server"
        t0 = time.perf_counter()
        served = run_server(engines["decoders"], smi)
        log(f"[server] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "d512"
        t0 = time.perf_counter()
        d512 = run_d512(dev, smi, params, xvector)
        log(f"[d512] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "evals"
        t0 = time.perf_counter()
        evals = run_evals(dev, cfg, params, xvector)
        log(f"[evals] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "trainers"
        t0 = time.perf_counter()
        trainers = run_trainers(dev, cfg, params, smi)
        log(f"[trainers] ok ({time.perf_counter() - t0:.2f} s)")

        if args.profile:
            phase = "profile"
            t0 = time.perf_counter()
            run_profile(engines)
            profile_train(dev)
            log(f"[profile] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "report"
        by_fn = {"log_mel": "log_mel_frames",
                 "flash_attention_fwd": "flash_attention",
                 "conv_module": "fused_conv_module",
                 "q_matmul_w8a16": "quantized_matmul",
                 "q8a8_matmul": "quantized_matmul_a8",
                 "flash_attention_bwd_dq": "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv": "flash_attention_bwd_dkv"}
        paths = {"serving": serving, "training": training,
                 "decoders": decoding, "server": served, "d512": d512,
                 "evals": evals, "trainers": trainers}
        line = {"kernels": []}
        for k in kernels:
            fn = by_fn[k["name"]]
            by_path = {p: c.get(fn, 0) for p, c in paths.items()}
            line["kernels"].append({
                "name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
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
