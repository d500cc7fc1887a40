"""Shapes and tolerances at which the card holds K3 (the fused conv module),
K4 (the W8A16 matmul) and K5 (the W8A8 matmul) against their plain
versions, and the log-mel (K1) shapes of the trainers.

``chip_smoke.py`` checks and times the kernels at these shapes, and
``ops/conv_quant_sweep.py`` times its candidate tilings at the same ones;
both read them from here, so the two cannot drift apart.
"""

from __future__ import annotations

# K3, abs: LN output and SiLU output are rounded to bf16 in both; f32 inputs
# that differ in summation order can round one bf16 ulp apart, and one
# flipped input moves a 256-term pointwise sum by |w| * 2^-8 * |h|.
TOL_K3 = 5e-2
# K4, per element: both sum the same exact bf16 x int8 products in f32 in
# another order, each within K * 2^-24 * sum|terms| of the exact sum, so
# |got - want| <= 2 K 2^-24 (|bf16(x)| @ |w_q|) scale[n], plus one f32
# rounding of the bias add (2^-23 |want|); see k4_error_share.
TOL_K4_ORDER = 2.0 ** -24
# K5, abs relative to max|ref|: the int32 sums are exact and every other
# step is the same f32 operation, so the kernel should equal its plain
# version bit for bit; any difference means an activation was quantized
# differently.
TOL_K5_REL = 1e-6

# K3 as (B, T, D, valid frames of each row): a serving batch (4 windows of
# 768 frames at the release width), a training step (16 windows of 256
# frames at PipelineConfig's width), large_config's width, D 1024, and a
# serving batch of the d512 x 12 seed (checkpoints/r5_d512x12_seed), and the
# eval drivers': eval.synth's batch of 10 s windows at the release width
# and eval.latency's one 30 s window of the flagship d512 x 12.
K3_SHAPES = {"serving": (4, 768, 256, (768, 700, 301, 0)),
             "training": (16, 256, 512, (256,) * 13 + (200, 77, 0)),
             "d1024": (4, 256, 1024, (256, 200, 77, 0)),
             "d512": (4, 768, 512, (768, 700, 301, 0)),
             "eval10s": (4, 256, 256, (249, 200, 77, 0)),
             "latency": (1, 768, 512, (749,))}

# K1 as (windows, frames a window padded to the 256-frame blocks, valid
# frames) on the trainers' paths: the x-vector trainer's batch of 64 4 s
# windows, the audio translator's frozen encoder on 64 8 s utterances, and
# the summarizer's 16 8 s windows of one conversation.
K1_TRAINER_SHAPES = {"xvector": (64, 512, 398),
                     "translator": (64, 1024, 798),
                     "summarizer": (16, 1024, 798)}

# K5 as (M, K, N): a serving batch's 4 x 768 frames through the release
# layers that take it, by width N (512 the CTC head, 1024 the FFN
# up-projections, 2048 the LID head).
K5_SHAPES = {f"n{n}": (3072, 256, n) for n in (512, 1024, 2048)}

# K4 at K5's shapes: the same layers take K4 under quantize="w8".
K4_SHAPES = dict(K5_SHAPES)


def k4_error_share(got, want, x, w_q, scale, bias=None):
    """(max |got - want|, its largest share of K4's per-element tolerance;
    > 1 fails). ``want`` is the plain version's output on the same
    inputs."""
    K = x.shape[1]
    xb = x.bfloat16().float().abs()
    tol = (2 * K * TOL_K4_ORDER * (xb.double() @ w_q.double().abs())
           * scale.double()).float()
    if bias is not None:
        tol = tol + 2.0 ** -23 * want.abs()
    diff = (got - want).abs()
    return float(diff.max()), float((diff / tol.clamp(min=1e-30)).max())
