"""Shapes and tolerances at which the card holds K3 (the fused conv module,
whole and split over the shards of a model axis), K4 (the W8A16 matmul)
and K5 (the W8A8 matmul) against their plain versions, the flash
attention (K2) shapes of the mesh paths, and the log-mel (K1) shapes of
the trainers.

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
# and eval.latency's one 30 s window of the flagship d512 x 12, and a data
# shard's batch of the mesh's data-parallel windows (2 of 4 windows).
K3_SHAPES = {"serving": (4, 768, 256, (768, 700, 301, 0)),
             "dp_shard": (2, 768, 256, (768, 301)),
             "training": (16, 256, 512, (256,) * 13 + (200, 77, 0)),
             "d1024": (4, 256, 1024, (256, 200, 77, 0)),
             "d512": (4, 768, 512, (768, 700, 301, 0)),
             "eval10s": (4, 256, 256, (249, 200, 77, 0)),
             "latency": (1, 768, 512, (749,))}

# K3 split over n shards of a model axis as (B, T, D, n, valid frames of
# each row): the release's serving batch at D / n = 128 and 64, a data
# row's batch of a (2, 2) mesh and the d512 seed's serving batch at 256
# and 128 (tensor parallelism at model 2 and 4).
K3_SPLIT_SHAPES = {"serving_tp2": (4, 768, 256, 2, (768, 700, 301, 0)),
                   "dp_shard_tp2": (2, 768, 256, 2, (768, 301)),
                   "serving_tp4": (4, 768, 256, 4, (768, 700, 301, 0)),
                   "d512_tp2": (4, 768, 512, 2, (768, 700, 301, 0)),
                   "d512_tp4": (4, 768, 512, 4, (768, 700, 301, 0))}

# K2 on the mesh paths as (B, T, H, head dim, valid keys of each row): a
# data shard's batch of the release (2 windows), the release's serving
# batch on one model shard's heads at model 2 and 4, and a data row's
# batch of a (2, 2) mesh on one model shard's heads.
K2_MESH_SHAPES = {"dp_shard": (2, 768, 4, 64, (768, 300)),
                  "dp_shard_tp2": (2, 768, 2, 64, (768, 300)),
                  "tp2": (4, 768, 2, 64, (768, 700, 300, 0)),
                  "tp4": (4, 768, 1, 64, (768, 700, 300, 0))}

# K1 as (windows, frames a window padded to the 256-frame blocks, valid
# frames) on the trainers' paths: the x-vector trainer's batch of 64 4 s
# windows, the audio translator's frozen encoder on 64 8 s utterances, and
# the summarizer's 16 8 s windows of one conversation.
K1_TRAINER_SHAPES = {"xvector": (64, 512, 398),
                     "translator": (64, 1024, 798),
                     "summarizer": (16, 1024, 798)}

# K1 on the rest of training's paths: the pretrainer's batch of 64 8 s
# windows (the audio translator's shape, its own run) and the manifest
# trainer's 16 15 s windows (1498 frames padded to 1536). The device pool's
# and AED's batches of 16 8 s windows are the training shape.
K1_REST_SHAPES = {"pretrain": (64, 1024, 798),
                  "manifest": (16, 1536, 1498)}

# K5 as (M, K, N): a serving batch's 4 x 768 frames through the release
# layers that take it, by width N (512 the CTC head, 1024 the FFN
# up-projections, 2048 the LID head).
K5_SHAPES = {f"n{n}": (3072, 256, n) for n in (512, 1024, 2048)}

# K4 at K5's shapes: the same layers take K4 under quantize="w8".
K4_SHAPES = dict(K5_SHAPES)

# K5 at a data shard's batch under "a8" (2 windows: M 1536), by width.
K5_DP_SHAPES = {f"n{n}": (1536, 256, n) for n in (512, 1024, 2048)}


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
