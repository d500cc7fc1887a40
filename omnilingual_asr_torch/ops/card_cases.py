"""Shapes and tolerances at which the card holds K3 (the fused conv module,
whole and split over the shards of a model axis), K4 (the W8A16 matmul)
and K5 (the W8A8 matmul) against their plain versions, the flash
attention (K2, and K6/K7 in training) shapes of the mesh paths and of the
f32 and f16 encoders, and the log-mel (K1) shapes of the trainers and of training
over a mesh.

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

# Training over a (data, model) mesh at PipelineConfig()'s width, batch 16
# of 8 s windows (T' 256): valid frames of a (2, 2) mesh's data row of 8
# and of a (1, 4) mesh's one row of 16.
TRAIN_ROW_VALID = (256,) * 5 + (200, 77, 1)
TRAIN_BATCH_VALID = (256,) * 12 + (200, 77, 1, 0)

# K3 split over n shards of a model axis as (B, T, D, n, valid frames of
# each row): the release's serving batch at D / n = 128 and 64, a data
# row's batch of a (2, 2) mesh and the d512 seed's serving batch at 256
# and 128 (tensor parallelism at model 2 and 4); training at d512, a data
# row of 8 at model 2 (the (2, 2) mesh) and the batch of 16 at model 4.
K3_SPLIT_SHAPES = {"serving_tp2": (4, 768, 256, 2, (768, 700, 301, 0)),
                   "dp_shard_tp2": (2, 768, 256, 2, (768, 301)),
                   "serving_tp4": (4, 768, 256, 4, (768, 700, 301, 0)),
                   "d512_tp2": (4, 768, 512, 2, (768, 700, 301, 0)),
                   "d512_tp4": (4, 768, 512, 4, (768, 700, 301, 0)),
                   "train_2x2": (8, 256, 512, 2, TRAIN_ROW_VALID),
                   "train_1x4": (16, 256, 512, 4, TRAIN_BATCH_VALID)}

# K2 on the mesh paths as (B, T, H, head dim, valid keys of each row): a
# data shard's batch of the release (2 windows), the release's serving
# batch on one model shard's heads at model 2 and 4, and a data row's
# batch of a (2, 2) mesh on one model shard's heads.
K2_MESH_SHAPES = {"dp_shard": (2, 768, 4, 64, (768, 300)),
                  "dp_shard_tp2": (2, 768, 2, 64, (768, 300)),
                  "tp2": (4, 768, 2, 64, (768, 700, 300, 0)),
                  "tp4": (4, 768, 1, 64, (768, 700, 300, 0))}

# K2 forward and K6/K7 backward when training over a mesh at
# PipelineConfig()'s width (8 heads of 64), as (B, T, H, head dim, valid
# keys of each row): a (2, 2) mesh's data row of 8 on one shard's 4 heads
# and a (1, 4) mesh's batch of 16 on one shard's 2 heads.
FLASH_TRAIN_MESH_SHAPES = {"train_2x2": (8, 256, 4, 64, TRAIN_ROW_VALID),
                           "train_1x4": (16, 256, 2, 64, TRAIN_BATCH_VALID)}

# K2, K6 and K7 at f32 (the f32 encoder, chip_smoke.py's phase 4m) as (B,
# T, H, head dim, valid keys of each row): the release's serving batch
# (4 windows of 768 frames, 4 heads of 64) and one model shard's 2 heads at
# model 2, the training step at PipelineConfig()'s width (batch 16 of 8 s,
# 8 heads of 64), large_config's head dim 128 at the serving length, and a
# ragged T of 200 (partial tiles of queries and keys).
F32_FLASH_SHAPES = {"serving": (4, 768, 4, 64, (768, 700, 300, 0)),
                    "serving_tp2": (4, 768, 2, 64, (768, 700, 300, 0)),
                    "training": (16, 256, 8, 64, TRAIN_BATCH_VALID),
                    "d128": (4, 768, 8, 128, (768, 700, 300, 0)),
                    "ragged": (3, 200, 4, 64, (200, 130, 0))}
# The f32 kernels against their plain versions, per element |got - want| <=
# TOL_F32_FLASH * max|want| (o, dQ, dK, dV) and |lse - lse_ref| <=
# TOL_F32_LSE. The f32 kernels take each product as three TF32 products
# (3xTF32: operands split into tf32 hi + lo, ~2^-21 of a product) and sum
# in f32, in another order than the plain version (streamed key tiles with
# an online softmax in the forward, against one pass). Their CPU models
# (ops/attention.py::flash_attention_fwd_tf32_emulated and
# ::flash_attention_bwd_tf32_emulated) put that at ~1e-6 of the largest
# element of o and of the gradients, and at ~1e-6 on lse. A dropped key, a
# bf16 rounding or a wrong p moves them by 1e-3 or more, one TF32 product
# in place of three by 5e-4 or more on o and the gradients and 1.8e-4 or
# more on lse (the models). Masked keys' dK and dV and fully-masked rows'
# dQ and o are exactly 0.
TOL_F32_FLASH = 1e-5
TOL_F32_LSE = 1e-5

# K2, K6 and K7 at f16 (the f16 encoder, chip_smoke.py's phase 4o): the
# f32 shapes above (the release's serving batch and one model shard's
# heads at model 2, the training step at PipelineConfig()'s width,
# large_config's head dim 128, a ragged T of 200).
F16_FLASH_SHAPES = F32_FLASH_SHAPES
# The f16 kernels against their plain versions, per element |got - want|
# <= TOL_F16_ABS * max|want| + TOL_F16_REL * |want| (+ TOL_F16_SUB where
# the outputs are f16 subnormals) and |lse - lse_ref| <= TOL_F16_LSE. Both
# round an f32 result to f16 once; the kernels' f32 values differ from the
# plain version's by the split of P or dS into f16 hi + lo under exact
# power-of-two scales (P x 2^14 in K2 and K7, dS under a running exponent
# a row in K6 and K7), ~2^-22 of a term, and by the order of sums. Where
# the two straddle an f16 rounding boundary they land one f16 ulp apart, at most 2^-10 |want| (TOL_F16_REL), or, for outputs
# under f16's normal range (the gradients at dO ~ 1e-6), one step of its
# subnormal grid, 2^-24 (TOL_F16_SUB). TOL_F16_ABS bounds the f32
# difference itself where terms cancel. The CPU models
# (ops/attention.py::flash_attention_fwd_f16_emulated and
# ::flash_attention_bwd_f16_emulated) put the f32 difference near 2^-22
# of the largest term (K2: 3.1e-7 and 4.1e-7 of max|o| at D 64 and 128 on
# tests/test_torch_f16.py's ragged case). The f16 operand rounded to
# bf16 (the bf16 kernels' arithmetic) moves o and the gradients by ~2e-3
# of their largest element; dS split in f16 without a scale flushes the
# gradients at dO ~ 1e-6 by two steps or more, and under a fixed scale
# that holds dO x 1 overflows f16 at dO x F16_LARGE_DO. lse takes exact
# products of f16 values and an f32 softmax in another order.
TOL_F16_ABS = 2.0 ** -13
TOL_F16_REL = 2.0 ** -10
TOL_F16_SUB = 2.0 ** -24
TOL_F16_LSE = 1e-4


def f16_share(got, want, sub: bool = False) -> float:
    """The largest share of its tolerance that an element of an f16
    kernel's result ``got`` (a tensor) uses against the plain version's
    ``want`` (<= 1 passes): TOL_F16_ABS max|want| + TOL_F16_REL |want|,
    plus TOL_F16_SUB when ``sub`` (outputs under f16's normal range);
    inf where ``got`` is not finite."""
    g, w = got.double(), want.double()
    if not bool(g.isfinite().all()):
        return float("inf")
    tol = (TOL_F16_ABS * w.abs().max() + TOL_F16_REL * w.abs()
           + (TOL_F16_SUB if sub else 0.0))
    return float(((g - w).abs() / tol).max())
# dO's scale in the second backward check at each f16 shape: a mean loss
# over a batch gives gradients this small, under f16's normal range.
F16_TINY_DO = 1e-6
# dO's scale in the third: dS reaches ~5e3, where a fixed scale of dS
# that holds dO x 1 would overflow f16 (the f16 K6's and K7's running
# exponents drop below 0), and the gradients stay inside f16's range: ~2e3
# at tests/test_torch_f16.py's shapes; at the training shape's row with one
# valid key every query's p is 1 and dV sums 256 queries' dO, 48832 on
# chip_smoke.py's seed (under 65504; x 2^11 would overflow there).
F16_LARGE_DO = 2.0 ** 10

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

# K1 when training over a mesh: a data row's 8 of a batch of 16 8 s windows
# (the (2, 2) and (2, 1) meshes: host batches, the pool and pretraining).
K1_MESH_SHAPES = {"train_row": (8, 1024, 798)}

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
