"""Shapes and tolerances at which the card holds K3 (the fused conv module)
and K5 (the W8A8 matmul) against their plain versions.

``chip_smoke.py`` checks and times the kernels at these shapes, and
``ops/conv_quant_sweep.py`` times its candidate tilings at the same ones;
both read them from here, so the two cannot drift apart.
"""

from __future__ import annotations

# K3, abs: LN output and SiLU output are rounded to bf16 in both; f32 inputs
# that differ in summation order can round one bf16 ulp apart, and one
# flipped input moves a 256-term pointwise sum by |w| * 2^-8 * |h|.
TOL_K3 = 5e-2
# K5, abs relative to max|ref|: the int32 sums are exact and every other
# step is the same f32 operation, so the kernel should equal its plain
# version bit for bit; any difference means an activation was quantized
# differently.
TOL_K5_REL = 1e-6

# K3 as (B, T, D, valid frames of each row): a serving batch (4 windows of
# 768 frames at the release width), a training step (16 windows of 256
# frames at PipelineConfig's width) and large_config's width, D 1024.
K3_SHAPES = {"serving": (4, 768, 256, (768, 700, 301, 0)),
             "training": (16, 256, 512, (256,) * 13 + (200, 77, 0)),
             "d1024": (4, 256, 1024, (256, 200, 77, 0))}

# K5 as (M, K, N): a serving batch's 4 x 768 frames through the release
# layers that take it, by width N (512 the CTC head, 1024 the FFN
# up-projections, 2048 the LID head).
K5_SHAPES = {f"n{n}": (3072, 256, n) for n in (512, 1024, 2048)}
