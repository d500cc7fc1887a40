"""PyTorch port: each CUDA kernel against its plain PyTorch version on the
card. These need an NVIDIA GPU (sm_90a) and the CUDA toolkit; without a card
they skip. On the card run ``python -m pytest tests/test_torch_cuda.py``.

Tolerances are chip_smoke.py's, with the same reasons.
"""

from __future__ import annotations

import pytest
import torch

from omnilingual_asr_torch.config import FrontendConfig
from omnilingual_asr_torch.ops import (attention, card_cases, conv_module,
                                       mel, quant)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [3072, 300, 1])
def test_log_mel_kernel_matches_plain(dev, n):
    cfg = FrontendConfig()
    fe = mel.MelFrontend(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    frames = 0.1 * torch.randn(n, cfg.n_fft, generator=gen, device=dev)
    frames[n // 2:] = 0.0
    before = mel.log_mel_frames.launches
    got = mel.log_mel_frames(frames, fe.cw, fe.sw, fe.fb, cfg.log_floor,
                             fe.plan)
    want = mel.log_mel_frames_plain(frames, fe.cw, fe.sw, fe.fb,
                                    cfg.log_floor)
    torch.cuda.synchronize()
    assert mel.log_mel_frames.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("T,valid,D", [(768, [768, 700, 300, 0], 64),
                                       (100, [100, 37, 1, 64], 64),
                                       (768, [768, 700, 300, 0], 128),
                                       (100, [100, 37, 1, 64], 128)])
def test_flash_kernel_matches_plain(dev, T, valid, D):
    B, H = len(valid), 4
    gen = torch.Generator(device=dev).manual_seed(T)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    o, lse = attention.flash_attention(q, k, v, mask)
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert float((o.float() - o_ref.float()).abs().max()) <= 1.6e-2
    live = lse_ref < 1e29
    assert float((lse - lse_ref)[live].abs().max()) <= 1e-3
    assert bool((lse[~live] == 1e30).all())


@pytest.mark.parametrize("T,valid,D,K", [(768, [768, 700, 301, 0], 256, 32),
                                         (50, [50, 13], 256, 32),
                                         (256, [256, 200, 77, 0], 512, 32),
                                         (256, [256, 200, 77, 0], 1024, 32),
                                         # T not a multiple of the 64-frame
                                         # tile; odd and even tap counts
                                         (97, [97, 64, 1, 0], 256, 31),
                                         (97, [97, 64, 1, 0], 256, 32)])
def test_conv_module_kernel_matches_plain(dev, T, valid, D, K):
    B = len(valid)
    gen = torch.Generator(device=dev).manual_seed(T)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    x = rnd(B, T, D)
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    bf16 = torch.bfloat16       # the kernel takes pw1/pw2 in bf16
    args = (x, mask, 1 + rnd(D, scale=0.1), rnd(D, scale=0.1),
            rnd(D, 2 * D, scale=D ** -0.5).to(bf16),
            rnd(K, D, scale=K ** -0.5), 1 + rnd(D, scale=0.1),
            rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5).to(bf16))
    before = conv_module.fused_conv_module.launches
    got = conv_module.fused_conv_module(*args)
    want = conv_module.conv_module_plain(*args)
    torch.cuda.synchronize()
    assert conv_module.fused_conv_module.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 5e-2


# Backward kernels against their plain versions, per element
# |g - g_ref| <= FLASH_BWD_ABS * max|g_ref| + 2^-7 |g_ref|: both round an
# f32 sum to bf16 (one ulp, 2^-8 relative, apart where they straddle a
# rounding boundary; 2^-7 covers the f32 sums differing on top of that),
# and the f32 sums of p * (dp - delta) over up to 768 keys, whose terms
# cancel, are taken in another order, which ABS bounds relative to the
# largest gradient element. A dropped key or a wrong p moves g by ~|g|.
FLASH_BWD_ABS = 2.0 ** -10


def _bwd_case(dev, B, T, H, D, valid, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    o, lse = attention.flash_attention(q, k, v, mask)
    delta = attention.flash_delta(o, do)
    return q, k, v, do, mask, lse, delta


def _within(got, want):
    got, want = got.float(), want.float()
    tol = FLASH_BWD_ABS * want.abs().max() + 2.0 ** -7 * want.abs()
    return bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("B,T,H,D,valid", [
    (16, 256, 8, 64, [256] * 12 + [200, 77, 1, 0]),
    (4, 768, 8, 128, [768, 700, 300, 0]),
    (3, 100, 2, 64, [100, 37, 0]),
    (2, 70, 2, 128, [70, 5])])
def test_flash_bwd_kernels_match_plain(dev, B, T, H, D, valid):
    """K6 and K7 against their plain versions at the training shape, at
    large_config's head dim and at ragged lengths; masked keys get exactly
    0 in dK and dV, fully-masked query rows exactly 0 in dQ."""
    q, k, v, do, mask, lse, delta = _bwd_case(dev, B, T, H, D, valid, T + D)
    n6 = attention.flash_attention_bwd_dq.launches
    n7 = attention.flash_attention_bwd_dkv.launches
    dq = attention.flash_attention_bwd_dq(q, k, v, mask, do, lse, delta)
    dk, dv = attention.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta)
    dq_ref = attention.flash_attention_bwd_dq_plain(q, k, v, mask, do, lse,
                                                    delta)
    dk_ref, dv_ref = attention.flash_attention_bwd_dkv_plain(
        q, k, v, mask, do, lse, delta)
    torch.cuda.synchronize()
    assert attention.flash_attention_bwd_dq.launches == n6 + 1
    assert attention.flash_attention_bwd_dkv.launches == n7 + 1
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got.float()).all())
        assert _within(got, want)
    dead_key = ~mask
    assert bool((dk[dead_key] == 0).all()) and bool((dv[dead_key] == 0).all())
    dead_row = ~mask.any(dim=1)
    assert bool((dq[dead_row] == 0).all())


@pytest.mark.parametrize("B,T,H,D,valid", [
    (16, 256, 8, 64, [256] * 12 + [200, 77, 1, 0]),
    (4, 768, 8, 128, [768, 700, 300, 0])])
def test_flash_bwd_kernels_are_deterministic(dev, B, T, H, D, valid):
    """K6 and K7 own their output rows (no atomics, a fixed order of sums):
    two calls on the same inputs give the same bits."""
    q, k, v, do, mask, lse, delta = _bwd_case(dev, B, T, H, D, valid,
                                              T + D + 1)
    args = (q, k, v, mask, do, lse, delta)

    def run():
        return (attention.flash_attention_bwd_dq(*args),
                *attention.flash_attention_bwd_dkv(*args))

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_attention_function_grads_match_plain(dev):
    """FlashAttention on the card (K2, K6, K7) against autograd through the
    plain forward in f32 on the same bf16 inputs; tolerance as above on
    top of the bf16 rounding of o, which both see."""
    B, T, H, D = 4, 256, 4, 64
    q, k, v, do, mask, _, _ = _bwd_case(dev, B, T, H, D, [256, 100, 3, 0],
                                        11)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention.FlashAttention.apply(*leaves, mask)
    o.backward(do)
    want = attention.flash_attention_bwd_plain(q, k, v, mask, o.detach(),
                                               attention.flash_attention(
                                                   q, k, v, mask)[1], do)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert _within(leaf.grad, w)


def test_fused_conv_module_function_grads_match_plain(dev):
    """FusedConvModule on the card (K3 forward, autograd of the plain
    version backward) against autograd through the plain version alone:
    the backward is the same computation on the same inputs, so the
    gradients agree up to the order of the card's f32 sums (rtol 1e-5)."""
    B, T, D, K = 2, 256, 256, 32
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)
                ).requires_grad_(True)

    x = rnd(B, T, D)
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        [T, 100], device=dev)[:, None]
    w = [rnd(D, scale=0.1), rnd(D, scale=0.1), rnd(D, 2 * D, scale=D ** -0.5),
         rnd(K, D, scale=K ** -0.5), rnd(D, scale=0.1), rnd(D, scale=0.1),
         rnd(D, D, scale=D ** -0.5)]
    g = torch.randn(B, T, D, generator=gen, device=dev)
    n3 = conv_module.fused_conv_module.launches
    out = conv_module.FusedConvModule.apply(x, mask, *w)
    assert conv_module.fused_conv_module.launches == n3 + 1
    got = torch.autograd.grad(out, [x, *w], g)
    ref = conv_module.conv_module_plain(x, mask, *w)
    want = torch.autograd.grad(ref, [x, *w], g)
    assert float((out - ref).abs().max()) <= 5e-2
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(
            b.abs().max()))


def test_large_config_engine_runs_k2_at_head_dim_128(dev, monkeypatch):
    """An engine at large_config's widths (d_model 1024, 8 heads of 128;
    depth cut to 2 layers) with random weights serves a request through K2
    at head dim 128, and K2 holds to its plain version on the q, k, v the
    engine gave it (chip_smoke.py's per-element tolerance)."""
    import dataclasses

    from omnilingual_asr_torch import testing
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models.zoo import large_config

    monkeypatch.setenv("OMNIASR_RELEASE_DIR", "")
    cfg = large_config()
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, n_layers=2))
    engine = TranscriptionEngine(config=cfg, device=dev,
                                 speaker_mode="inline")
    assert engine.infer_config.encoder.use_flash_attention
    seen = []
    kernel = attention.flash_attention

    def spy(q, k, v, mask):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone(), mask.clone()))
        return kernel(q, k, v, mask)

    # The wrapper counts its launches on the module's name, now the spy.
    spy.launches = 0
    monkeypatch.setattr(attention, "flash_attention", spy)
    engine.transcribe(testing.GOLDEN_WAV)
    assert spy.launches == 2
    q, k, v, mask = seen[0]
    assert q.shape[-1] == 128
    o, lse = kernel(q, k, v, mask)
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    tol = 1e-4 + 2.0 ** -7 * o_ref.float().abs()
    assert bool(((o.float() - o_ref.float()).abs() <= tol).all())
    live = lse_ref < 1e29
    assert float((lse - lse_ref)[live].abs().max()) <= 1e-3


def test_ctc_loss_on_the_card_takes_unalignable_rows_from_the_host(dev):
    """``ctc_loss`` on card tensors, with the unalignable rows given from
    the host as the trainer gives them: the loss equals the CPU's within
    1e-5 relative and the logits' gradient within 1e-4 relative L2, as the
    CPU's equals JAX's (f32; the same operations, with the card's own exp,
    log1p and reductions), finite where ``F.ctc_loss`` alone gives +inf."""
    import numpy as np
    from omnilingual_asr_torch.ops import ctc

    rng = np.random.default_rng(3)
    B, T, V, L = 4, 40, 32, 30
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[1, 1:6] = labels[1, 0]            # repeats: 30 + 5 > 32 frames
    n_frames = np.array([40, 32, 12, 40])
    n_labels = np.array([10, 30, 20, 0])
    fmask = np.arange(T)[None] < n_frames[:, None]
    lmask = np.arange(L)[None] < n_labels[:, None]
    rows = ctc.infeasible_rows(n_frames, labels, lmask)
    assert rows.tolist() == [1, 2]
    out = {}
    for where in ("cpu", dev):
        x = torch.from_numpy(logits).to(where).requires_grad_(True)
        loss = ctc.ctc_loss(x, torch.from_numpy(fmask).to(where),
                            torch.from_numpy(labels).to(where),
                            torch.from_numpy(lmask).to(where),
                            infeasible=rows)
        loss.backward()
        out[str(where)] = (float(loss.detach()), x.grad.cpu().numpy())
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    assert np.isfinite(lg) and lg > 1e4
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert np.linalg.norm(gg - gc) <= 1e-4 * np.linalg.norm(gc)


def test_kernel_mode_train_step_launch_counts(dev):
    """One kernel-mode step of ``make_train_step`` (d_model 128, 2 layers,
    heads of 64, T' 256, the translator on, from i16 samples) on the card:
    exactly 1 K1, 2 K2, 2 K6, 2 K7 and 2 K3 launches, no K4/K5, finite
    metrics, and the parameters moved (learning rate > 0 at count 1)."""
    import dataclasses

    import numpy as np
    from omnilingual_asr_torch.config import tiny_config
    from omnilingual_asr_torch.train import step
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = tiny_config()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    batcher = SynthBatcher(cfg, batch_size=2, window_seconds=8.0, seed=1,
                           frame_multiple=1024, n_threads=1)
    try:
        batch = next(iter(batcher))
    finally:
        batcher.close()
    batch["samples"] = np.clip(batch["samples"] * 32768.0, -32768,
                               32767).astype(np.int16)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    init, train_step, _ = step.make_train_step(
        cfg, dev, tx=step.make_optimizer(lr=1e-3, warmup_steps=1),
        from_samples=True, with_translator=True)
    state = init(0)
    state.opt_state.count = 1
    before = [p.detach().clone() for p in step.tree_leaves(state.params)]
    fns = (mel.log_mel_frames, attention.flash_attention,
           attention.flash_attention_bwd_dq, attention.flash_attention_bwd_dkv,
           conv_module.fused_conv_module, quant.quantized_matmul,
           quant.quantized_matmul_a8)
    for fn in fns:
        fn.launches = 0
    _, _, _, metrics = train_step(state.params, state.opt_state, b, 0)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] == [1, 2, 2, 2, 2, 0, 0]
    assert all(torch.isfinite(v) for v in metrics.values())
    after = step.tree_leaves(state.params)
    assert all(not torch.equal(a, b_) for a, b_ in zip(before, after))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q, torch.ones(1, 64, dtype=torch.bool,
                                                      device=dev))
    q = torch.zeros(1, 64, 2, 64, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        attention.flash_attention(q, q, q, torch.ones(1, 64, dtype=torch.bool,
                                                      device=dev))
    D = conv_module.KERNEL_MAX_D + 64          # over the width limit
    x = torch.zeros(1, 32, D, device=dev)
    v = torch.zeros(D, device=dev)
    with pytest.raises(ValueError, match="D <="):
        conv_module.fused_conv_module(
            x, torch.ones(1, 32, dtype=torch.bool, device=dev), v, v,
            torch.zeros(D, 2 * D, dtype=torch.bfloat16, device=dev),
            torch.zeros(32, D, device=dev), v, v,
            torch.zeros(D, D, dtype=torch.bfloat16, device=dev))
    # K4 and K5 serve only: an input that requires grad is refused.
    xq = torch.randn(64, 256, device=dev, requires_grad=True)
    w_q, scale = quant.quantize_weight(torch.randn(256, 128, device=dev))
    for fn in (quant.quantized_matmul, quant.quantized_matmul_a8):
        with pytest.raises(NotImplementedError, match="no backward"):
            fn(xq, w_q, scale)


def _quant_inputs(dev, M, K, N, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, generator=gen, device=dev)
    x[0] *= 1000.0                      # an outlier row keeps its own scale
    x[min(3, M - 1)] = 0.0              # an all-zero row
    w = 0.05 * torch.randn(K, N, generator=gen, device=dev)
    w_q, scale = quant.quantize_weight(w)
    bias = torch.randn(N, generator=gen, device=dev)
    return x, w_q, scale, bias


@pytest.mark.parametrize("M,K,N", [(3072, 256, 1024), (3072, 256, 512),
                                   (3072, 256, 2048), (70, 128, 128),
                                   (1, 384, 256),
                                   # where row stripes and column groups
                                   # meet the M edge
                                   (129, 256, 1024), (3071, 256, 1024)])
def test_q8a8_kernel_equals_plain(dev, M, K, N):
    """K5: int32 sums are exact and every other step is the same f32
    operation, so the kernel equals its plain version bit for bit."""
    x, w_q, scale, bias = _quant_inputs(dev, M, K, N, M + N)
    for b in (None, bias):
        before = quant.quantized_matmul_a8.launches
        got = quant.quantized_matmul_a8(x, w_q, scale, b)
        want = quant.quantized_matmul_a8_plain(x, w_q, scale, b)
        torch.cuda.synchronize()
        assert quant.quantized_matmul_a8.launches == before + 1
        assert int((got != want).sum()) == 0


@pytest.mark.parametrize("M,K,N", [(3072, 256, 1024), (3072, 256, 512),
                                   (3072, 256, 2048), (1, 384, 256),
                                   (129, 256, 1024)])
def test_q8a8_kernel_is_deterministic(dev, M, K, N):
    """K5: two calls on the same inputs are bit-identical (its int32 sums
    are exact, and nothing depends on the order blocks run in)."""
    x, w_q, scale, bias = _quant_inputs(dev, M, K, N, M + 7 * N)
    w_t = w_q.t().contiguous()
    first = quant.quantized_matmul_a8(x, w_q, scale, bias, w_t)
    second = quant.quantized_matmul_a8(x, w_q, scale, bias, w_t)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_q8a8_kernel_takes_a_wide_k(dev):
    """K5 at K = 8192 (its pre-pass keeps the first 512 columns of a row
    in registers and reads the rest again): still equal to its plain
    version bit for bit."""
    x, w_q, scale, bias = _quant_inputs(dev, 200, 8192, 256, 11)
    got = quant.quantized_matmul_a8(x, w_q, scale, bias)
    want = quant.quantized_matmul_a8_plain(x, w_q, scale, bias)
    torch.cuda.synchronize()
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("M,K,N", [(3072, 256, 1024), (3072, 256, 512),
                                   (3072, 256, 2048), (70, 128, 128),
                                   (1, 384, 256),
                                   # where row tiles meet the M edge
                                   (129, 256, 1024), (3071, 256, 1024),
                                   # large_config's FFN down-projection
                                   (3072, 4096, 1024),
                                   # more output tiles than the persistent
                                   # grid has blocks
                                   (8192, 256, 2048)])
def test_q_matmul_kernel_matches_plain(dev, M, K, N):
    """K4: the same exact bf16 x int8 products summed in f32 in another
    order; each element within 2 K 2^-24 sum|terms| * scale (+ one rounding
    of the bias add), card_cases.k4_error_share. One launch counted a
    call."""
    x, w_q, scale, bias = _quant_inputs(dev, M, K, N, M * N + K)
    for b in (None, bias):
        before = quant.quantized_matmul.launches
        got = quant.quantized_matmul(x, w_q, scale, b)
        want = quant.quantized_matmul_plain(x, w_q, scale, b)
        torch.cuda.synchronize()
        assert quant.quantized_matmul.launches == before + 1
        assert bool(torch.isfinite(got).all())
        assert card_cases.k4_error_share(got, want, x, w_q, scale, b)[1] <= 1


@pytest.mark.parametrize("M,K,N", [(3072, 256, 1024), (3072, 256, 512),
                                   (3072, 256, 2048), (129, 256, 1024),
                                   (3071, 256, 1024), (200, 4096, 1024)])
def test_q_matmul_kernel_is_deterministic(dev, M, K, N):
    """K4: two calls on the same inputs are bit-identical (each output is
    summed by one warp in a fixed order, whichever block owns its tile)."""
    x, w_q, scale, bias = _quant_inputs(dev, M, K, N, M + 5 * N)
    w_t = w_q.t().contiguous()
    first = quant.quantized_matmul(x, w_q, scale, bias, w_t)
    second = quant.quantized_matmul(x, w_q, scale, bias, w_t)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_quant_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(64, 256, device=dev)
    w_q, scale = quant.quantize_weight(torch.randn(256, 512, device=dev))
    for fn in (quant.quantized_matmul, quant.quantized_matmul_a8):
        with pytest.raises(TypeError):              # x must be f32
            fn(x.to(torch.bfloat16), w_q, scale)
        with pytest.raises(ValueError, match="contiguous"):
            fn(torch.randn(256, 64, device=dev).t(), w_q, scale)
        w96, s96 = quant.quantize_weight(torch.randn(96, 512, device=dev))
        with pytest.raises(ValueError, match="K % 128"):
            fn(torch.randn(64, 96, device=dev), w96, s96)
        w200, s200 = quant.quantize_weight(torch.randn(256, 200, device=dev))
        with pytest.raises(ValueError, match="N % 128"):
            fn(x, w200, s200)
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, w_q.cpu(), scale)
