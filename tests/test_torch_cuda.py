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


@pytest.mark.parametrize("n", [3072, 300, 1, 4096])
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
                                       (100, [100, 37, 1, 64], 128),
                                       # the eval drivers' 10 s windows
                                       # and batch-1 latency
                                       (256, [249, 200, 77, 0], 64),
                                       (768, [749], 64)])
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
                                         (97, [97, 64, 1, 0], 256, 32),
                                         # the eval drivers' 10 s windows
                                         # and batch-1 latency
                                         (256, [249, 200, 77, 0], 256, 32),
                                         (768, [749], 512, 32)])
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


@pytest.mark.parametrize("T,valid,D,n", [(768, [768, 700, 301, 0], 256, 2),
                                         (768, [768, 700, 301, 0], 256, 4),
                                         (768, [768, 700, 301, 0], 512, 2),
                                         (768, [768, 700, 301, 0], 512, 4),
                                         (97, [97, 64, 1, 0], 512, 8),
                                         (256, [256, 200, 77, 0], 1024, 16)])
def test_split_conv_module_kernel_matches_plain_split(dev, T, valid, D, n):
    """K3 split over n shards of D / n channels (three launches a shard)
    against the plain split and against unsharded K3 on the same whole
    weights; a shard narrower than 64 channels raises."""
    B, K = len(valid), 32
    gen = torch.Generator(device=dev).manual_seed(T + n)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    x = rnd(B, T, D)
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    bf16 = torch.bfloat16
    ln_s, ln_b = 1 + rnd(D, scale=0.1), rnd(D, scale=0.1)
    pw1 = rnd(D, 2 * D, scale=D ** -0.5).to(bf16)
    dw = rnd(K, D, scale=K ** -0.5)
    dl_s, dl_b = 1 + rnd(D, scale=0.1), rnd(D, scale=0.1)
    pw2 = rnd(D, D, scale=D ** -0.5).to(bf16)
    dl = D // n
    pw1s = [torch.cat([pw1[:, m * dl:(m + 1) * dl],
                       pw1[:, D + m * dl:D + (m + 1) * dl]], 1).contiguous()
            for m in range(n)]
    args = ([x] * n, [mask] * n, [ln_s] * n, [ln_b] * n, pw1s,
            [dw[:, m * dl:(m + 1) * dl].contiguous() for m in range(n)],
            [dl_s] * n, [dl_b] * n,
            [pw2[m * dl:(m + 1) * dl].contiguous() for m in range(n)])
    before = conv_module.fused_conv_module_split.launches
    got = conv_module.fused_conv_module_split(*args)
    want = conv_module.conv_module_split_plain(*args)
    whole = conv_module.fused_conv_module(x, mask, ln_s, ln_b, pw1, dw,
                                          dl_s, dl_b, pw2)
    torch.cuda.synchronize()
    assert conv_module.fused_conv_module_split.launches == before + n
    assert bool(torch.isfinite(got[0]).all())
    assert float((got[0] - want[0]).abs().max()) <= card_cases.TOL_K3
    assert float((got[0] - whole).abs().max()) <= card_cases.TOL_K3
    with pytest.raises(ValueError, match="64"):     # 32 channels a shard
        conv_module.split_stage1_kernel(x, mask, ln_s, ln_b,
                                        pw1[:, :64].contiguous(),
                                        dw[:, :32].contiguous())


@pytest.mark.parametrize("B,T,D,n,valid", [
    card_cases.K3_SPLIT_SHAPES["train_2x2"],
    card_cases.K3_SPLIT_SHAPES["train_1x4"]])
def test_split_conv_module_function_matches_plain_split(dev, B, T, D, n,
                                                        valid):
    """``FusedConvModuleSplit`` (K3's split launches forward, autograd of
    the plain split backward), as training over a mesh calls it through
    ``tp_convmod_apply_fused``, against ``conv_module_split_plain`` under
    autograd on the same f32 weights: the forward within TOL_K3 and each
    input's gradient within 5e-2 relative L2 (the forward's bf16 roundings
    of LN and SiLU outputs flip where f32 sums differ in order, which moves
    the loss's gradient by about a bf16 ulp, as phase 4b's criterion)."""
    from omnilingual_asr_torch.parallel.mesh import Split, split_block

    K = 32
    gen = torch.Generator(device=dev).manual_seed(B + n)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)

    x = rnd(B, T, D)
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    whole = {"ln": {"scale": 1 + rnd(D, scale=0.1),
                    "bias": rnd(D, scale=0.1)},
             "pw1": {"w": rnd(D, 2 * D, scale=D ** -0.5)},
             "dw": rnd(K, D, scale=K ** -0.5),
             "dw_ln": {"scale": 1 + rnd(D, scale=0.1),
                       "bias": rnd(D, scale=0.1)},
             "pw2": {"w": rnd(D, D, scale=D ** -0.5)}}
    specs = {"pw1": Split("model", 1, 2), "dw": Split("model", 1),
             "pw2": Split("model", 0)}
    cot = rnd(B, T, D)

    def run(fused):
        leaves = {k: (whole[k]["w"] if k in ("pw1", "pw2") else whole[k])
                  for k in specs}
        ps, params = [], []
        xr = x.clone().requires_grad_(True)
        shared = {k: {n_: t.clone().requires_grad_(True)
                      for n_, t in whole[k].items()}
                  for k in ("ln", "dw_ln")}
        for m in range(n):
            blocks = {k: split_block(t, specs[k], m, n).contiguous()
                      .requires_grad_(True) for k, t in leaves.items()}
            params += list(blocks.values())
            ps.append({"ln": shared["ln"], "dw_ln": shared["dw_ln"],
                       "pw1": {"w": blocks["pw1"]}, "dw": blocks["dw"],
                       "pw2": {"w": blocks["pw2"]}})
        params += [t for d in shared.values() for t in d.values()]
        if fused:
            out = conv_module.tp_convmod_apply_fused(ps, [xr] * n,
                                                     [mask] * n)[0]
        else:
            out = conv_module.conv_module_split_plain(
                [xr] * n, [mask] * n, [p["ln"]["scale"] for p in ps],
                [p["ln"]["bias"] for p in ps], [p["pw1"]["w"] for p in ps],
                [p["dw"] for p in ps], [p["dw_ln"]["scale"] for p in ps],
                [p["dw_ln"]["bias"] for p in ps],
                [p["pw2"]["w"] for p in ps])[0]
        grads = torch.autograd.grad((out * cot).sum(), [xr] + params)
        return out.detach(), grads

    before = conv_module.fused_conv_module_split.launches
    got, g_got = run(True)
    assert conv_module.fused_conv_module_split.launches == before + n
    want, g_want = run(False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= card_cases.TOL_K3
    for a, b in zip(g_got, g_want):
        rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert rel <= 5e-2, rel


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


@pytest.mark.parametrize("name", sorted(card_cases.F32_FLASH_SHAPES))
def test_flash_f32_kernels_match_plain(dev, name):
    """The f32 variants of K2, K6 and K7 against their plain versions at
    the f32 encoder's shapes (card_cases.F32_FLASH_SHAPES, tolerances
    there): each launches once, counted by its own f32 counter and by no
    bf16 one; masked keys and fully-masked rows get exactly 0."""
    B, T, H, D, valid = card_cases.F32_FLASH_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(T + D)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   for _ in range(4))
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    fns = (attention.flash_attention_f32,
           attention.flash_attention_bwd_dq_f32,
           attention.flash_attention_bwd_dkv_f32, attention.flash_attention,
           attention.flash_attention_bwd_dq,
           attention.flash_attention_bwd_dkv)
    before = [f.launches for f in fns]
    o, lse = attention.flash_attention(q, k, v, mask)
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    delta = attention.flash_delta(o_ref, do)
    args = (q, k, v, mask, do, lse_ref, delta)
    dq = attention.flash_attention_bwd_dq(*args)
    dk, dv = attention.flash_attention_bwd_dkv(*args)
    dq_ref = attention.flash_attention_bwd_dq_plain(*args)
    dk_ref, dv_ref = attention.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 0, 0, 0]
    for got, want in ((o, o_ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.float32
        err = float((got - want).abs().max())
        assert err <= card_cases.TOL_F32_FLASH * float(want.abs().max())
    live = lse_ref < 1e29
    assert float((lse - lse_ref)[live].abs().max()) <= card_cases.TOL_F32_LSE
    assert bool((lse[~live] == 1e30).all())
    dead_row = ~mask.any(dim=1)
    assert bool((o[dead_row] == 0).all()) and bool((dq[dead_row] == 0).all())
    assert bool((dk[~mask] == 0).all()) and bool((dv[~mask] == 0).all())


def test_flash_f32_function_grads_match_plain(dev):
    """FlashAttention at f32 on the card (the f32 K2, K6, K7) against
    autograd through the plain forward on the same inputs."""
    B, T, H, D = 4, 256, 4, 64
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   for _ in range(4))
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        [256, 100, 3, 0], device=dev)[:, None]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention.FlashAttention.apply(*leaves, mask)
    o.backward(do)
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    want = attention.flash_attention_bwd_plain(q, k, v, mask, o_ref,
                                               lse_ref, do)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.float32
        err = float((leaf.grad - w).abs().max())
        assert err <= card_cases.TOL_F32_FLASH * float(w.abs().max())


@pytest.mark.parametrize("scale", [1.0, card_cases.F16_TINY_DO,
                                   card_cases.F16_LARGE_DO])
@pytest.mark.parametrize("name", sorted(card_cases.F16_FLASH_SHAPES))
def test_flash_f16_kernels_match_plain(dev, name, scale):
    """The f16 variants of K2, K6 and K7 against their plain versions at
    the f16 encoder's shapes (card_cases.F16_FLASH_SHAPES, tolerances
    there), at dO x 1, x F16_TINY_DO (gradients under f16's normal range,
    where dS split in f16 without a scale would flush) and x F16_LARGE_DO
    (where a fixed scale of dS would overflow f16): each launches once,
    counted by its own f16 counter and by no bf16 or f32 one; masked keys
    and fully-masked rows get exactly 0."""
    B, T, H, D, valid = card_cases.F16_FLASH_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(T + D + 16)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   for _ in range(4))
    q, k, v, do = q.half(), k.half(), v.half(), (do * scale).half()
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    fns = (attention.flash_attention_f16,
           attention.flash_attention_bwd_dq_f16,
           attention.flash_attention_bwd_dkv_f16, attention.flash_attention,
           attention.flash_attention_bwd_dq,
           attention.flash_attention_bwd_dkv,
           attention.flash_attention_f32)
    before = [f.launches for f in fns]
    o, lse = attention.flash_attention(q, k, v, mask)
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    delta = attention.flash_delta(o_ref, do)
    args = (q, k, v, mask, do, lse_ref, delta)
    dq = attention.flash_attention_bwd_dq(*args)
    dk, dv = attention.flash_attention_bwd_dkv(*args)
    dq_ref = attention.flash_attention_bwd_dq_plain(*args)
    dk_ref, dv_ref = attention.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 0, 0,
                                                             0, 0]
    assert card_cases.f16_share(o, o_ref, False) <= 1.0
    for got, want in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert got.dtype == torch.float16
        assert card_cases.f16_share(got, want, scale < 1.0) <= 1.0
    live = lse_ref < 1e29
    assert float((lse - lse_ref)[live].abs().max()) <= card_cases.TOL_F16_LSE
    assert bool((lse[~live] == 1e30).all())
    dead_row = ~mask.any(dim=1)
    assert bool((o[dead_row] == 0).all()) and bool((dq[dead_row] == 0).all())
    assert bool((dk[~mask] == 0).all()) and bool((dv[~mask] == 0).all())


def _f16_fwd_case(dev, B, T, H, D, valid, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device=dev).half()
               for _ in range(3))
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        valid, device=dev)[:, None]
    return q, k, v, mask


def _check_f16_fwd(q, k, v, mask, o, lse):
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert o.dtype == torch.float16
    assert card_cases.f16_share(o, o_ref, False) <= 1.0
    live = lse_ref < 1e29
    assert float((lse - lse_ref)[live].abs().max()) <= card_cases.TOL_F16_LSE
    assert bool((lse[~live] == 1e30).all())
    assert bool((o[~mask.any(dim=1)] == 0).all())


@pytest.mark.parametrize("B,T,H,D,valid", [
    # T not a multiple of the 64-row TMA box: the last box's rows past T
    # are zero-filled by the hardware, still counted by expect_tx
    (3, 200, 4, 64, [200, 130, 0]),
    (2, 1000, 2, 64, [1000, 999]),
    # a fully masked batch slot beside full and one-key rows
    (4, 256, 2, 64, [0, 256, 1, 0]),
    # D 128: two boxes of 64 columns a tile
    (2, 1000, 2, 128, [1000, 0]),
    (3, 77, 1, 128, [77, 1, 0])])
def test_flash_f16_forward_edges(dev, B, T, H, D, valid):
    """The f16 K2 (csrc/attention_f16.cu, TMA and wgmma) where its copies
    reach past T, a slot is fully masked and D 128 takes two boxes a tile:
    o and lse against the plain forward within card_cases.TOL_F16_*, one
    launch counted, fully masked rows exactly 0 and lse +1e30."""
    q, k, v, mask = _f16_fwd_case(dev, B, T, H, D, valid, T + D)
    before = attention.flash_attention_f16.launches
    o, lse = attention.flash_attention(q, k, v, mask)
    assert attention.flash_attention_f16.launches == before + 1
    _check_f16_fwd(q, k, v, mask, o, lse)


def test_flash_f16_forward_takes_aligned_views(dev):
    """q, k and v as contiguous views of one larger allocation at offsets
    that keep them 16-byte aligned (8 f16 elements and more): the same
    o and lse, bit for bit, as from separate tensors."""
    B, T, H, D = 2, 200, 2, 64
    q, k, v, mask = _f16_fwd_case(dev, B, T, H, D, [200, 150], 23)
    n = q.numel()
    buf = torch.zeros(3 * n + 64, dtype=torch.float16, device=dev)
    views = []
    for i, (x, off) in enumerate(zip((q, k, v), (8, 24, 40))):
        view = buf[i * n + off:(i + 1) * n + off].view(B, T, H, D)
        view.copy_(x)
        assert view.data_ptr() % 16 == 0 and view.data_ptr() % 64 != 0
        views.append(view)
    o, lse = attention.flash_attention_f16(q, k, v, mask)
    ov, lsev = attention.flash_attention_f16(*views, mask)
    torch.cuda.synchronize()
    assert torch.equal(o, ov) and torch.equal(lse, lsev)
    _check_f16_fwd(q, k, v, mask, ov, lsev)


def test_flash_f16_forward_refuses_a_misaligned_pointer(dev):
    """An f16 operand 2 bytes off a 16-byte boundary: the wrapper raises
    and launches nothing, and the C entry point itself refuses to encode
    its tensor map (no fallback to another kernel)."""
    import math

    from omnilingual_asr_torch.ops import cuda_build

    B, T, H, D = 1, 64, 1, 64
    q, k, v, mask = _f16_fwd_case(dev, B, T, H, D, [64], 5)
    buf = torch.zeros(q.numel() + 8, dtype=torch.float16, device=dev)
    bad = buf[1:1 + q.numel()].view(B, T, H, D)
    bad.copy_(q)
    before = attention.flash_attention_f16.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.flash_attention_f16(bad, k, v, mask)
    assert attention.flash_attention_f16.launches == before
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, device=dev)
    m32 = mask.to(torch.int32)
    lib = cuda_build.library()
    err = lib.omni_flash_fwd_f16(
        bad.data_ptr(), k.data_ptr(), v.data_ptr(), m32.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, T, H, D, 1.0 / math.sqrt(D),
        cuda_build.stream_ptr(dev))
    assert err != 0
    assert b"16-byte" in lib.omni_error_string(err)


def test_flash_f16_function_grads_match_plain(dev):
    """FlashAttention at f16 on the card (the f16 K2, K6, K7) against the
    plain backward from the plain forward on the same inputs, within
    card_cases' f16 tolerance."""
    B, T, H, D = 4, 256, 4, 64
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen,
                               device=dev).half() for _ in range(4))
    mask = torch.arange(T, device=dev)[None] < torch.tensor(
        [256, 100, 3, 0], device=dev)[:, None]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attention.FlashAttention.apply(*leaves, mask)
    o.backward(do)
    o_ref, lse_ref = attention.flash_attention_plain(q, k, v, mask)
    want = attention.flash_attention_bwd_plain(q, k, v, mask, o_ref,
                                               lse_ref, do)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.float16
        assert card_cases.f16_share(leaf.grad, w, False) <= 1.0


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
    # bf16, f32 and f16 take the kernels (f32 and f16: their variants);
    # f64 none.
    q = torch.zeros(1, 64, 2, 64, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        attention.flash_attention(q, q, q, torch.ones(1, 64, dtype=torch.bool,
                                                      device=dev))
    # The f32 and f16 kernels check each operand against their dtype.
    q = torch.zeros(1, 64, 2, 64, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        attention.flash_attention_f32(q, q.bfloat16(), q, torch.ones(
            1, 64, dtype=torch.bool, device=dev))
    with pytest.raises(TypeError):
        attention.flash_attention_f16(q.half(), q.bfloat16(), q.half(),
                                      torch.ones(1, 64, dtype=torch.bool,
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


# ---------------------------------------------------------------------------
# The decoders: CUDA-graph replay against eager decoding and the CPU
# ---------------------------------------------------------------------------

def _release_decoder(name, device, **kwargs):
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models import translation
    from omnilingual_asr_torch.testing import TESTDATA

    release = TESTDATA.parents[1] / "checkpoints" / "release"
    cfg = PipelineConfig.from_json((release / "config.json").read_text())
    params = translation.load_translator(
        release / f"{name}.npz", cfg, n_layers=4 if name == "translator"
        else 2, device=device)
    return translation.GreedyDecoder(params, cfg, **kwargs), cfg


def _fixture_spans(cfg, rows: int = 128):
    """The golden fixture's translated spans in the engine's batch of 128
    rows, with a reversed copy of each span in the next rows."""
    import numpy as np

    from omnilingual_asr_torch import testing
    from omnilingual_asr_torch.models.translation import source_to_tokens

    spans = [t["span"] for t in testing.load_golden_decoders()["translations"]]
    spans += [s[::-1] for s in spans]
    ids = np.zeros((rows, 256), np.int32)
    mask = np.zeros((rows, 256), bool)
    for r, sp in enumerate(spans):
        ids[r], mask[r] = source_to_tokens(sp, cfg.vocab)
    return torch.from_numpy(ids), torch.from_numpy(mask), len(spans)


def test_decoder_graph_tokens_equal_eager(dev):
    """Translator and summarizer decodes replayed from their CUDA graphs
    equal the same decodes run eagerly on the card, on two inputs in turn
    through one captured graph each (its static buffers reused)."""
    from omnilingual_asr_torch.models.summarizer import fact_prefix_ids

    graph, cfg = _release_decoder("translator", dev)
    eager, _ = _release_decoder("translator", dev, use_graph=False)
    assert graph.use_graph and not eager.use_graph
    ids, mask, _ = _fixture_spans(cfg)
    for src, m in ((ids, mask), (ids.roll(1, 0), mask.roll(1, 0))):
        assert torch.equal(graph.translate_text(src, m, max_len=128),
                           eager.translate_text(src, m, max_len=128))
    assert len(graph._states) == 1
    summ, _ = _release_decoder("summarizer", dev)
    summ_eager, _ = _release_decoder("summarizer", dev, use_graph=False)
    gen = torch.Generator(device=dev).manual_seed(7)
    prefix = fact_prefix_ids(cfg.vocab, n_speakers=2, tone="neutral",
                             language_names=["Georgian", "Greek"])
    forced = torch.full((1, 192), -1, dtype=torch.int32)
    forced[0, :len(prefix)] = torch.tensor(prefix)
    for valid in (1, 5):
        enc = 0.5 * torch.randn(1, 128, 256, generator=gen, device=dev)
        m = (torch.arange(128, device=dev) < valid)[None]
        assert torch.equal(summ.decode(enc, m, max_len=192, forced=forced),
                           summ_eager.decode(enc, m, max_len=192,
                                             forced=forced))


def test_decoder_card_translate_text_equals_cpu(dev):
    """The card's text-mode translation of the golden fixture's spans
    equals the CPU's, and the JAX engine's stored tokens."""
    from omnilingual_asr_torch import testing

    card, cfg = _release_decoder("translator", dev)
    cpu, _ = _release_decoder("translator", torch.device("cpu"))
    ids, mask, n = _fixture_spans(cfg, rows=8)
    got = card.translate_text(ids, mask, max_len=128).cpu()
    assert torch.equal(got[:n], cpu.translate_text(ids[:n], mask[:n],
                                                   max_len=128))
    stored = testing.load_golden_decoders()["translations"]
    assert [got[i].tolist() for i in range(len(stored))] == \
        [t["tokens"] for t in stored]


# ---------------------------------------------------------------------------
# One engine on the card, several threads; the port's server on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def release_engine_cuda():
    """The port's engine on the card with the release ASR, x-vector,
    translator and summarizer weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.testing import TESTDATA

    release = TESTDATA.parents[1] / "checkpoints" / "release"
    cfg = PipelineConfig.from_json((release / "config.json").read_text(),
                                   checkpoint_path=str(release / "asr.npz"))
    return TranscriptionEngine(
        config=cfg, device="cuda", xvector_path=str(release / "xvector.npz"),
        translator_path=str(release / "translator.npz"),
        summarizer_path=str(release / "summarizer.npz"))


@pytest.fixture(scope="module")
def four_files(tmp_path_factory):
    """Four different files: the golden one, the golden audio tiled to
    60 s and to 100 s, and the golden audio as a 44.1 kHz stereo WAV."""
    import wave

    import numpy as np

    from omnilingual_asr_torch.audio.decode import decode_wav_bytes
    from omnilingual_asr_torch.audio.resample import resample
    from omnilingual_asr_torch.testing import GOLDEN_WAV

    d = tmp_path_factory.mktemp("four")
    x, sr = decode_wav_bytes(GOLDEN_WAV.read_bytes())

    def write(path, samples, rate, channels=1):
        pcm = np.clip(np.round(samples * 32767), -32768,
                      32767).astype("<i2")
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        return path

    files = [GOLDEN_WAV]
    for seconds in (60, 100):
        files.append(write(d / f"t{seconds}.wav",
                           np.resize(x, seconds * sr), sr))
    y = resample(x, sr, 44_100)
    files.append(write(d / "stereo.wav", np.stack([y, 0.5 * y], axis=1),
                       44_100, channels=2))
    return files


def test_engine_four_threads_equal_alone(release_engine_cuda, four_files):
    """Four threads transcribe four files on one engine on the card (the
    server's batch route); each result equals the same file alone,
    exactly. Without the engine's device lock the decoders' CUDA graphs
    share their static buffers across threads."""
    from concurrent.futures import ThreadPoolExecutor

    eng = release_engine_cuda
    alone = [eng.transcribe(p).to_dict() for p in four_files]
    for _ in range(2):
        with ThreadPoolExecutor(max_workers=4) as pool:
            got = list(pool.map(lambda p: eng.transcribe(p).to_dict(),
                                four_files))
        assert got == alone


def test_server_on_card_answers_golden(release_engine_cuda, tmp_path):
    """The port's server in front of the card's engine answers the golden
    file through HTTP with what ``engine.transcribe`` returns."""
    import http.client
    import json

    from omnilingual_asr_torch.serving.app import OmniServer
    from omnilingual_asr_torch.serving.schema import result_to_entry
    from omnilingual_asr_torch.testing import GOLDEN_WAV

    eng = release_engine_cuda
    want = result_to_entry(eng.transcribe(GOLDEN_WAV), file_name="g.wav",
                           audio_url="")
    srv = OmniServer(engine=eng, base_dir=tmp_path)
    port = srv.serve_background()
    try:
        boundary = "cardtestboundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"g.wav\"\r\n\r\n".encode()
                + GOLDEN_WAV.read_bytes()
                + f"\r\n--{boundary}--\r\n".encode())
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/api/transcribe", body=body, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        resp = conn.getresponse()
        got = json.loads(resp.read())
        conn.close()
    finally:
        srv.shutdown()
    assert resp.status == 200
    for key in ("segments", "summary", "detected_languages"):
        assert got.get(key) == want.get(key)
    assert got["file_name"] == "g.wav" and got["id"]


# ---------------------------------------------------------------------------
# The eval drivers on the card, against the JAX package's golden_evals.json
# ---------------------------------------------------------------------------

def _release_cuda(**kwargs):
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.testing import TESTDATA

    release = TESTDATA.parents[1] / "checkpoints" / "release"
    cfg = PipelineConfig.from_json((release / "config.json").read_text(),
                                   checkpoint_path=str(release / "asr.npz"))
    return TranscriptionEngine(config=cfg, device="cuda",
                               xvector_path=str(release / "xvector.npz"),
                               **kwargs)


def test_eval_synth_on_card_matches_golden_evals(dev, tmp_path):
    """eval.synth's first 8 files at 10 s windows on the card: texts and
    greedy ids by the fixture's criterion, one K1 and four K2 and K3
    launches a batch."""
    from omnilingual_asr_torch import testing
    from omnilingual_asr_torch.eval.synth import build_manifest, \
        evaluate_sets

    stored = testing.load_golden_evals()["synth"]
    eng = _release_cuda(window_seconds=stored["window_seconds"])
    manifest = build_manifest(tmp_path, 8, include_real=True)
    before = [f.launches for f in (mel.log_mel_frames,
                                   attention.flash_attention,
                                   conv_module.fused_conv_module)]
    with testing.recorded_ctc_ids(eng) as ids:
        _, reports = evaluate_sets(eng, manifest, tmp_path)
    hyps = [r["hyp"] for r in reports["synth"].per_file]
    assert testing.synth_mismatches(stored, hyps, ids) == []
    after = [f.launches for f in (mel.log_mel_frames,
                                  attention.flash_attention,
                                  conv_module.fused_conv_module)]
    assert [a - b for a, b in zip(after, before)] == [8, 32, 32]


def test_eval_long_on_card_matches_golden_evals(dev, tmp_path):
    """eval.long's engine on the 420 s file on the card: streamed, its
    greedy ids and its result's structure by ``testing.long_mismatches``."""
    from omnilingual_asr_torch import testing
    from omnilingual_asr_torch.eval.long import long_report, make_long_audio

    stored = testing.load_golden_evals()["long"]
    eng = _release_cuda(batch_windows_per_device=stored["batch_windows"])
    path = make_long_audio(stored["seconds"], tmp_path / "long.wav")
    with testing.recorded_ctc_ids(eng) as ids:
        report, result = long_report(eng, path, stored["seconds"],
                                     420 / 3600)
    assert testing.long_mismatches(stored, result.to_dict(),
                                   report["stages_s"], ids[0]) == []
    assert report["device_peak_gb"] > 0


@pytest.mark.parametrize("name", sorted(card_cases.K1_TRAINER_SHAPES))
def test_log_mel_kernel_at_the_trainers_shapes(dev, name):
    """K1 at the trainers' shapes (the x-vector's 64 4 s windows, the audio
    translator's 64 8 s utterances, the summarizer's 16 8 s windows),
    padding rows zero: one launch, within chip_smoke's TOL_K1 of the plain
    version."""
    B, t_pad, valid = card_cases.K1_TRAINER_SHAPES[name]
    cfg = FrontendConfig()
    fe = mel.MelFrontend(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(B + t_pad)
    frames = 0.1 * torch.randn(B, t_pad, cfg.n_fft, generator=gen,
                               device=dev)
    frames[:, valid:] = 0.0
    frames = frames.reshape(-1, cfg.n_fft).contiguous()
    before = mel.log_mel_frames.launches
    got = mel.log_mel_frames(frames, fe.cw, fe.sw, fe.fb, cfg.log_floor,
                             fe.plan)
    want = mel.log_mel_frames_plain(frames, fe.cw, fe.sw, fe.fb,
                                    cfg.log_floor)
    torch.cuda.synchronize()
    assert mel.log_mel_frames.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-3


def _trainer_case(name, dev):
    """(loss, initial parameters, args on a device) of one small update of
    a trainer: its own loss function, a seeded init and one batch (the
    frozen encoders' banks built on the card and copied to the CPU)."""
    import numpy as np

    from omnilingual_asr_torch.config import PipelineConfig, tiny_config
    from omnilingual_asr_torch.models import conformer, translation
    from omnilingual_asr_torch.models.xvector import xvector_init
    from omnilingual_asr_torch.train import summary_train as sm
    from omnilingual_asr_torch.train import text_translator_train as tt
    from omnilingual_asr_torch.train import translator_train as at
    from omnilingual_asr_torch.train import xvector_train as xv
    from omnilingual_asr_torch.train.step import RunLog
    from omnilingual_asr_torch.train.synth import LEXICON_SIZE

    gen = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    cfg = tiny_config()
    if name == "xvector":
        xcfg = PipelineConfig()
        wf = xv.window_frames(xcfg, 64000)
        batch = xv.BatchPool(xcfg, batch_size=8, win=64000, wf=wf,
                             seed=7).next_batch()
        return xv.loss_fn, xvector_init(gen, xcfg), lambda d: (
            mel.MelFrontend(xcfg.frontend, d), *xv.batch_tensors(batch, d),
            wf)
    if name == "text_translator":
        tables, english = tt._lang_tables()
        batch = tt.make_batch(rng, tables, english, LEXICON_SIZE, cfg.vocab,
                              16, noise=True,
                              g=tt._grammar_tables(tables, english))
        return tt.loss_fn, translation.text_translator_init(gen, cfg), \
            lambda d: (*tt.batch_tensors(batch, d), cfg)
    asr = conformer.asr_init(torch.Generator().manual_seed(3), cfg)
    if name == "translator":
        enc = at.UtteranceEncoder(cfg, asr, dev)
        bank, _ = at.build_bank(rng, enc, 8, RunLog())
        idx = torch.arange(8)
        return at.loss_fn, translation.translator_init(gen, cfg), \
            lambda d: (tuple(b.to(d) for b in bank), idx.to(d), cfg)
    enc = sm.WindowEncoder(cfg, asr, dev)
    pool = sm.build_utterance_pool(rng, 48)
    bank, _ = sm.build_bank(rng, enc, 4, pool, True, RunLog())
    return sm.loss_fn, translation.translator_init(gen, cfg, n_layers=2), \
        lambda d: (*(b.to(d) for b in bank), cfg)


@pytest.mark.parametrize("name", ["xvector", "text_translator",
                                  "translator", "summarizer"])
def test_trainer_update_on_card_equals_cpu(dev, name):
    """One update of each trainer (x-vector, text and audio translator,
    summarizer) on the card against the CPU from the same parameters and
    batch: chip_smoke's criterion, the gradients within 5e-2 relative L2
    per leaf and the loss within 1e-3 relative."""
    from omnilingual_asr_torch.train.step import (tree_leaves, trainable,
                                                  value_and_grads)

    loss, params, args_on = _trainer_case(name, dev)
    got = []
    for where in (dev, torch.device("cpu")):
        p = trainable(params, where)
        value, grads = value_and_grads(loss, p, *args_on(where))
        got.append((float(value), [
            torch.zeros(x.shape) if g is None else g.detach().cpu()
            for g, x in zip(grads, tree_leaves(p))]))
    (lc, gc), (lp, gp) = got
    assert abs(lc - lp) <= 1e-3 * abs(lp)
    for i, (a, b) in enumerate(zip(gc, gp)):
        assert float((a - b).norm()) <= 5e-2 * float(b.norm()) + 1e-12, i


def test_entry_points_default_to_the_card(dev):
    """Given no device, the compute entry points run on the card (the CPU
    tests check that they raise without one): the train, pretrain and
    pool steps' parameters, the log-mel frontend and its plan, the
    held-out evaluator and the trainers' frozen encoders."""
    from omnilingual_asr_torch.config import tiny_config
    from omnilingual_asr_torch.models.conformer import asr_init
    from omnilingual_asr_torch.train import (device_pool, pretrain, step,
                                             summary_train, synth_train,
                                             translator_train)

    cfg = tiny_config()
    params = asr_init(torch.Generator().manual_seed(0), cfg)
    placed = [
        step.tree_leaves(step.make_train_step(cfg)[0](0).params)[0],
        step.tree_leaves(pretrain.make_pretrain_step(cfg)[0](0)[0])[0],
        step.tree_leaves(
            device_pool.make_pool_train_step(cfg)[0](0).params)[0],
        mel.MelFrontend(cfg.frontend).cw,
        mel.mel_plan(*mel.build_mel_constants(cfg.frontend)).window]
    assert all(t.is_cuda for t in placed)
    assert synth_train.Evaluator(cfg, window_seconds=2.0).device.type == \
        "cuda"
    for enc in (translator_train.UtteranceEncoder(cfg, params),
                summary_train.WindowEncoder(cfg, params)):
        assert enc.device.type == "cuda"
        assert step.tree_leaves(enc.params)[0].is_cuda
