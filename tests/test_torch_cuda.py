"""PyTorch port: each CUDA kernel against its plain PyTorch version on the
card. These need an NVIDIA GPU (sm_90a) and the CUDA toolkit; without a card
they skip. On the card run ``python -m pytest tests/test_torch_cuda.py``.

Tolerances are chip_smoke.py's, with the same reasons.
"""

from __future__ import annotations

import pytest
import torch

from omnilingual_asr_torch.config import FrontendConfig
from omnilingual_asr_torch.ops import attention, conv_module, mel, quant

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
    got = mel.log_mel_frames(frames, fe.cw, fe.sw, fe.fb, cfg.log_floor)
    want = mel.log_mel_frames_plain(frames, fe.cw, fe.sw, fe.fb,
                                    cfg.log_floor)
    torch.cuda.synchronize()
    assert mel.log_mel_frames.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("T,valid", [(768, [768, 700, 300, 0]),
                                     (100, [100, 37, 1, 64])])
def test_flash_kernel_matches_plain(dev, T, valid):
    B, H, D = len(valid), 4, 64
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


@pytest.mark.parametrize("T,valid", [(768, [768, 700, 301, 0]),
                                     (50, [50, 13])])
def test_conv_module_kernel_matches_plain(dev, T, valid):
    B, D, K = len(valid), 256, 32
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
    got = conv_module.fused_conv_module(*args)
    want = conv_module.conv_module_plain(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 5e-2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q, torch.ones(1, 64, dtype=torch.bool,
                                                      device=dev))
    q = torch.zeros(1, 64, 2, 64, dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        attention.flash_attention(q, q, q, torch.ones(1, 64, dtype=torch.bool,
                                                      device=dev))


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
                                   (1, 384, 256)])
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
                                   (3072, 256, 2048), (70, 128, 128),
                                   (1, 384, 256)])
def test_q_matmul_kernel_matches_plain(dev, M, K, N):
    """K4: the same exact bf16 x int8 products summed in f32 in another
    order; each element within 2 K 2^-24 sum|terms| * scale (+ one rounding
    of the bias add)."""
    x, w_q, scale, bias = _quant_inputs(dev, M, K, N, M * N)
    xb = x.to(torch.bfloat16).float().abs()
    tol = (2 * K * 2.0 ** -24 * (xb.double() @ w_q.double().abs())
           * scale.double()).float()
    for b in (None, bias):
        before = quant.quantized_matmul.launches
        got = quant.quantized_matmul(x, w_q, scale, b)
        want = quant.quantized_matmul_plain(x, w_q, scale, b)
        torch.cuda.synchronize()
        assert quant.quantized_matmul.launches == before + 1
        extra = 0.0 if b is None else 2.0 ** -23 * want.abs()
        assert bool(((got - want).abs() <= tol + extra).all())


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
