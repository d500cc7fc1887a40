"""PyTorch port: each CUDA kernel against its plain PyTorch version on the
card. These need an NVIDIA GPU (sm_90a) and the CUDA toolkit; without a card
they skip. On the card run ``python -m pytest tests/test_torch_cuda.py``.

Tolerances are chip_smoke.py's, with the same reasons.
"""

from __future__ import annotations

import pytest
import torch

from omnilingual_asr_torch.config import FrontendConfig
from omnilingual_asr_torch.ops import attention, conv_module, mel

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
