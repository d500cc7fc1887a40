"""PyTorch port: kernel K3's plain version (the fused conformer conv
module) against the JAX package's Pallas kernel in interpret mode."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.ops import conv_module as jax_conv
from omnilingual_asr_torch.ops import conv_module

torch.set_num_threads(2)


def _params(D, K, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    return {
        "ln_scale": 1.0 + f(D, scale=0.1), "ln_bias": f(D, scale=0.1),
        "pw1": f(D, 2 * D, scale=1 / np.sqrt(D)),
        "dw": f(K, D, scale=1 / np.sqrt(K)),
        "dwln_scale": 1.0 + f(D, scale=0.1), "dwln_bias": f(D, scale=0.1),
        "pw2": f(D, D, scale=1 / np.sqrt(D)),
    }


ORDER = ("ln_scale", "ln_bias", "pw1", "dw", "dwln_scale", "dwln_bias",
         "pw2")


@pytest.mark.parametrize("B,T,D,valid", [
    (3, 96, 64, [96, 50, 0]),        # ragged rows and a padded slot
    (2, 128, 128, [17, 128]),
])
def test_k3_plain_matches_pallas_kernel(B, T, D, valid):
    """K = 32 taps, SAME padding (left 15, right 16), ragged mask.

    Tolerance 2e-2 abs, 2e-2 rel: both round the LN output and the SiLU
    output to bf16 before the pointwise products, but from f32 values
    computed in another order (LN reductions, the depthwise sum), so an
    input near a bf16 rounding boundary can land one ulp (2^-8 relative)
    apart, which moves a pointwise sum by a few 1e-3; the residual input
    is carried exactly."""
    K = 32
    rng = np.random.default_rng(B * 1000 + D)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    p = _params(D, K, seed=D)
    want = np.asarray(jax_conv._fused_conv_fwd_kernel_call(
        jnp.asarray(x), jnp.asarray(mask),
        *(jnp.asarray(p[k]) for k in ORDER), interpret=True))
    got = conv_module.fused_conv_module(
        torch.from_numpy(x), torch.from_numpy(mask),
        *(torch.from_numpy(p[k]) for k in ORDER)).numpy()
    assert got.shape == want.shape == (B, T, D)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    # the median element agrees far more tightly than the bound
    assert np.median(np.abs(got - want)) < 1e-4


@pytest.mark.parametrize("K", [31, 32])
def test_k3_plain_matches_pallas_kernel_at_edges(K):
    """T = 97, not a multiple of the CUDA kernel's 64- or 96-frame tiles,
    with rows whole, ragged, one valid frame and a padded slot, at an odd
    (31: SAME pads 15 | 15) and an even (32: 15 | 16) tap count: the card
    holds the kernel against this plain version at these shapes.
    Tolerance as test_k3_plain_matches_pallas_kernel."""
    B, T, D = 4, 97, 64
    rng = np.random.default_rng(K)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray([97, 64, 1, 0])[:, None]
    p = _params(D, K, seed=K + 1)
    want = np.asarray(jax_conv._fused_conv_fwd_kernel_call(
        jnp.asarray(x), jnp.asarray(mask),
        *(jnp.asarray(p[k]) for k in ORDER), interpret=True))
    got = conv_module.fused_conv_module(
        torch.from_numpy(x), torch.from_numpy(mask),
        *(torch.from_numpy(p[k]) for k in ORDER)).numpy()
    assert got.shape == want.shape == (B, T, D)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.median(np.abs(got - want)) < 1e-4


def test_k3_plain_is_twin_of_reference_math():
    """conv_module_plain against the JAX package's own plain twin
    (_conv_module_ref) on the same inputs; same tolerance as above."""
    B, T, D, K = 2, 64, 64, 32
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray([64, 40])[:, None]
    p = _params(D, K, seed=9)
    want = np.asarray(jax_conv._conv_module_ref(
        jnp.asarray(x), jnp.asarray(mask),
        *(jnp.asarray(p[k]) for k in ORDER)))
    got = conv_module.conv_module_plain(
        torch.from_numpy(x), torch.from_numpy(mask),
        *(torch.from_numpy(p[k]) for k in ORDER)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_k3_plain_takes_bf16_pointwise_weights():
    """The engine holds pw1/pw2 in bf16 when the fused path is on; both
    versions round them to bf16 anyway, so the result is bit-identical to
    passing them in f32."""
    B, T, D, K = 2, 48, 64, 32
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    mask = torch.arange(T)[None, :] < torch.tensor([48, 20])[:, None]
    p = {k: torch.from_numpy(v) for k, v in _params(D, K, seed=5).items()}
    want = conv_module.fused_conv_module(x, mask, *(p[k] for k in ORDER))
    p["pw1"] = p["pw1"].to(torch.bfloat16)
    p["pw2"] = p["pw2"].to(torch.bfloat16)
    got = conv_module.fused_conv_module(x, mask, *(p[k] for k in ORDER))
    assert torch.equal(got, want)
