"""PyTorch port: the differentiable kernel entry points on the CPU.

``FlashAttention`` (K2 forward, K6/K7 backward) and ``FusedConvModule`` (K3
forward, autograd of the plain version backward) run their plain versions
here; their gradients are held against ``jax.grad`` through the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs. Every
kernel wrapper is also shown to pass gradients through its plain path for a
CPU tensor that requires them (K4 and K5 refuse on the card instead).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.ops import attention as jax_attention
from omnilingual_asr_tpu.ops import conv_module as jax_conv
from omnilingual_asr_torch.config import FrontendConfig
from omnilingual_asr_torch.ops import attention, conv_module, mel, quant

torch.set_num_threads(2)

B, T, H = 2, 256, 2
MASKS = {"full": [T, T], "ragged": [T, 100], "masked_slot": [T, 0]}


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(D, valid, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
               for _ in range(3))
    if dtype == "bf16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    proj = rng.standard_normal((B, T, H, D)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, proj, mask


def _jax_grads(q, k, v, proj, mask, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def loss(q, k, v):
        out = jax_attention.flash_attention(q, k, v, jnp.asarray(mask),
                                            interpret=True)
        return jnp.sum(out.astype(jnp.float32) * proj)

    args = [jnp.asarray(a, jd) for a in (q, k, v)]
    return [np.asarray(g.astype(jnp.float32))
            for g in jax.grad(loss, (0, 1, 2))(*args)]


def _port_grads(q, k, v, proj, mask, dtype):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    leaves = [torch.from_numpy(a).to(td).requires_grad_(True)
              for a in (q, k, v)]
    out = attention.FlashAttention.apply(*leaves, torch.from_numpy(mask))
    assert out.dtype == td
    (out.float() * torch.from_numpy(proj)).sum().backward()
    for leaf in leaves:
        assert leaf.grad.dtype == td
    return [leaf.grad.float().numpy() for leaf in leaves]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(MASKS))
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_grads_match_jax(D, case, dtype):
    """dq, dk, dv of ``FlashAttention`` (plain backward, recomputed from the
    forward's lse) against ``jax.grad`` through the Pallas forward and
    backward kernels in interpret mode.

    Tolerance: in f32, ``test_attention.py``'s own atol 3e-4 / rtol 1e-3
    (f32 sums in another order). In bf16 both round an f32 gradient to bf16,
    so an element may land one bf16 ulp away (<= 2^-7 |g|), plus
    2^-10 max|g| for the f32 sums' order where the element is near zero.
    Masked keys get exactly 0 in dk and dv, a fully-masked slot exactly 0
    everywhere."""
    q, k, v, proj, mask = _case(D, MASKS[case], dtype, seed=D + len(case))
    want = _jax_grads(q, k, v, proj, mask, dtype)
    got = _port_grads(q, k, v, proj, mask, dtype)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert np.isfinite(g).all(), name
        if dtype == "f32":
            np.testing.assert_allclose(g, w, atol=3e-4, rtol=1e-3,
                                       err_msg=name)
        else:
            tol = 2.0 ** -10 * np.abs(w).max() + 2.0 ** -7 * np.abs(w)
            assert (np.abs(g - w) <= tol).all(), name
    dead_key = ~mask
    for g in got[1:]:
        assert (g[dead_key] == 0).all()
    dead_row = ~mask.any(axis=1)
    for g in got:
        assert (g[dead_row] == 0).all()


def _share(got, want):
    """Largest share of the card's backward tolerance, 2^-10 max|g| +
    2^-7 |g| (chip_smoke.py's TOL_BWD_ABS/REL), that any element uses."""
    got, want = got.float().numpy(), np.asarray(want)
    tol = 2.0 ** -10 * np.abs(want).max() + 2.0 ** -7 * np.abs(want)
    return float((np.abs(got - want) / tol).max())


@pytest.mark.parametrize("case", sorted(MASKS))
@pytest.mark.parametrize("D", [64, 128])
def test_k6_k7_bf16_emulation_within_kernel_tolerance(D, case):
    """Kernels K6 and K7 round P and dS to bf16 for their tensor-core
    products (dV = P^T dO; dQ = dS K, dK = dS^T Q); the reference keeps
    them in f32. The kernels' arithmetic, emulated on the CPU
    (``flash_attention_bwd_emulated``), against the JAX Pallas backward
    (``_flash_bh_bwd``) in interpret mode, from the same q, k, v, dO, o and
    lse, at the card's tolerance. With both split as hi + lo bf16 halves
    (``KERNEL_BWD_SPLIT``, the kernels' choice) every gradient passes.
    With P as one bf16 value dV misses in every case (its terms are all
    positive, so the rounding does not average out against the 2^-10
    max|dV| floor); with dS as one bf16 value dQ or dK misses where rows
    are ragged (fewer, larger p), which is why both take the second
    product. Masked keys and a fully masked slot stay exactly 0."""
    q, k, v, do, mask = _case(D, MASKS[case], "bf16", seed=D + len(case))
    shape = q.shape
    to = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    qb, kb, vb, dob = (jax_attention._to_bh(to(a), *shape)
                       for a in (q, k, v, do))
    maskb = jnp.repeat(jnp.asarray(mask, jnp.int32), H, axis=0)[:, None, :]
    o, lse = jax_attention._fwd_lse(qb, kb, vb, maskb, 1.0 / np.sqrt(D),
                                    True)
    want = [np.asarray(jax_attention._from_bh(g, *shape).astype(jnp.float32))
            for g in jax_attention._flash_bh_bwd(
                True, (qb, kb, vb, maskb, o, lse), dob)[:3]]
    tt = lambda a: torch.from_numpy(np.array(a, np.float32)).to(  # noqa: E731
        torch.bfloat16)
    o_t = tt(jax_attention._from_bh(o, *shape).astype(jnp.float32))
    args = (tt(q), tt(k), tt(v), torch.from_numpy(mask), tt(do),
            torch.from_numpy(np.array(lse)).reshape(B, H, T))
    delta = attention.flash_delta(o_t, args[4])

    def shares(split):
        got = attention.flash_attention_bwd_emulated(*args, delta,
                                                     split=split)
        return dict(zip(("dq", "dk", "dv"),
                        (_share(g, w) for g, w in zip(got, want)))), got

    chosen, got = shares(attention.KERNEL_BWD_SPLIT)
    assert attention.KERNEL_BWD_SPLIT == ("p", "ds")
    assert max(chosen.values()) <= 1.0, chosen
    assert (got[1][~mask] == 0).all() and (got[2][~mask] == 0).all()
    assert (got[0][~mask.any(axis=1)] == 0).all()
    p_hi, _ = shares(("ds",))
    assert p_hi["dv"] > 1.0, p_hi
    if case == "ragged":
        ds_hi, _ = shares(("p",))
        assert max(ds_hi["dq"], ds_hi["dk"]) > 1.0, ds_hi


def test_flash_backward_pieces_compose():
    """The two halves (K6's and K7's plain versions) with ``flash_delta``
    equal ``flash_attention_bwd_plain``, and the whole equals autograd
    through the plain forward on the rows that have a valid key."""
    q, k, v, proj, mask = _case(64, MASKS["ragged"], "f32", seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, proj))
    tm = torch.from_numpy(mask)
    o, lse = attention.flash_attention_plain(tq, tk, tv, tm)
    dq, dk, dv = attention.flash_attention_bwd_plain(tq, tk, tv, tm, o, lse,
                                                     tdo)
    delta = attention.flash_delta(o, tdo)
    assert torch.equal(dq, attention.flash_attention_bwd_dq(
        tq, tk, tv, tm, tdo, lse, delta))
    dk2, dv2 = attention.flash_attention_bwd_dkv(tq, tk, tv, tm, tdo, lse,
                                                 delta)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out, _ = attention.flash_attention_plain(*leaves, tm)
    (out * tdo).sum().backward()
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad, atol=1e-5, rtol=1e-4)


def _conv_inputs(seed=0, B_=2, T_=64, D=128, K=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, T_, D)).astype(np.float32)
    mask = np.ones((B_, T_), bool)
    mask[0, 50:] = False
    w = [np.ones(D, np.float32) + 0.1 * rng.standard_normal(D).astype(
             np.float32),
         0.1 * rng.standard_normal(D).astype(np.float32),
         (rng.standard_normal((D, 2 * D)) * 0.05).astype(np.float32),
         (rng.standard_normal((K, D)) * 0.2).astype(np.float32),
         np.ones(D, np.float32), np.zeros(D, np.float32),
         (rng.standard_normal((D, D)) * 0.05).astype(np.float32)]
    proj = rng.standard_normal((B_, T_, D)).astype(np.float32)
    return x, mask, w, proj


def test_fused_conv_module_grads_match_jax():
    """``FusedConvModule`` (plain forward on the CPU, autograd of the plain
    version backward) against ``jax.grad`` through ``fused_conv_module``
    (Pallas forward in interpret mode, VJP of ``_conv_module_ref``), for x
    and every weight. Tolerance: max |g - g_jax| <= 2^-7 max |g_jax| per
    leaf: the pointwise-weight gradients are rounded to bf16 where each
    package casts its weights (one ulp, 2^-8 relative, apart where f32 sums
    in another order straddle a rounding boundary), and those flow into the
    input gradients. The mask gets no gradient."""
    x, mask, w, proj = _conv_inputs()

    def loss(x, *ws):
        out = jax_conv.fused_conv_module(x, jnp.asarray(mask), *ws,
                                         interpret=True)
        return jnp.sum(out * proj)

    want = jax.grad(loss, tuple(range(8)))(jnp.asarray(x),
                                           *map(jnp.asarray, w))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x, *w]]
    out = conv_module.FusedConvModule.apply(leaves[0],
                                            torch.from_numpy(mask),
                                            *leaves[1:])
    (out * torch.from_numpy(proj)).sum().backward()
    for leaf, g in zip(leaves, want):
        g = np.asarray(g)
        err = np.abs(leaf.grad.numpy() - g).max()
        assert err <= 2.0 ** -7 * np.abs(g).max(), err


def test_wrappers_pass_grads_through_their_plain_path():
    """A CPU tensor that requires grad goes through each wrapper's plain
    version, which autograd differentiates: the gradients exist, are finite
    and equal those of the plain version called directly."""
    rng = np.random.default_rng(1)

    def check(wrapper, plain, *arrays, n_grad=1, extra=()):
        def run(fn):
            leaves = [torch.from_numpy(a).requires_grad_(i < n_grad)
                      for i, a in enumerate(arrays)]
            out = fn(*leaves, *extra)
            out = out[0] if isinstance(out, tuple) else out
            out.float().sum().backward()
            return [leaf.grad for leaf in leaves[:n_grad]]

        for g, h in zip(run(wrapper), run(plain)):
            assert g is not None and torch.isfinite(g).all()
            assert torch.equal(g, h)

    cfg = FrontendConfig()
    fe = mel.MelFrontend(cfg, "cpu")
    frames = (0.1 * rng.standard_normal((8, cfg.n_fft))).astype(np.float32)
    check(mel.log_mel_frames, mel.log_mel_frames_plain, frames,
          extra=(fe.cw, fe.sw, fe.fb, cfg.log_floor))
    q, k, v, _, m = _case(64, [T, 7], "f32", seed=5)
    check(attention.flash_attention, attention.flash_attention_plain,
          q, k, v, n_grad=3, extra=(torch.from_numpy(m),))
    x, cmask, w, _ = _conv_inputs(seed=2)
    check(lambda x, *ws: conv_module.fused_conv_module(
              x, torch.from_numpy(cmask), *ws),
          lambda x, *ws: conv_module.conv_module_plain(
              x, torch.from_numpy(cmask), *ws), x, *w, n_grad=8)
    xq = rng.standard_normal((4, 256)).astype(np.float32)
    w_q, scale = quant.quantize_weight(torch.from_numpy(
        rng.standard_normal((256, 128)).astype(np.float32)))
    check(quant.quantized_matmul, quant.quantized_matmul_plain, xq,
          extra=(w_q, scale))
    check(quant.quantized_matmul_a8, quant.quantized_matmul_a8_plain, xq,
          extra=(w_q, scale))


def test_int8_kernels_refuse_gradients():
    """K4 and K5 have no backward: for a tensor that requires grad their
    guard raises (the wrappers call it before a launch) rather than return
    an output with no graph; without grad mode, or without such a tensor,
    it lets the call through."""
    x = torch.zeros(4, 128, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        quant.refuse_grad("W8A8 matmul", x, None)
    with torch.no_grad():
        quant.refuse_grad("W8A8 matmul", x, None)
    with torch.inference_mode():
        quant.refuse_grad("W8A16 matmul", torch.zeros(4, 128), None)
    quant.refuse_grad("W8A16 matmul", x.detach(), None)
