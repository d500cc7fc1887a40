"""PyTorch port: kernel K2's plain version (flash-attention forward) against
the JAX package's Pallas flash kernel in interpret mode."""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.ops import attention as jax_attention
from omnilingual_asr_torch.ops import attention

torch.set_num_threads(2)

B, T, H, D = 3, 512, 2, 64


def _inputs(valid, seed=0):
    """bf16-valued q, k, v [B, T, H, D] (made with numpy) and a key mask
    with ``valid[b]`` leading valid frames per row."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    q, k, v = (bf16(rng.standard_normal((B, T, H, D)).astype(np.float32))
               for _ in range(3))
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, mask


def _jax_flash(q, k, v, mask):
    """JAX flash forward: (o [B, T, H, D] bf16 -> f32, lse [B, H, T])."""
    to = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    qb, kb, vb = (jax_attention._to_bh(to(a), B, T, H, D) for a in (q, k, v))
    maskb = jnp.repeat(jnp.asarray(mask, jnp.int32), H, axis=0)[:, None, :]
    o, lse = jax_attention._fwd_lse(qb, kb, vb, maskb, 1.0 / math.sqrt(D),
                                    True)
    o = jax_attention._from_bh(o, B, T, H, D)
    # the public entry point returns the same output
    o_pub = jax_attention.flash_attention(to(q), to(k), to(v),
                                          jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(np.asarray(o_pub, np.float32),
                                  np.asarray(o, np.float32))
    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(lse).reshape(B, H, T))


@pytest.mark.parametrize("case,valid", [
    # a ragged partial key mask in every row
    ("partial", [T, 300, 77]),
    # a fully-masked batch row (a padded slot, n_valid = 0)
    ("masked_row", [T, 0, 400]),
    # whole masked key blocks: 200 < 256 leaves the second JAX key block
    # (and three of the port's 64-key tiles) fully masked
    ("masked_block", [200, 256, 1]),
])
def test_k2_plain_matches_pallas_kernel(case, valid):
    """Output and logsumexp. Tolerance: outputs are rounded to bf16 by both,
    from f32 sums taken in another order (per 256-key block online softmax
    vs one pass), so they can differ by one bf16 ulp: 2^-8 relative, at
    |o| <= ~2 that is 8e-3 abs. lse: 1e-5 abs + 1e-6 rel (f32 log-sum-exp
    over <= 512 terms). Fully-masked rows: o exactly 0, lse exactly 1e30."""
    q, k, v, mask = _inputs(valid, seed=len(case))
    want_o, want_lse = _jax_flash(q, k, v, mask)
    to = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got_o, got_lse = attention.flash_attention(to(q), to(k), to(v),
                                               torch.from_numpy(mask))
    assert got_o.dtype == torch.bfloat16
    assert tuple(got_lse.shape) == (B, H, T)
    got_o, got_lse = got_o.float().numpy(), got_lse.numpy()
    np.testing.assert_allclose(got_o, want_o, atol=8e-3, rtol=8e-3)
    live = want_lse < 1e29
    np.testing.assert_allclose(got_lse[live], want_lse[live], atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_array_equal(got_lse[~live], want_lse[~live])
    dead = ~mask.any(axis=1)
    assert (got_o[dead] == 0).all() and (want_o[dead] == 0).all()


def test_k2_plain_flash_differs_from_softmax_path_on_masked_rows():
    """The flash path gives a fully-masked row zeros; the plain softmax path
    (models.layers.mhsa_apply without flash) gives it a uniform softmax.
    The engine follows the reference's choice of path."""
    q, k, v, mask = _inputs([T, 0, 10])
    o, lse = attention.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask))
    assert (o[1] == 0).all()
    assert (lse[1] == 1e30).all()


# Kernel K2's tolerances against its plain version on the card
# (chip_smoke.py TOL_K2_*): o per element within ABS + REL |o_ref|, lse
# within LSE on live rows.
K2_TOL_REL = 2.0 ** -7
K2_TOL_ABS = 1e-4
K2_TOL_LSE = 1e-3


@pytest.mark.parametrize("d,valid", [(64, [T, 300, 0]), (128, [T, 77, 1])])
def test_k2_bf16_p_emulation_within_kernel_tolerance(d, valid):
    """Kernel K2 rounds P to bf16 for its tensor-core P V product; the
    reference takes P V in f32. The kernel's arithmetic, emulated on the
    CPU (``flash_attention_emulated``), against the JAX flash kernel in
    interpret mode on seeded inputs at head dims 64 and 128: with P split
    as hi + lo bf16 halves (the kernel's choice) o and lse stay within K2's
    card tolerances; with P as one bf16 value o does not (its error is
    2^-9 of p, summed over the keys, against a 1e-4 floor where o is near
    0), which is why the kernel runs the second product."""
    rng = np.random.default_rng(d)
    shape = (B, T, 2, d)

    def bf16(a):
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    q, k, v = (bf16(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    to = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    qb, kb, vb = (jax_attention._to_bh(to(a), *shape) for a in (q, k, v))
    maskb = jnp.repeat(jnp.asarray(mask, jnp.int32), 2, axis=0)[:, None, :]
    want_o, want_lse = jax_attention._fwd_lse(qb, kb, vb, maskb,
                                              1.0 / math.sqrt(d), True)
    want_o = np.asarray(jax_attention._from_bh(want_o, *shape).astype(
        jnp.float32))
    want_lse = np.asarray(want_lse).reshape(B, 2, T)
    tt = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    share = {}
    for split in (True, False):
        o, lse = attention.flash_attention_emulated(
            tt(q), tt(k), tt(v), torch.from_numpy(mask), split_p=split)
        o, lse = o.float().numpy(), lse.numpy()
        share[split] = float((np.abs(o - want_o) / (
            K2_TOL_ABS + K2_TOL_REL * np.abs(want_o))).max())
        live = want_lse < 1e29
        assert np.abs(lse - want_lse)[live].max() <= K2_TOL_LSE
        np.testing.assert_array_equal(lse[~live], want_lse[~live])
        assert (o[~mask.any(axis=1)] == 0).all()
    assert share[True] <= 1.0, share
    assert share[False] > 1.0, share
