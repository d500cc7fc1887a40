"""PyTorch port: int8 serving (``ops/quant.py``) against the JAX package.

The JAX functions run as ``tests/test_quant.py`` runs them on the CPU: the
Pallas kernels in interpret mode, the dense layers' kernel routing through
``layers.set_quant_kernel(mode, interpret=True)``. Inputs are made with
numpy from fixed seeds and handed to both packages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.models import layers as jax_layers
from omnilingual_asr_tpu.ops import conv_module as jax_conv
from omnilingual_asr_tpu.ops import quant as jax_quant
from omnilingual_asr_torch.models import layers, zoo
from omnilingual_asr_torch.ops import conv_module, quant

torch.set_num_threads(2)


def _weight(rng, K, N):
    """Per-channel spread of magnitudes, one hot channel and one all-zero
    channel (its scale is the 1e-8 floor)."""
    w = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    w *= np.exp(rng.uniform(-1.0, 1.0, N)).astype(np.float32)
    w[:, 1] *= 100.0
    w[:, 2] = 0.0
    return w


def _activations(rng, M, K):
    """Activations with one outlier row (as test_a8_outliers_use_per_row_
    scale) and one all-zero row."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] *= 1000.0
    x[3] = 0.0
    return x


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
        return out
    return {prefix: np.asarray(tree)}


def _order_tol(x, w_q, scale):
    """Per-element bound on the difference of two f32 sums of the same
    exact products in another order: each is within K * 2^-24 * sum|terms|
    of the exact sum, so the two within twice that; then scaled per output
    channel (f64 on the host)."""
    K = x.shape[1]
    xb = np.abs(np.asarray(torch.from_numpy(x).to(torch.bfloat16).float()))
    mag = (xb.astype(np.float64) @ np.abs(w_q).astype(np.float64)) * scale
    return 2 * K * 2.0 ** -24 * mag + 1e-30


@pytest.mark.parametrize("shape", [(256, 512), (64, 96), (8, 3)])
def test_quantize_weight_equals_jax(shape):
    """int8 values bit for bit and scales exactly, including the hot and the
    all-zero channel."""
    rng = np.random.default_rng(shape[0] + shape[1])
    w = _weight(rng, *shape)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    tq, ts = quant.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_weight(tq, ts).numpy(),
        np.asarray(jax_quant.dequantize_weight(jq, js)))
    assert quant.quantization_error(torch.from_numpy(w)) == pytest.approx(
        jax_quant.quantization_error(jnp.asarray(w)), rel=1e-5)


def test_quantize_param_tree_equals_jax():
    """Same leaf set, int8 leaves bit-exact, scales and untouched leaves
    exact; bare arrays (spk_aam, dw) stay f32."""
    jcfg = jax_tiny_config()
    jp = jax_conformer.asr_init(jax.random.PRNGKey(0), jcfg)
    want = _flat(jax_quant.quantize_param_tree(jp))
    got = _flat(quant.quantize_param_tree(zoo.params_from_jax(jp)))
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=str(key))
    assert ("blocks", 0, "conv", "dw") in got
    assert ("spk_aam",) in got
    assert ("blocks", 0, "ffn1", "w1", "w_q") in got


def test_params_from_jax_keeps_integer_leaves():
    """A quantized JAX tree crosses over with its int8 leaves as int8, and
    tree_to moves them unchanged."""
    jp = jax_quant.quantize_param_tree(
        jax_conformer.asr_init(jax.random.PRNGKey(0), jax_tiny_config()))
    tp = zoo.params_from_jax(jp)
    leaf = tp["blocks"][0]["ffn1"]["w1"]
    assert leaf["w_q"].dtype == torch.int8
    assert leaf["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        leaf["w_q"].numpy(), np.asarray(jp["blocks"][0]["ffn1"]["w1"]["w_q"]))
    moved = zoo.tree_to(tp, "cpu")
    assert moved["blocks"][0]["ffn1"]["w1"]["w_q"].dtype == torch.int8
    flat = _flat(zoo.params_from_jax({"i": np.arange(3, dtype=np.int32),
                                      "f": np.ones(2, np.float16)}))
    assert flat[("i",)].dtype == np.int32 and flat[("f",)].dtype == np.float32


@pytest.mark.parametrize("M", [256, 3072])
@pytest.mark.parametrize("N", [512, 1024])
def test_k5_plain_equals_pallas_kernel(M, N):
    """W8A8: the integer sums are exact on both sides and the rest is the
    same sequence of f32 operations (absmax, * f32(1/127), IEEE division,
    round half to even, clip, then * sx * sw), so the plain version must
    equal the reference bit for bit; the outlier row keeps its own scale."""
    K = 256
    rng = np.random.default_rng(M + N)
    x, w = _activations(rng, M, K), _weight(rng, K, N)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant.quantized_matmul_a8(jnp.asarray(x), jq, js,
                                                    interpret=True))
    got = quant.quantized_matmul_a8(
        torch.from_numpy(x), torch.from_numpy(np.array(jq)),
        torch.from_numpy(np.array(js))).numpy()
    assert got.shape == (M, N) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert not got[3].any()                 # an all-zero row gives zeros
    # per-row scaling: the rows after the outlier stay close to f32
    ref = x[1:] @ w
    rel = np.abs(got[1:] - ref) / np.maximum(np.abs(ref), 1.0)
    assert rel.mean() < 0.02


@pytest.mark.parametrize("N", [512, 1024])
def test_k5_plain_equals_pallas_kernel_at_a_ragged_m(N):
    """W8A8 at M = 129, where the CUDA kernel's row tiles meet the M edge:
    the plain version against the reference's padded front end
    (dense_quant_matmul pads M to its 256-row block), bit for bit."""
    M, K = 129, 256
    rng = np.random.default_rng(M + 7 * N)
    x, w = _activations(rng, M, K), _weight(rng, K, N)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant.dense_quant_matmul(
        jnp.asarray(x), jq, js, mode="a8", interpret=True))
    got = quant.quantized_matmul_a8(
        torch.from_numpy(x), torch.from_numpy(np.array(jq)),
        torch.from_numpy(np.array(js))).numpy()
    assert got.shape == (M, N) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", [256, 3072])
@pytest.mark.parametrize("N", [512, 1024])
def test_k4_plain_matches_pallas_kernel(M, N):
    """W8A16: both sum the same exact bf16 x int8 products in f32, in
    another order; each element is held to the bound of that (see
    _order_tol)."""
    K = 256
    rng = np.random.default_rng(M * N)
    x, w = _activations(rng, M, K), _weight(rng, K, N)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant.quantized_matmul(jnp.asarray(x), jq, js,
                                                 interpret=True))
    got = quant.quantized_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(jq)),
        torch.from_numpy(np.array(js))).numpy()
    assert got.shape == (M, N) and np.isfinite(got).all()
    tol = _order_tol(x, np.asarray(jq), np.asarray(js))
    assert (np.abs(got - want) <= tol).all()
    assert not got[3].any()


def test_plain_bias_is_added_after_the_scale():
    """The kernels fold the bias into their epilogue as (...) + b, in the
    reference's order; the plain versions do the same."""
    rng = np.random.default_rng(5)
    x, w = _activations(rng, 40, 128), _weight(rng, 128, 256)
    b = rng.standard_normal(256).astype(np.float32)
    tq, ts = quant.quantize_weight(torch.from_numpy(w))
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    for fn in (quant.quantized_matmul, quant.quantized_matmul_a8):
        assert torch.equal(fn(xt, tq, ts, bt), fn(xt, tq, ts) + bt)


def test_dense_quant_matmul_restores_leading_shape_without_padding():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, 70, 128)).astype(np.float32))
    tq, ts = quant.quantize_weight(torch.from_numpy(_weight(rng, 128, 512)))
    for mode, fn in (("a8", quant.quantized_matmul_a8),
                     ("w8", quant.quantized_matmul)):
        got = quant.dense_quant_matmul(x, tq, ts, mode)
        assert got.shape == (3, 70, 512)
        assert torch.equal(got.reshape(-1, 512),
                           fn(x.reshape(-1, 128), tq, ts))
    with pytest.raises(ValueError):
        quant.dense_quant_matmul(x, tq, ts, "w4")


def test_kernel_layouts_are_added_where_the_kernels_take_the_shape():
    tree = quant.quantize_param_tree({
        "a": {"w": torch.randn(128, 512), "b": torch.zeros(512)},
        "b": {"w": torch.randn(128, 96)},
        "c": [{"w": torch.randn(256, 1024)}], "dw": torch.randn(4, 8)})
    out = quant.add_kernel_layouts(tree)
    assert torch.equal(out["a"]["w_t"], out["a"]["w_q"].t())
    assert out["a"]["w_t"].is_contiguous()
    assert "w_t" not in out["b"]
    assert out["c"][0]["w_t"].shape == (1024, 256)
    assert torch.equal(out["dw"], tree["dw"])
    assert quant.kernel_shapes_ok(256, 2048)
    assert not quant.kernel_shapes_ok(256, 256)
    assert not quant.kernel_shapes_ok(64, 512)


@pytest.mark.parametrize("mode", [None, "w8", "a8"])
@pytest.mark.parametrize("K,N", [(128, 512), (128, 96), (64, 512)])
def test_dense_apply_matches_jax(mode, K, N):
    """dense_apply on a quantized leaf in each mode, against the JAX
    dense_apply under set_quant_kernel(mode, interpret=True). (128, 512)
    takes the kernels; (128, 96) and (64, 512) fail kernel_shapes_ok and
    take the dequantization path (bf16(w_q) * bf16(scale), rounded once to
    bf16) in every mode. a8 must be bit-exact; the bf16 paths sum the same
    exact products in another order (_order_tol, over the dequantized
    weight), plus one f32 rounding of the bias add on each side."""
    rng = np.random.default_rng(K + N)
    p = {"w": _weight(rng, K, N), "b": rng.standard_normal(N).astype(
        np.float32)}
    x = rng.standard_normal((3, 70, K)).astype(np.float32)
    jp = jax_quant.quantize_param_tree({"d": {k: jnp.asarray(v)
                                              for k, v in p.items()}})["d"]
    jax_layers.set_quant_kernel(mode, interpret=True)
    try:
        want = np.asarray(jax_layers.dense_apply(jp, jnp.asarray(x)))
    finally:
        jax_layers.set_quant_kernel(None)
    tp = zoo.params_from_jax(jp)
    got = layers.dense_apply(tp, torch.from_numpy(x), quant=mode).numpy()
    assert got.shape == want.shape == (3, 70, N)
    kernel = mode is not None and quant.kernel_shapes_ok(K, N)
    if kernel and mode == "a8":
        np.testing.assert_array_equal(got, want)
        return
    x2 = x.reshape(-1, K)
    if kernel:
        tol = _order_tol(x2, np.asarray(jp["w_q"]), np.asarray(jp["w_scale"]))
    else:
        w = (tp["w_q"].float() * tp["w_scale"].to(torch.bfloat16).float()).to(
            torch.bfloat16).float().numpy()
        tol = _order_tol(x2, w, np.ones(N))
    want = want.reshape(-1, N)
    tol = tol + 2.0 ** -23 * np.abs(want)
    assert (np.abs(got.reshape(-1, N) - want) <= tol).all()


def test_dense_dequant_rounds_once_to_bf16():
    """quantize=True's weight is bf16(bf16(w_q) * bf16(w_scale)): the f32
    product of an int8 and a bf16 value is exact, so one rounding."""
    rng = np.random.default_rng(8)
    tq, ts = quant.quantize_weight(torch.from_numpy(_weight(rng, 32, 16)))
    x = torch.eye(32)
    got = layers.dense_apply({"w_q": tq, "w_scale": ts}, x)
    want = (tq.to(torch.bfloat16) * ts.to(torch.bfloat16)).float()
    assert torch.equal(got, want)


@pytest.mark.parametrize("D,valid", [(64, [96, 50, 0]), (128, [17, 96, 96])])
def test_fused_conv_module_with_quantized_pointwise_weights(D, valid):
    """convmod_apply_fused on a quantized conv leaf: pw1/pw2 are f32(w_q) *
    w_scale in f32 (the reference's _dense_weight) and the module rounds
    them to bf16, against the JAX convmod_apply_fused (Pallas K3 in
    interpret mode). Tolerance as test_torch_conv_module's (2e-2 abs and
    rel: bf16 roundings of f32 values computed in another order)."""
    B, T, K = len(valid), 96, 32
    rng = np.random.default_rng(D)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    p = {"ln": {"scale": 1 + f(D, scale=0.1), "bias": f(D, scale=0.1)},
         "pw1": {"w": f(D, 2 * D, scale=D ** -0.5)},
         "dw": f(K, D, scale=K ** -0.5),
         "dw_ln": {"scale": 1 + f(D, scale=0.1), "bias": f(D, scale=0.1)},
         "pw2": {"w": f(D, D, scale=D ** -0.5)}}
    x = f(B, T, D)
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    jp = jax_quant.quantize_param_tree(jax.tree.map(jnp.asarray, p))
    want = np.asarray(jax_conv.convmod_apply_fused(
        jp, jnp.asarray(x), jnp.asarray(mask), interpret=True))
    tp = zoo.params_from_jax(jp)
    got = conv_module.convmod_apply_fused(tp, torch.from_numpy(x),
                                          torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.median(np.abs(got - want)) < 1e-4
    # the f32 dequantized weight, not the dense layers' bf16 product
    np.testing.assert_array_equal(
        conv_module.dense_weight(tp["pw1"]).numpy(),
        np.asarray(jax_conv._dense_weight(jp["pw1"])))
