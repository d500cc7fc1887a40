"""PyTorch port: the f32 encoder (``EncoderConfig.dtype == "float32"``)
against the JAX package on the CPU.

The JAX kernels K2, K6 and K7 are generic in their input type: at f32 they
compute every product in exact f32. The port sends f32 operands to its f32
kernels on a card and to the same plain versions as bf16 on the CPU, so
these tests hold the plain versions and the f32 model around them to the
JAX package's f32 functions (its Pallas kernels in interpret mode), and
the CPU models of the f32 K2's and of the f32 K6 and K7's 3xTF32 products
to both. Inputs
are drawn from seeds with numpy; each test states its tolerance. The
kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 4m).
"""

from __future__ import annotations

import dataclasses
import wave

import jax
import numpy as np
import pytest
import torch

import torch_dtype_cases as cases
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_torch.config import MeshConfig, tiny_config
from omnilingual_asr_torch.models import conformer, zoo
from omnilingual_asr_torch.ops import attention
from omnilingual_asr_torch.ops.card_cases import TOL_F32_FLASH, TOL_F32_LSE
from omnilingual_asr_torch.parallel.mesh import build_mesh
from omnilingual_asr_torch.parallel.sequence import sp_conformer_forward
from omnilingual_asr_torch.train import step

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: f32 attention against the JAX kernels at f32: both take exact f32
#: products and an f32 softmax, in another order (the JAX kernel sums keys
#: in blocks of 256, the plain version in one pass), so elements differ by
#: a few f32 ulps of the largest term (measured 1.6e-7 to 5.2e-7 in a dozen
#: runs; one early run, not reproduced since, read 3.3e-5 on the output).
#: A dropped key or a bf16 rounding anywhere moves them by 1e-3 or more, so
#: 1e-4 of each output's largest magnitude still tells them apart.
REL_FLASH = 1e-4
#: The whole f32 model against JAX's f32 model, max abs error over each
#: output's largest magnitude. With the plain paths every product is f32 in
#: both (measured 6e-7 to 1.0e-6 over two blocks: summation order); a bf16
#: rounding left in a dense layer would show as ~1e-3. With the kernel
#: flags, K3 computes its products in bf16 at either dtype (the reference's
#: rule), so an f32 difference upstream can flip single bf16 roundings
#: there, each a 2^-8 relative step of one term (measured 6.8e-4 to
#: 8.4e-4).
REL_F32_MODEL = 1e-4
REL_K3_MODEL = 5e-3
#: Gradients of the f32 kernel-mode forward: the attention path is exact
#: f32 in both, K3's products bf16 in both, so only K3's rounding flips
#: move a leaf (worst leaf measured 2.2e-3 relative L2; the bf16
#: kernel-mode test of tests/test_torch_train.py allows 5e-2).
GRAD_REL = 2e-2


_flash_inputs = cases.flash_inputs
_rel = cases.rel
_JAX_FLASH = {}


def _jax_flash_f32(D):
    """Inputs at [2, 256, 2, D] with a ragged row (the JAX kernel takes T
    in whole 256-key blocks), and JAX's ``flash_attention`` at f32 on them
    (Pallas, interpret mode) with its custom VJP: (inputs, o, (dq, dk,
    dv)), computed once a head dim for the tests that share them."""
    if D not in _JAX_FLASH:
        q, k, v, do, mask = _flash_inputs(2, 256, 2, D, [256, 100], seed=D)
        _JAX_FLASH[D] = ((q, k, v, do, mask),
                         *cases.jax_flash(q, k, v, mask, do))
    return _JAX_FLASH[D]


@pytest.mark.parametrize("D", [64, 128])
def test_flash_f32_forward_and_grads_match_jax(D):
    """``FlashAttention`` at f32 (the plain versions of K2, K6, K7 on the
    CPU) against JAX's ``flash_attention`` at f32 (Pallas, interpret mode)
    and its custom VJP, at [2, 256, 2, D] with a ragged row: the output
    and dq, dk, dv within REL_FLASH, in f32, masked keys' dk and dv
    exactly 0."""
    (q, k, v, do, mask), want_o, want_g = _jax_flash_f32(D)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = attention.FlashAttention.apply(qt, kt, vt, torch.from_numpy(mask))
    assert o.dtype == torch.float32
    o.backward(torch.from_numpy(do))
    assert _rel(o.detach().numpy(), want_o) <= REL_FLASH
    for t, w in zip((qt, kt, vt), want_g):
        assert t.grad.dtype == torch.float32
        assert _rel(t.grad.numpy(), w) <= REL_FLASH
    masked = ~torch.from_numpy(mask)
    assert (kt.grad[masked] == 0).all() and (vt.grad[masked] == 0).all()


def _tf32_case(D):
    """A small ragged case at f32 ([3, 200, 2, D]: a partial last tile of
    the kernels' 64-row blocks, a partly masked row and a fully masked
    slot): (args of the backward, the plain versions' (dq, dk, dv))."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _flash_inputs(
        3, 200, 2, D, [200, 130, 0], seed=D + 7))
    o, lse = attention.flash_attention_plain(q, k, v, mask)
    args = (q, k, v, mask, do, lse, attention.flash_delta(o, do))
    return args, (attention.flash_attention_bwd_dq_plain(*args),
                  *attention.flash_attention_bwd_dkv_plain(*args))


def _rel_t(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("D", [64, 128])
def test_tf32_model_of_the_f32_backward(D):
    """``flash_attention_bwd_tf32_emulated``, the f32 K6 and K7's 3xTF32
    rounding on the CPU, on a small ragged case: within
    ``card_cases.TOL_F32_FLASH`` of the exact-f32 plain versions (measured
    1.0e-6 to 1.3e-6), in f32; masked keys' dK and dV and the fully masked
    row's dQ exactly 0. The planted fault, one TF32 product (the hi lo
    terms dropped), misses that gate by far (measured 6e-4 to 1e-3)."""
    args, want = _tf32_case(D)
    got = attention.flash_attention_bwd_tf32_emulated(*args)
    mask = args[3]
    assert all(g.dtype == torch.float32 for g in got)
    assert max(_rel_t(g, w) for g, w in zip(got, want)) <= TOL_F32_FLASH
    dq, dk, dv = got
    assert (dq[~mask.any(dim=1)] == 0).all()
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()
    fault = attention.flash_attention_bwd_tf32_emulated(*args, terms=1)
    assert min(_rel_t(g, w) for g, w in zip(fault, want)) > TOL_F32_FLASH


@pytest.mark.parametrize("D", [64, 128])
def test_tf32_model_matches_jax(D):
    """The 3xTF32 model against JAX's f32 gradients (Pallas, interpret
    mode; the inputs of ``test_flash_f32_forward_and_grads_match_jax``):
    dq, dk, dv within REL_FLASH."""
    (q, k, v, do, mask), want_o, want_g = _jax_flash_f32(D)
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    _, lse = attention.flash_attention_plain(qt, kt, vt, mt)
    delta = attention.flash_delta(torch.from_numpy(want_o), dot)
    got = attention.flash_attention_bwd_tf32_emulated(qt, kt, vt, mt, dot,
                                                      lse, delta)
    for g, w in zip(got, want_g):
        assert _rel(g.numpy(), w) <= REL_FLASH


@pytest.mark.parametrize("D", [64, 128])
def test_tf32_model_of_the_f32_forward(D):
    """``flash_attention_fwd_tf32_emulated``, the f32 K2's 3xTF32 rounding
    on the CPU, on the small ragged case: o within
    ``card_cases.TOL_F32_FLASH`` of the exact-f32 plain version's largest
    element (measured 9.9e-7 at D 64, 1.2e-6 at D 128) and lse within
    ``TOL_F32_LSE`` (4.8e-7, 9.5e-7), in f32; the fully masked row's o
    exactly 0 and its lse +1e30. The planted fault, one TF32 product,
    misses both gates by far (measured o 9.6e-4 and 5.5e-4, lse 2.8e-4 and
    1.8e-4). bf16 operands are refused."""
    (q, k, v, mask, *_), _ = _tf32_case(D)
    want_o, want_lse = attention.flash_attention_plain(q, k, v, mask)
    live = want_lse < 1e29

    def errs(o, lse):
        return _rel_t(o, want_o), float((lse - want_lse)[live].abs().max())

    o, lse = attention.flash_attention_fwd_tf32_emulated(q, k, v, mask)
    assert o.dtype == lse.dtype == torch.float32
    err_o, err_lse = errs(o, lse)
    assert err_o <= TOL_F32_FLASH and err_lse <= TOL_F32_LSE
    assert (o[~mask.any(dim=1)] == 0).all() and (lse[~live] == 1e30).all()
    fault_o, fault_lse = errs(*attention.flash_attention_fwd_tf32_emulated(
        q, k, v, mask, terms=1))
    assert fault_o > TOL_F32_FLASH and fault_lse > TOL_F32_LSE
    with pytest.raises(TypeError, match="f32 kernels"):
        attention.flash_attention_fwd_tf32_emulated(q.bfloat16(), k, v, mask)


@pytest.mark.parametrize("D", [64, 128])
def test_tf32_forward_model_matches_jax(D):
    """The f32 K2's 3xTF32 model against JAX's f32 forward (Pallas,
    interpret mode; the inputs and output that
    ``test_flash_f32_forward_and_grads_match_jax`` computes, no compile of
    its own): o within REL_FLASH."""
    (q, k, v, _, mask), want_o, _ = _jax_flash_f32(D)
    o, _ = attention.flash_attention_fwd_tf32_emulated(
        *(torch.from_numpy(x) for x in (q, k, v, mask)))
    assert _rel(o.numpy(), want_o) <= REL_FLASH


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 mantissa bits, rounds to nearest with ties
    away from zero (cvt.rna) and clears the 13 low bits."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp + ulp / 2, -(1 + ulp / 2),
                      1 + ulp / 2 - 2.0 ** -23, 3.14159265, 0.0],
                     dtype=torch.float32)
    want = [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 3.140625, 0.0]
    got = attention.tf32_round(x)
    assert got.tolist() == want
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    with pytest.raises(ValueError, match="terms"):
        attention._tf32x3("ij,jk->ik", x[:2, None], x[None, :2], terms=2)


def test_f32_wrappers_route_and_count():
    """On the CPU the f32 wrappers take the plain versions and count no
    launch; the dispatching wrappers hand f32 operands there too; the
    emulated kernels model bf16 tensor cores and refuse f32."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in _flash_inputs(
        1, 64, 1, 64, [40], seed=0))
    fns = (attention.flash_attention, attention.flash_attention_f32,
           attention.flash_attention_bwd_dq_f32,
           attention.flash_attention_bwd_dkv_f32)
    before = [f.launches for f in fns]
    o, lse = attention.flash_attention_f32(q, k, v, mask)
    o2, lse2 = attention.flash_attention(q, k, v, mask)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = attention.flash_delta(o, do)
    dq = attention.flash_attention_bwd_dq_f32(q, k, v, mask, do, lse, delta)
    assert torch.equal(dq, attention.flash_attention_bwd_dq_plain(
        q, k, v, mask, do, lse, delta))
    attention.flash_attention_bwd_dkv_f32(q, k, v, mask, do, lse, delta)
    assert [f.launches for f in fns] == before
    with pytest.raises(TypeError, match="bf16"):
        attention.flash_attention_emulated(q, k, v, mask)
    with pytest.raises(TypeError, match="bf16"):
        attention.flash_attention_bwd_emulated(q, k, v, mask, do, lse,
                                               delta)


def test_compute_dtype_names():
    """bfloat16, float32 and float16 are the ported compute dtypes; a name
    that neither package runs as an encoder dtype raises ValueError."""
    enc = tiny_config().encoder
    assert conformer.compute_dtype(enc) == torch.bfloat16
    assert conformer.compute_dtype(dataclasses.replace(
        enc, dtype="float32")) == torch.float32
    assert conformer.compute_dtype(dataclasses.replace(
        enc, dtype="float16")) == torch.float16
    for name in ("int8", "float64", "half"):
        with pytest.raises(ValueError, match="not a compute dtype"):
            conformer.compute_dtype(dataclasses.replace(enc, dtype=name))


def _f32_cfgs(kernels: bool):
    """tiny_config() at f32 in both packages; the port's with the kernel
    flags (their plain versions here) when ``kernels``."""
    return cases.dtype_cfgs("float32", kernels)


@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "kernels"])
def test_asr_forward_f32_matches_jax(kernels):
    """``asr_forward`` at f32 on tiny_config against JAX's jitted f32
    ``asr_forward`` on the same tree (B 3, T 1024, one row ragged, one
    padded): every head within REL_F32_MODEL on the plain paths, within
    REL_K3_MODEL with the kernel flags (K3's bf16 products); the mask
    exactly."""
    errs = cases.asr_forward_errors("float32", kernels)
    rel = REL_K3_MODEL if kernels else REL_F32_MODEL
    for key, err in errs.items():
        assert err <= rel, f"{key}: {err:.3e}"


def test_kernel_mode_f32_grads_match_jax():
    """The kernel-mode f32 forward's gradients (FlashAttention's backward:
    the f32 K6/K7 path; K3's backward), B 2, T 1024, a ragged row, the loss
    a fixed random projection of the CTC logits, speaker frames and
    encoder states: the loss within 1e-5 of its terms' magnitudes and every
    leaf's gradient within GRAD_REL relative L2 of JAX's (jitted
    value_and_grad of its f32 ``asr_forward``, Pallas in interpret
    mode)."""
    loss, want_loss, scale, errs = cases.kernel_mode_grads("float32")
    assert abs(loss - want_loss) <= 1e-5 * scale
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])


def test_train_step_f32_matches_jax():
    """One ``make_train_step`` update at f32 (the plain paths: the
    reference's loss calls its kernels without interpret mode, so its
    kernel-mode step runs only on a TPU) against the reference's
    ``make_train_step`` at f32 on a one-device CPU mesh, from the same
    parameters and batch (a ragged mask, one row without labels, every
    supervised key): the loss within 1e-4 relative (f32 throughout, only
    summation order differs) and every leaf's update (p - p0) within 1e-2
    relative L2 of the reference's (Adam's first update is about
    lr * sign(g): an element whose gradient is near 0 may take the other
    sign; worst leaf measured 3.6e-3)."""
    loss, want_loss, errs = cases.train_step_errors("float32")
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-2, (worst, errs[worst])


@pytest.mark.parametrize("n", [2, 4])
def test_sequence_mode_matches_window_mode_f32(n):
    """The port's sequence-parallel forward at f32 over n shards against
    its dense one-device ``asr_forward`` on the whole sequence (the
    counterpart of tests/test_sequence_parallel.py's f32 check, at its
    tolerance: atol 5e-3 and rtol 5e-3 on the CTC logits), with a ragged
    tail across shard edges."""
    _, cfg = _f32_cfgs(False)
    params = conformer.asr_init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    T = 512
    mel = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32))
    mask = torch.arange(T) < 400
    with torch.inference_mode():
        want = conformer.asr_forward(params, mel[None], mask[None],
                                     cfg)["ctc_logits"][0]
        got = sp_conformer_forward(params, mel, mask, cfg, build_mesh(
            MeshConfig(data=n), [CPU] * n))["ctc_logits"]
    nv = 400 // cfg.encoder.subsample_factor
    np.testing.assert_allclose(got[:nv].numpy(), want[:nv].numpy(),
                               atol=5e-3, rtol=5e-3)


@pytest.fixture(scope="module")
def f32_engines(tmp_path_factory):
    """tiny_config at f32, JAX-initialised (no x-vector: crop mode), the
    golden audio tiled to two windows, and the JAX engine at f32 with its
    greedy ids over those windows: built once for the engine tests."""
    from omnilingual_asr_tpu.config import MeshConfig as JaxMesh
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_mesh
    from omnilingual_asr_torch import testing

    jcfg, cfg = _f32_cfgs(False)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(0), jcfg)
    path = tmp_path_factory.mktemp("f32_engine") / "two_windows.wav"
    pcm = np.frombuffer(testing.GOLDEN_WAV.read_bytes()[44:], "<i2")
    two = np.zeros(int(cases.TWO_WINDOWS_S * 16000) + len(pcm), np.int16)
    two[:len(pcm)] = pcm
    two[int(cases.TWO_WINDOWS_S * 16000):] = pcm
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(two.tobytes())
    jeng = JaxEngine(config=jcfg, params=jp, batch_windows_per_device=2,
                     mesh=jax_mesh(JaxMesh(data=1), devices=jax.devices()[:1]))
    return {"cfg": cfg, "params": zoo.params_from_jax(jp), "path": path,
            "jax": jeng, "jax_ids": _window_ids(jeng, path)}


def _window_ids(engine, path):
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    return [np.asarray(o["ctc_ids"]).astype(int).tolist()
            for outs in engine._forward_batches(windows, n_last)
            for o in outs]


@pytest.mark.parametrize("mode", ["window", "data_parallel", "crop"])
def test_f32_engine_modes_match_jax(mode, f32_engines):
    """The port's engine with the f32 encoder against the JAX engine at
    f32 on the same tiny weights, on the golden audio tiled to two
    windows: window mode and data-parallel windows (a mesh of 2 CPU
    shards, a window each) give the JAX engine's greedy ids on
    MIN_CTC_AGREEMENT of the frames (measured: every id equal); crop
    mode's re-embeddings are within
    rel-L2 1e-4 of the JAX engine's (f32 in both; the bf16 engine's test
    allows 1e-3) and its result equals the JAX result by
    ``testing.result_mismatches``."""
    from omnilingual_asr_torch import testing
    from omnilingual_asr_torch.engine import TranscriptionEngine

    cfg, tp, path, jeng = (f32_engines[k] for k in ("cfg", "params", "path",
                                                     "jax"))
    kw = {"batch_windows_per_device": 2}
    if mode == "data_parallel":
        kw = {"batch_windows_per_device": 1,
              "mesh": build_mesh(MeshConfig(data=2), [CPU] * 2)}
    else:
        kw["device"] = "cpu"
    port = TranscriptionEngine(config=cfg, params=tp, **kw)
    assert jeng.speaker_mode == port.speaker_mode == "crop"
    if mode != "crop":
        agree = testing.ctc_agreement(f32_engines["jax_ids"],
                                      _window_ids(port, path))
        assert agree >= testing.MIN_CTC_AGREEMENT, agree
        return
    samples = jeng._load_audio(path)
    samples_windows = jeng._windows(samples)
    n_last = len(samples) - (len(samples_windows) - 1) * jeng.window_samples
    outs = [o for b in jeng._forward_batches(samples_windows, n_last)
            for o in b]
    decoded = jeng._extract_windows(outs)[0]
    want = jeng._segment_crop_embeds(samples, decoded)
    got = port._segment_crop_embeds(samples, decoded)
    rel = (np.linalg.norm(got - want, axis=1)
           / np.linalg.norm(want, axis=1))
    assert rel.max() <= 1e-4, rel.max()
    w = dataclasses.asdict(jeng.transcribe(path))
    g = port.transcribe(path).to_dict()
    assert testing.result_mismatches(
        w, g, tone_mass=testing.tone_mass(jeng, path)) == []
