"""PyTorch port: the f16 encoder (``EncoderConfig.dtype == "float16"``)
against the JAX package on the CPU.

The JAX kernels K2, K6 and K7 are generic in their input type: at f16 they
cast q, k, v and dO to f32 inside, take every product in f32 and round
o, dq, dk and dv to f16. The port sends f16 operands to its f16 kernels
on a card and to the same plain versions as bf16 and f32 on the CPU, so
these tests hold the plain versions and the f16 model around them to the
JAX package's f16 functions (its Pallas kernels in interpret mode, jitted),
and the CPU models of the f16 K2's and of the f16 K6 and K7's products to
both. Inputs are drawn from seeds with numpy; each test states its
tolerance. The kernels themselves are held to the plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3 and 4o).

Tolerance of anything rounded to f16 (``F16_TOL``): f16's rounding of
the output, half an ulp of its largest element, 2^-11 max|want|; where
every element lies under f16's normal range (the gradients at dO x 1e-6,
all near 1e-6), one step of f16's subnormal grid, 2^-24, whichever is
larger. The models of the f16 kernels are also held to JAX within the
card's per-element gate (``card_cases.TOL_F16_*``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_dtype_cases as cases
from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import MeshConfig
from omnilingual_asr_torch.ops import attention
from omnilingual_asr_torch.ops.card_cases import F16_LARGE_DO
from omnilingual_asr_torch.ops.card_cases import f16_share as f16_share_card
from omnilingual_asr_torch.parallel.mesh import build_mesh
from omnilingual_asr_torch.testing import greedy_ids
from test_torch_golden import (F32_TILED_SECONDS, RELEASE,
                               _release_port_config, write_tiled)

torch.set_num_threads(2)

CPU = torch.device("cpu")
F16_REL = 2.0 ** -11
F16_SUB = 2.0 ** -24
#: dO's scales: 1; 1e-6 (a mean loss over a batch), where a kernel that
#: split dS into f16 halves without a scale would flush dS (f16 ends at
#: 2^-24); and 2^10 (``card_cases.F16_LARGE_DO``: dS up to ~5e3, the
#: gradients up to ~2e3), where a fixed scale of dS that holds dO x 1
#: overflows f16's 65504.
DO_SCALES = (1.0, 1e-6, F16_LARGE_DO)
DO_IDS = ["do1", "do1e-6", "do2^10"]


def f16_share(got, want) -> float:
    """max |got - want| over ``F16_TOL`` (see the module docstring):
    max(2^-11 max|want|, 2^-24). At most 1 passes."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    tol = max(F16_REL * np.abs(want).max(), F16_SUB)
    return float(np.abs(got - want).max() / tol)


@functools.lru_cache(maxsize=None)
def _case(D, scale):
    """Inputs at [2, 256, 2, D] with a ragged row (the JAX kernel takes T
    in whole 256-key blocks), f16, dO times ``scale``; and JAX's f16
    (o, (dq, dk, dv)) on them, run once a (D, scale) for the tests that
    share them (read only)."""
    q, k, v, do, mask = cases.flash_inputs(2, 256, 2, D, [256, 100], seed=D,
                                           dtype=np.float16)
    do = (do.astype(np.float32) * scale).astype(np.float16)
    return (q, k, v, do, mask), cases.jax_flash(q, k, v, mask, do)


@pytest.mark.parametrize("scale", DO_SCALES, ids=DO_IDS)
@pytest.mark.parametrize("D", [64, 128])
def test_flash_f16_forward_and_grads_match_jax(D, scale):
    """``FlashAttention`` at f16 (the plain versions of K2, K6, K7 on the
    CPU) against JAX's ``flash_attention`` at f16 (Pallas, interpret mode)
    and its custom VJP, at [2, 256, 2, D] with a ragged row: o, dq, dk and
    dv in f16 within F16_TOL (measured: o 1.1e-4 and 2.9e-4 of its
    largest element at D 64 and 128, the gradients 1.1e-4 to 2.7e-4 at dO
    x 1 and x 2^10; at dO x 1e-6 equal), masked keys' dk and dv exactly
    0."""
    (q, k, v, do, mask), (want_o, want_g) = _case(D, scale)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = attention.FlashAttention.apply(qt, kt, vt, torch.from_numpy(mask))
    assert o.dtype == torch.float16
    o.backward(torch.from_numpy(do))
    assert f16_share(o.detach().numpy(), want_o) <= 1.0
    for t, w in zip((qt, kt, vt), want_g):
        assert t.grad.dtype == torch.float16
        assert f16_share(t.grad.numpy(), w) <= 1.0, f16_share(t.grad, w)
    masked = ~torch.from_numpy(mask)
    assert (kt.grad[masked] == 0).all() and (vt.grad[masked] == 0).all()


@pytest.mark.parametrize("scale", DO_SCALES, ids=DO_IDS)
@pytest.mark.parametrize("D", [64, 128])
def test_f16_models_match_jax(D, scale):
    """The CPU models of the f16 kernels' rounding
    (``flash_attention_fwd_f16_emulated``,
    ``flash_attention_bwd_f16_emulated``: dS under its rows' power-of-two
    exponents, P times 2^14, both split as f16 hi + lo) against JAX's f16
    forward and gradients (Pallas, interpret mode; the inputs and JAX
    results of ``test_flash_f16_forward_and_grads_match_jax``, shared): o,
    dq, dk, dv within F16_TOL and within the card's per-element gate
    (``card_cases.TOL_F16_*``, with its subnormal step at dO x 1e-6);
    measured at dO x 1 and x 2^10: 0.28-0.44 of F16_TOL, 0.51-0.60 of the
    gate; at dO x 1e-6 equal. The forward's o (P x 2^14 split as f16 hi +
    lo against V exact) 0.22 and 0.59 of F16_TOL at D 64 and 128, 0.44
    and 0.69 of the gate, equal to the plain version's shares."""
    (q, k, v, do, mask), (want_o, want_g) = _case(D, scale)
    qt, kt, vt, dot, mt = (torch.from_numpy(x) for x in (q, k, v, do, mask))
    o, _ = attention.flash_attention_fwd_f16_emulated(qt, kt, vt, mt)
    assert f16_share(o.numpy(), want_o) <= 1.0
    assert f16_share_card(o, torch.from_numpy(want_o), False) <= 1.0
    _, lse = attention.flash_attention_plain(qt, kt, vt, mt)
    delta = attention.flash_delta(torch.from_numpy(want_o), dot)
    got = attention.flash_attention_bwd_f16_emulated(qt, kt, vt, mt, dot,
                                                     lse, delta)
    for g, w in zip(got, want_g):
        assert g.dtype == torch.float16
        assert f16_share(g.numpy(), w) <= 1.0, (f16_share(g.numpy(), w))
        share = f16_share_card(g, torch.from_numpy(w), scale < 1.0)
        assert share <= 1.0, share


#: The planted faults of the f16 backward's model, each with the dO scale
#: where it misses the card's gate: the f16 operand rounded to bf16 (the
#: bf16 kernels' arithmetic), dS split in f16 without a scale (flushed at
#: small dO), and dS under one fixed scale of 2^12, which holds dO x 1's
#: dS (up to ~5, 2^14.3 scaled) and overflows at dO x 2^10.
BWD_FAULTS = {1.0: {"b_exact": False}, 1e-6: {"ds_exp": 0},
              F16_LARGE_DO: {"ds_exp": 12}}


@pytest.mark.parametrize("D", [64, 128])
def test_f16_models_within_the_card_tolerance(D):
    """On a small ragged case at f16 ([3, 200, 2, D]: a partial last tile
    of the kernels' 64-row blocks, a partly masked row and a fully masked
    slot), the models of the f16 kernels against the plain versions pass
    the card's per-element gate (``card_cases.TOL_F16_*``; the largest
    share measured 0.39-0.63 at dO x 1 and x 2^10, and 0 at dO x 1e-6;
    the forward's o 0.60 and 0.72 at D 64 and 128), with masked keys' dK
    and dV, the fully masked row's o and dQ exactly 0, at every dO scale;
    the planted faults miss it where they should (the forward's V rounded
    to bf16 8.5 and 12.5; ``BWD_FAULTS``: the bf16-rounded operand
    8.3-16.9 at dO x 1, the
    unscaled f16 split two subnormal steps off at dO x 1e-6, the fixed
    scale not finite at dO x 2^10), and the fixed scale passes at dO x 1,
    where it holds."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in cases.flash_inputs(
        3, 200, 2, D, [200, 130, 0], seed=D + 7, dtype=np.float16))
    want_o, lse = attention.flash_attention_plain(q, k, v, mask)
    o, _ = attention.flash_attention_fwd_f16_emulated(q, k, v, mask)
    assert f16_share_card(o, want_o, False) <= 1.0
    assert (o[~mask.any(dim=1)] == 0).all()
    fault, _ = attention.flash_attention_fwd_f16_emulated(q, k, v, mask,
                                                          v_exact=False)
    assert f16_share_card(fault, want_o, False) > 1.0

    def worst(got, want, sub):
        return max(f16_share_card(g, w, sub) for g, w in zip(got, want))

    for scale in DO_SCALES:
        d = (do.float() * scale).half()
        args = (q, k, v, mask, d, lse, attention.flash_delta(want_o, d))
        want = (attention.flash_attention_bwd_dq_plain(*args),
                *attention.flash_attention_bwd_dkv_plain(*args))
        got = attention.flash_attention_bwd_f16_emulated(*args)
        sub = scale < 1.0
        assert worst(got, want, sub) <= 1.0, scale
        dq, dk, dv = got
        assert (dq[~mask.any(dim=1)] == 0).all()
        assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()
        fault = attention.flash_attention_bwd_f16_emulated(
            *args, **BWD_FAULTS[scale])
        assert worst(fault, want, sub) > 1.0, scale
        if scale == 1.0:
            held = attention.flash_attention_bwd_f16_emulated(
                *args, **BWD_FAULTS[F16_LARGE_DO])
            assert worst(held, want, sub) <= 1.0


def test_f16_wrappers_route_and_count():
    """On the CPU the f16 wrappers take the plain versions and count no
    launch; the dispatching wrappers hand f16 operands there too; each
    emulation refuses the other dtypes' operands."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in cases.flash_inputs(
        1, 64, 1, 64, [40], seed=0, dtype=np.float16))
    fns = (attention.flash_attention, attention.flash_attention_f16,
           attention.flash_attention_bwd_dq_f16,
           attention.flash_attention_bwd_dkv_f16)
    before = [f.launches for f in fns]
    o, lse = attention.flash_attention_f16(q, k, v, mask)
    o2, lse2 = attention.flash_attention(q, k, v, mask)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert o.dtype == torch.float16
    delta = attention.flash_delta(o, do)
    dq = attention.flash_attention_bwd_dq_f16(q, k, v, mask, do, lse, delta)
    assert torch.equal(dq, attention.flash_attention_bwd_dq_plain(
        q, k, v, mask, do, lse, delta))
    attention.flash_attention_bwd_dkv_f16(q, k, v, mask, do, lse, delta)
    assert [f.launches for f in fns] == before
    assert torch.float16 in attention.KERNEL_DTYPES
    for fn in (attention.flash_attention_emulated,
               attention.flash_attention_fwd_tf32_emulated):
        with pytest.raises(TypeError):
            fn(q, k, v, mask)
    with pytest.raises(TypeError, match="f16 kernels"):
        attention.flash_attention_fwd_f16_emulated(q.float(), k, v, mask)
    with pytest.raises(TypeError, match="f16 kernels"):
        attention.flash_attention_bwd_f16_emulated(q.bfloat16(), k, v, mask,
                                                   do, lse, delta)


#: The whole f16 model against JAX's f16 model, max abs error over each
#: output's largest magnitude. Both round every product's operands to f16
#: and sum exact products in f32, in another order: the elements then
#: differ where an f32 difference flips an f16 rounding (2^-11 relative)
#: of one operand, through the blocks (measured 1.5e-4 to 4.7e-4 over two
#: blocks on the plain paths). With the kernel flags K3 computes its
#: products in bf16 at every dtype (the reference's rule), whose flips
#: move a term by 2^-8 relative (measured 8.8e-4 to 1.3e-3; the f32
#: file's gate for the same is 5e-3). A bf16 rounding in place of f16 in
#: the dense layers moves every head by 2^-8 relative steps instead.
REL_F16_MODEL = 2e-3
REL_K3_MODEL = 5e-3


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_asr_forward_f16_matches_jax(kernels):
    """``asr_forward`` at f16 on tiny_config against JAX's jitted f16
    ``asr_forward`` on the same tree (B 3, T 1024, one row ragged, one
    padded): every head within REL_F16_MODEL on the plain paths, within
    REL_K3_MODEL with the kernel flags (K3's bf16 products); the mask
    exactly."""
    errs = cases.asr_forward_errors("float16", kernels)
    rel = REL_K3_MODEL if kernels else REL_F16_MODEL
    assert max(errs.values()) <= rel, errs


#: Gradients of the f16 kernel-mode forward and one f16 update against
#: JAX's, per leaf relative L2: both round activations and weights to f16
#: at every dense product and K3's products to bf16, so rounding flips
#: move single elements of the upstream gradients (worst leaf measured
#: 2.1e-2 for the gradients, 2.8e-2 for the update; the bf16 kernel-mode
#: gradient test of tests/test_torch_train.py allows 5e-2, and the same
#: one-step update at bf16 reads 1.6e-1, where that file allows 1e-1).
GRAD_REL = 5e-2


def test_kernel_mode_f16_grads_match_jax():
    """The kernel-mode f16 forward's gradients (FlashAttention's backward:
    the f16 K6/K7 path; K3's backward), B 2, T 1024, a ragged row, the loss
    a fixed random projection of the CTC logits, speaker frames and
    encoder states: the loss within 1e-5 of its terms' magnitudes
    (measured 1.4e-6) and
    every leaf's gradient within GRAD_REL relative L2 of JAX's (jitted
    value_and_grad of its f16 ``asr_forward``, Pallas in interpret
    mode)."""
    loss, want_loss, scale, errs = cases.kernel_mode_grads("float16")
    assert abs(loss - want_loss) <= 1e-5 * scale
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])


def test_train_step_f16_matches_jax():
    """One ``make_train_step`` update at f16 (the plain paths: the
    reference's loss calls its kernels without interpret mode, so its
    kernel-mode step runs only on a TPU) against the reference's
    ``make_train_step`` at f16 on a one-device CPU mesh, from the same
    parameters and batch: the loss within 1e-4 relative (f16 roundings
    of the operands in both, sums in another order; measured 1e-7) and
    every leaf's update (p - p0) within GRAD_REL relative L2 of the
    reference's (Adam's first update is about lr * sign(g): an element
    whose gradient is near 0 may take the other sign)."""
    loss, want_loss, errs = cases.train_step_errors("float16")
    assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])


@pytest.mark.parametrize("model", [1, 2])
def test_f16_engine_matches_golden(model, tmp_path):
    """The port's CPU engine with the release weights and the f16 encoder
    (``encoder.dtype="float16"``) against the JAX engine's f16 results
    (``golden_f16.json``), with one model shard and at (data, model) (1, 2)
    on host devices (tensor parallelism: K2 on each shard's heads): the
    golden file's result by ``testing.result_mismatches`` and its greedy
    ids on MIN_CTC_AGREEMENT; at model 1 also the 120 s tiling's ids on
    MIN_CTC_AGREEMENT."""
    from omnilingual_asr_torch.engine import TranscriptionEngine

    cfg = _release_port_config()
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  dtype="float16"))
    kw = ({"device": "cpu"} if model == 1 else
          {"mesh": build_mesh(MeshConfig(data=1, model=model),
                              [CPU] * model)})
    eng = TranscriptionEngine(config=cfg, xvector_path=str(
        RELEASE / "xvector.npz"), **kw)
    stored = golden.load_golden_f16()
    res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
    assert golden.result_mismatches(stored["result"], res,
                                    tone_mass=stored["tone_mass"]) == []
    files = [(stored, golden.GOLDEN_WAV)]
    if model == 1:
        files.append((stored["tiled"],
                      write_tiled(tmp_path / "golden.wav",
                                  F32_TILED_SECONDS)))
    for want, path in files:
        assert golden.ctc_agreement(want["ctc_ids"],
                                    greedy_ids(eng, path)) >= \
            golden.MIN_CTC_AGREEMENT
