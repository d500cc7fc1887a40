"""PyTorch port: the K3/K4/K5 tiling sweep's hold on the CUDA sources. The sweep
itself runs on the card; these check, on the CPU, that the constants it
sets exist in the sources as it parses them and that a candidate's copy of
the sources carries exactly its values."""

from __future__ import annotations

import re

import pytest
import torch

from omnilingual_asr_torch.ops import (card_cases, conv_module, cuda_build,
                                       quant)
from omnilingual_asr_torch.ops import conv_quant_sweep as sweep

torch.set_num_threads(2)

TUNED = {"k3": ("TT_SMALL", "TT_LARGE", "S1_WM", "S1_MIN_BLOCKS", "PIPE",
                "BM2", "BN2", "WM2", "S2_MIN_BLOCKS"),
         "k4": ("K4_BM", "K4_BN", "K4_BK", "K4_WM", "K4_WN", "K4_STAGES",
                "K4_MIN_BLOCKS"),
         "k5": ("A8_BM", "A8_BN", "A8_STAGES", "A8_MIN_BLOCKS")}


def test_parse_reads_a_candidate():
    assert sweep.parse("A8_BM=32,A8_STAGES=3") == {"A8_BM": 32,
                                                   "A8_STAGES": 3}


@pytest.mark.parametrize("kernel", ["k3", "k4", "k5"])
def test_every_tuned_constant_is_in_the_source(kernel):
    values = sweep.source_values(kernel, TUNED[kernel])
    assert set(values) == set(TUNED[kernel])
    assert all(v > 0 for v in values.values())
    with pytest.raises(ValueError, match="no constant NOT_A_CONSTANT"):
        sweep.source_values(kernel, TUNED[kernel] + ("NOT_A_CONSTANT",))


@pytest.mark.parametrize("kernel,name", [("k3", "TT_LARGE"),
                                         ("k4", "K4_STAGES"),
                                         ("k5", "A8_STAGES")])
def test_variant_dir_sets_one_constant(kernel, name, tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path)
    base = sweep.source_values(kernel, TUNED[kernel])
    out = sweep.variant_dir(kernel, {name: base[name] + 1})
    src = sweep.SOURCES[kernel]
    text = (out / src).read_text()
    want = dict(base, **{name: base[name] + 1})
    got = {n: int(re.search(sweep.CONST.format(name=n), text)[2])
           for n in TUNED[kernel]}
    assert got == want
    # the copy holds the kernel's source, common.cu and every header
    names = {p.name for p in out.iterdir()}
    assert {src, "common.cu"} | {p.name for p in
                                 cuda_build.CSRC_DIR.glob("*.cuh")} == names
    with pytest.raises(ValueError, match="no constant"):
        sweep.variant_dir(kernel, {"NOT_A_CONSTANT": 1})


@pytest.mark.parametrize("name", sorted(card_cases.K3_SHAPES))
def test_k3_card_case_is_a_shape_the_kernel_takes(name):
    B, T, D, valid = card_cases.K3_SHAPES[name]
    assert len(valid) == B and all(0 <= v <= T for v in valid)
    assert D % 64 == 0 and D <= conv_module.KERNEL_MAX_D


@pytest.mark.parametrize("name", sorted(card_cases.K5_SHAPES))
def test_k5_card_case_is_a_shape_the_kernel_takes(name):
    M, K, N = card_cases.K5_SHAPES[name]
    assert M >= 1 and K % quant.KERNEL_BLOCK_K == 0
    assert N % quant.KERNEL_BLOCK_N == 0
    assert name == f"n{N}"


@pytest.mark.parametrize("name", sorted(card_cases.K4_SHAPES))
def test_k4_card_case_is_a_shape_the_kernel_takes(name):
    M, K, N = card_cases.K4_SHAPES[name]
    assert M >= 1 and K % quant.KERNEL_BLOCK_K == 0
    assert N % quant.KERNEL_BLOCK_N == 0
    assert name == f"n{N}"


def test_k4_tolerance_is_unchanged():
    """K4's per-element tolerance: 2 K 2^-24 sum|terms| * scale, plus
    2^-23 |ref| with a bias."""
    assert card_cases.TOL_K4_ORDER == 2.0 ** -24


def test_k4_error_share_reads_the_tolerance():
    """The share is |got - want| over 2 K 2^-24 (|bf16(x)| @ |w_q|) scale
    (+ 2^-23 |want| with a bias): exactly 1 at the tolerance, 0 where
    they agree."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 128, generator=gen)
    w_q, scale = quant.quantize_weight(torch.randn(128, 128, generator=gen))
    bias = torch.randn(128, generator=gen)
    want = quant.quantized_matmul_plain(x, w_q, scale, bias)
    assert card_cases.k4_error_share(want, want, x, w_q, scale, bias) == (
        0.0, 0.0)
    tol = (2 * 128 * 2.0 ** -24 * (x.bfloat16().float().abs().double()
                                   @ w_q.double().abs())
           * scale.double()).float()
    # (want + tol is rounded to f32, so the share is 1 within an ulp of
    # want over tol)
    err, share = card_cases.k4_error_share(want + tol, want, x, w_q, scale)
    assert share == pytest.approx(1.0, rel=1e-2)
    _, share_b = card_cases.k4_error_share(want + tol, want, x, w_q, scale,
                                           bias)
    assert share_b < share


def test_k4_phases_instruments_the_source():
    """The phase tool's edits each find their one place in quant.cu: the
    copy stamps the pre-pass twice and the product six times, and a source
    without one of the places is refused."""
    from omnilingual_asr_torch.ops import k4_phases

    src = (cuda_build.CSRC_DIR / "quant.cu").read_text()
    text = k4_phases.instrument(src)
    assert all(f"k4_stamp[k4_bid][{i}] = k4_now();" in text
               for i in range(len(k4_phases.STAMPS)))
    assert text.count("k4_pre[blockIdx.x]") == 2
    assert "OMNI_API int omni_k4_stamps(" in text
    with pytest.raises(ValueError, match="does not hold"):
        k4_phases.instrument(src.replace("  const int kc = K / K4_BK;\n", ""))
