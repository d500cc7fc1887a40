"""PyTorch port: the K3/K5 tiling sweep's hold on the CUDA sources. The sweep
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
         "k5": ("A8_BM", "A8_BN", "A8_STAGES", "A8_MIN_BLOCKS")}


def test_parse_reads_a_candidate():
    assert sweep.parse("A8_BM=32,A8_STAGES=3") == {"A8_BM": 32,
                                                   "A8_STAGES": 3}


@pytest.mark.parametrize("kernel", ["k3", "k5"])
def test_every_tuned_constant_is_in_the_source(kernel):
    values = sweep.source_values(kernel, TUNED[kernel])
    assert set(values) == set(TUNED[kernel])
    assert all(v > 0 for v in values.values())
    with pytest.raises(ValueError, match="no constant NOT_A_CONSTANT"):
        sweep.source_values(kernel, TUNED[kernel] + ("NOT_A_CONSTANT",))


@pytest.mark.parametrize("kernel,name", [("k3", "TT_LARGE"),
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
