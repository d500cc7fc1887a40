"""PyTorch port: the K6/K7 sweep's hold on the CUDA sources
(``ops/flash_bwd_sweep.py`` through ``ops/sweep.py``). The sweep itself
runs on the card; these check, on the CPU, that the constants it sets
exist in the sources as it parses them, that a candidate's copy of a
source carries exactly its values, and that it times the card's shapes."""

from __future__ import annotations

import re

import pytest
import torch

from omnilingual_asr_torch.ops import card_cases, cuda_build, sweep
from omnilingual_asr_torch.ops import flash_bwd_sweep as fsweep

torch.set_num_threads(2)

TUNED = {"bf16": ("DQ_MIN_BLOCKS_64", "DQ_MIN_BLOCKS_128",
                  "DKV_MIN_BLOCKS_64", "DKV_MIN_BLOCKS_128"),
         "f32": tuple(f"{k}_{what}_{d}" for k in ("DQ", "DKV")
                      for what in ("TILE", "STEP", "MIN_BLOCKS",
                                   "FEW_TILE", "FEW_STEP", "FEW_MIN_BLOCKS")
                      for d in (64, 128) if d == 64 or "FEW" not in what)}


@pytest.mark.parametrize("group", sorted(TUNED))
def test_every_tuned_constant_is_in_the_source(group):
    values = sweep.source_values(fsweep.SOURCES[group], TUNED[group])
    assert set(values) == set(TUNED[group])
    assert all(v > 0 for v in values.values())
    with pytest.raises(ValueError, match="no constant NOT_A_CONSTANT"):
        sweep.source_values(fsweep.SOURCES[group],
                            TUNED[group] + ("NOT_A_CONSTANT",))


def test_f32_tiles_hold_whole_steps():
    """The f32 kernels' static_asserts, read from the source's values: a
    tile holds whole steps of 8 rows, at most one row a thread, for the
    standard and the FEW choices."""
    v = sweep.source_values("attention_f32.cu", TUNED["f32"])
    for prefix in ("DQ_", "DKV_", "DQ_FEW_", "DKV_FEW_"):
        for d in (64, 128) if "FEW" not in prefix else (64,):
            tile, step = v[f"{prefix}TILE_{d}"], v[f"{prefix}STEP_{d}"]
            assert tile % step == 0 and step % 8 == 0 and tile <= 128


@pytest.mark.parametrize("group,name", [("bf16", "DQ_MIN_BLOCKS_64"),
                                        ("f32", "DKV_STEP_128")])
def test_variant_dir_sets_one_constant(group, name, tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path)
    src = fsweep.SOURCES[group]
    base = sweep.source_values(src, TUNED[group])
    out = sweep.variant_dir(src, {name: base[name] * 2}, group)
    text = (out / src).read_text()
    got = {n: int(re.search(sweep.CONST.format(name=n), text)[2])
           for n in TUNED[group]}
    assert got == dict(base, **{name: base[name] * 2})
    names = {p.name for p in out.iterdir()}
    assert {src, "common.cu"} | {p.name for p in
                                 cuda_build.CSRC_DIR.glob("*.cuh")} == names


def test_sweep_shapes_are_the_cards():
    assert fsweep.SHAPES == {
        "train": card_cases.F32_FLASH_SHAPES["training"],
        "serving": card_cases.F32_FLASH_SHAPES["serving"],
        "d128": card_cases.F32_FLASH_SHAPES["d128"]}
    assert set(fsweep.SOURCES) == set(fsweep.KERNELS) == set(fsweep.ENTRIES)
    for entries in fsweep.ENTRIES.values():
        assert all(e in cuda_build._SIGNATURES for e in entries)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e024flash_bwd_"
     "dq_tf32_kernelILi64ELb1EEEvPKfS2_S2_PKiS2_S2_S2_Pfiif",
     "flash_bwd_dq_tf32_kernel<64, true>"),
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e025flash_bwd_"
     "dkv_tf32_kernelILi128ELb0EEEvPKfS2_S2_PKiS2_S2_S2_PfS5_iif",
     "flash_bwd_dkv_tf32_kernel<128, false>"),
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e020flash_fwd_"
     "f32_kernelILi64EEEvPKfS2_S2_PKiPfS5_iif", "flash_fwd_f32_kernel<64>")])
def test_kernel_names_carry_their_template_arguments(mangled, name):
    """ptxas's log names the f32 K6/K7 by head dim and tile choice; the
    sweep and chip_smoke.py pick their lines by these names."""
    assert cuda_build.kernel_name(mangled) == name
