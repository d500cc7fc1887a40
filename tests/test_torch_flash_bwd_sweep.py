"""PyTorch port: the K6/K7 (and f32 and f16 K2) sweep's hold on the CUDA sources
(``ops/flash_bwd_sweep.py`` through ``ops/sweep.py``), and the f32 K2's
parts (``ops/k2_f32_parts.py``). Both run on the card; these check, on
the CPU, that the constants the sweep sets exist in the sources as it
parses them, that a candidate's copy of a source carries exactly its
values, that it times the card's shapes, and that each part's edit
applies to the forward once."""

from __future__ import annotations

import re

import pytest
import torch

from omnilingual_asr_torch.ops import card_cases, cuda_build, sweep
from omnilingual_asr_torch.ops import flash_bwd_sweep as fsweep
from omnilingual_asr_torch.ops import k2_f32_parts as k2_parts

torch.set_num_threads(2)

# The f32 K2's: by head dim the tile, step, blocks an SM, warp groups of a
# tile and row tiles a warp; at D 64 the same under FEW.
FWD = tuple(f"FWD_{what}_{d}" for what in ("TILE", "STEP", "MIN_BLOCKS",
                                           "SPLIT", "MTILES", "FEW_TILE",
                                           "FEW_STEP", "FEW_MIN_BLOCKS",
                                           "FEW_SPLIT", "FEW_MTILES")
            for d in (64, 128) if d == 64 or "FEW" not in what)
# The f16 K6 and K7 are the bf16 ones' template over f16 operands: the
# same source and constants.
TUNED = {"bf16": ("DQ_MIN_BLOCKS_64", "DQ_MIN_BLOCKS_128",
                  "DKV_MIN_BLOCKS_64", "DKV_MIN_BLOCKS_128"),
         "f16": ("DQ_MIN_BLOCKS_64", "DQ_MIN_BLOCKS_128",
                 "DKV_MIN_BLOCKS_64", "DKV_MIN_BLOCKS_128"),
         "f32": tuple(f"{k}_{what}_{d}" for k in ("DQ", "DKV")
                      for what in ("TILE", "STEP", "MIN_BLOCKS",
                                   "FEW_TILE", "FEW_STEP", "FEW_MIN_BLOCKS")
                      for d in (64, 128) if d == 64 or "FEW" not in what)
         + FWD,
         # the f16 K2's ring stages, launch bounds and two-warpgroup grids
         "f16fwd": tuple(f"FWD16_{what}_{d}" for what in (
             "STAGES", "MIN_BLOCKS", "SPLIT_BLOCKS") for d in (64, 128))}


@pytest.mark.parametrize("group", sorted(TUNED))
def test_every_tuned_constant_is_in_the_source(group):
    values = sweep.source_values(fsweep.SOURCES[group], TUNED[group])
    assert set(values) == set(TUNED[group])
    assert all(v > 0 for k, v in values.items() if "SPLIT_BLOCKS" not in k)
    assert all(v >= 0 for v in values.values())
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


@pytest.mark.parametrize("d,few", [(64, False), (64, True), (128, False)])
def test_f32_forward_tiles_hold_whole_steps(d, few):
    """The f32 K2's static_asserts, read from the source's values: one or
    two groups of 4 warps, one or two row tiles a warp; a tile holds whole
    steps of 16 keys for every group, at most one key a thread; two
    groups' merge fits the streamed area (K's and V's tiles)."""
    v = sweep.source_values("attention_f32.cu", FWD)
    pre = "FWD_FEW_" if few else "FWD_"
    tile, step = v[f"{pre}TILE_{d}"], v[f"{pre}STEP_{d}"]
    split, mt = v[f"{pre}SPLIT_{d}"], v[f"{pre}MTILES_{d}"]
    assert split in (1, 2) and mt in (1, 2)
    assert v[f"{pre}MIN_BLOCKS_{d}"] >= 1
    assert tile % (split * step) == 0 and step % 16 == 0
    assert tile <= 128 * split
    merge = 4 * mt * ((d // 8) * 4 * 32 + 2 * 2 * 32)
    assert split == 1 or merge <= 6 * tile * d


@pytest.mark.parametrize("group,name", [("bf16", "DQ_MIN_BLOCKS_64"),
                                        ("f32", "DKV_STEP_128"),
                                        ("f32", "FWD_FEW_SPLIT_64"),
                                        ("f16fwd", "FWD16_STAGES_64")])
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


@pytest.mark.parametrize("part", sorted(k2_parts.EDITS))
def test_k2_f32_parts_edit_the_forward_once(part):
    """``ops/k2_f32_parts.py``: each part's texts occur once in the f32
    source and the copy differs from it; a source without them raises."""
    src = (cuda_build.CSRC_DIR / k2_parts.SOURCE).read_text()
    assert k2_parts.edit(src, part) != src
    old = k2_parts.EDITS[part][0][0]
    with pytest.raises(ValueError, match=part):
        k2_parts.edit(src.replace(old, ""), part)


def test_sweep_shapes_are_the_cards():
    assert fsweep.SHAPES == {
        "train": card_cases.F32_FLASH_SHAPES["training"],
        "serving": card_cases.F32_FLASH_SHAPES["serving"],
        "d128": card_cases.F32_FLASH_SHAPES["d128"]}
    assert fsweep.GROUP_SHAPES == {"f16fwd": card_cases.F16_FLASH_SHAPES}
    assert (set(fsweep.SOURCES) == set(fsweep.KERNELS) == set(fsweep.ENTRIES)
            == set(fsweep.DTYPES))
    for entries in fsweep.ENTRIES.values():
        assert all(e in cuda_build._SIGNATURES for e in entries)
    assert set(fsweep.FWD_ENTRIES) <= set(fsweep.SOURCES)
    assert all(e in cuda_build._SIGNATURES
               for e in fsweep.FWD_ENTRIES.values())


@pytest.mark.parametrize("mangled,name", [
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e024flash_bwd_"
     "dq_tf32_kernelILi64ELb1EEEvPKfS2_S2_PKiS2_S2_S2_Pfiif",
     "flash_bwd_dq_tf32_kernel<64, true>"),
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e025flash_bwd_"
     "dkv_tf32_kernelILi128ELb0EEEvPKfS2_S2_PKiS2_S2_S2_PfS5_iif",
     "flash_bwd_dkv_tf32_kernel<128, false>"),
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e020flash_fwd_"
     "f32_kernelILi64EEEvPKfS2_S2_PKiPfS5_iif", "flash_fwd_f32_kernel<64>"),
    ("_ZN49_GLOBAL__N__0f1a5c70_16_attention_f32_cu_5e4899e021flash_fwd_"
     "tf32_kernelILi64ELb1EEEvPKfS2_S2_PKiPfS5_iif",
     "flash_fwd_tf32_kernel<64, true>"),
    ("_ZN49_GLOBAL__N__fab89847_16_attention_f16_cu_6b133f7b20flash_fwd_"
     "f16_kernelILi64ELi2EEEv14CUtensorMap_stS1_S1_PKiP6__halfPfiif",
     "flash_fwd_f16_kernel<64, 2>")])
def test_kernel_names_carry_their_template_arguments(mangled, name):
    """ptxas's log names the f32 K2, K6 and K7 by head dim and tile
    choice, the f16 K2 by head dim and warpgroups a block; the sweep and
    chip_smoke.py pick their lines by these names."""
    assert cuda_build.kernel_name(mangled) == name
