"""PyTorch port: tensor parallelism (``parallel/tensor.py``, the specs and
``tp_asr_forward`` of ``models/conformer.py``, the split conv module of
``ops/conv_module.py``) held to the port's unsharded forward and to the JAX
package's GSPMD-sharded one on the CPU.

The JAX side runs on the 8 host devices that ``tests/conftest.py`` forces;
the port's meshes are shards on the CPU.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.models import layers as jax_layers
from omnilingual_asr_tpu.ops.quant import quantize_param_tree as jax_quantize
from omnilingual_asr_tpu.ops.quant import quantize_spec_tree as jax_qspecs
from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build
from omnilingual_asr_tpu.parallel.mesh import shard_params as jax_shard
from omnilingual_asr_torch.config import MeshConfig, tiny_config
from omnilingual_asr_torch.models import conformer, layers, zoo
from omnilingual_asr_torch.ops import conv_module as cm
from omnilingual_asr_torch.ops.card_cases import K3_SPLIT_SHAPES, TOL_K3
from omnilingual_asr_torch.ops.quant import quantize_spec_tree
from omnilingual_asr_torch.parallel import mesh as pm
from omnilingual_asr_torch.parallel import tensor as tp

torch.set_num_threads(2)

CPU = torch.device("cpu")
# Whole models against each other (bf16 dense layers): test_torch_model.py's
# REL_MODEL for the port against JAX. The port's TP forward against its own
# unsharded one differs only in the f32 order of the sums over the shards,
# which moves each layer by ~1e-6 of its update (test_tp_layers_*), but a
# moved f32 value rounds to the other bf16 neighbour at the next dense
# layer's input now and then, and those flips carry through the model:
# 8e-5 to 2e-3 of max|ref| measured on tiny configs, under REL_TP.
REL_MODEL = 3e-2
REL_TP = 1e-2
# One layer against its unsharded twin, relative to the layer's update:
# the FFN and attention differ only in the f32 order of the sum over the
# shards; the conv module also merges the second LayerNorm's statistics,
# and a moved statistic can flip the bf16 rounding of one pw2 input,
# moving an output by 2^-8 of one product term.
REL_LAYER = 1e-5
REL_LAYER_CONV = 1e-3


def _cfg(heads: int, flash: bool = False, fused: bool = False):
    """tiny_config() (d 128, 2 layers, conv kernel 8) with ``heads`` heads,
    both packages'."""
    enc = dict(n_heads=heads, use_flash_attention=flash,
               use_fused_conv=fused)
    j = jax_tiny_config()
    t = tiny_config()
    return (j.replace(encoder=dataclasses.replace(j.encoder, **enc)),
            t.replace(encoder=dataclasses.replace(t.encoder, **enc)))


def _mel(B, T, valid, seed=0):
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    return mel, mask


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _grid(params, specs, mesh):
    """Each data row's model shards' trees."""
    return [tp.shard_trees(params, specs, list(row)) for row in mesh.devices]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_placement_equals_jax_shards(shape, quantized):
    """Each port shard of every leaf equals the JAX shard on the matching
    mesh device, but for pw1 (each GLU half split: the shards reassemble
    to the whole weight) and the CTC head (replicated)."""
    data, model = shape
    jcfg = jax_tiny_config().replace(mesh=JaxMeshConfig(data=data,
                                                        model=model))
    jp = jax_conformer.asr_init(jax.random.PRNGKey(0), jcfg)
    jspecs = jax_conformer.asr_param_specs(jcfg)
    tspecs = conformer.asr_param_specs(tiny_config())
    if quantized:
        jp, jspecs = jax_quantize(jp), jax_qspecs(jspecs)
        tspecs = quantize_spec_tree(tspecs)
    jmesh = jax_build(jcfg.mesh)
    placed = jax_shard(jp, jspecs, jmesh)
    host = jax.tree.map(np.asarray, jp)
    pos = {d.id: idx for idx, d in np.ndenumerate(jmesh.devices)}
    tmesh = pm.build_mesh(MeshConfig(data=data, model=model), [CPU] * 8)
    grid = _grid(host, tspecs, tmesh)
    assert len(grid) == data and all(len(r) == model for r in grid)
    n_checked = 0
    for path, leaf in _leaves(placed):
        name = "/".join(map(str, path))
        full = np.asarray(_at(host, path))
        for sh in leaf.addressable_shards:
            r, m = pos[sh.device.id]
            got = _at(grid[r][m], path).numpy()
            if "pw1" in path:
                continue
            if path[0] == "ctc_head":
                np.testing.assert_array_equal(got, full, err_msg=name)
                continue
            np.testing.assert_array_equal(got, np.asarray(sh.data),
                                          err_msg=name)
            n_checked += 1
        if "pw1" in path:
            # value halves then gate halves, shard by shard
            d = full.shape[-1] // 2
            parts = [_at(grid[0][m], path).numpy() for m in range(model)]
            if full.ndim == 2:
                value = np.concatenate([p[:, :d // model] for p in parts], 1)
                gate = np.concatenate([p[:, d // model:] for p in parts], 1)
                np.testing.assert_array_equal(
                    np.concatenate([value, gate], 1), full)
            else:
                value = np.concatenate([p[:d // model] for p in parts])
                gate = np.concatenate([p[d // model:] for p in parts])
                np.testing.assert_array_equal(np.concatenate([value, gate]),
                                              full)
    assert n_checked > 8 * 20


def test_shard_params_takes_a_dimension_and_glu_halves():
    mesh = pm.build_mesh(MeshConfig(data=2, model=2), [CPU] * 4)
    w = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    cols = pm.shard_params(w, (None, "model"), mesh)
    assert [c.tolist() for c in cols] == [w[:, :4].tolist(),
                                          w[:, 4:].tolist()]
    rows = pm.shard_params(w, pm.Split("model", 0), mesh)
    assert torch.equal(torch.cat(rows), w)
    glu = pm.shard_params(w, pm.Split("model", 1, halves=2), mesh)
    assert glu[0].tolist() == torch.cat([w[:, 0:2], w[:, 4:6]], 1).tolist()
    assert glu[1].tolist() == torch.cat([w[:, 2:4], w[:, 6:8]], 1).tolist()
    assert pm.as_split((None, None)) is None
    with pytest.raises(ValueError, match="more than one"):
        pm.as_split(("data", "model"))
    with pytest.raises(ValueError, match="halves"):
        pm.split_block(torch.zeros(4, 6), pm.Split("model", 1, 2), 0, 2)


def test_collectives_over_one_axis_of_the_mesh():
    """psum and all_gather over the model axis within each data row (and
    over the data axis within each model column); no input written."""
    mesh = pm.build_mesh(MeshConfig(data=2, model=3), [CPU] * 6)
    xs = [torch.full((2,), float(i)) for i in range(6)]
    before = [x.clone() for x in xs]
    got = pm.psum(xs, mesh, "model")
    assert [float(g[0]) for g in got] == [3.0] * 3 + [12.0] * 3
    got = pm.psum(xs, mesh, "data")
    assert [float(g[0]) for g in got] == [3.0, 5.0, 7.0] * 2
    gat = pm.all_gather(xs, 0, mesh, "model")
    assert gat[0].tolist() == [0, 0, 1, 1, 2, 2]
    assert gat[4].tolist() == [3, 3, 4, 4, 5, 5]
    assert gat[0] is gat[1]                 # one device: one result
    assert pm.all_gather(xs[:2], 0)[1].tolist() == [0, 0, 1, 1]
    for x, b in zip(xs, before):
        assert torch.equal(x, b)
    with pytest.raises(ValueError, match="6 devices"):
        pm.psum(xs[:4], mesh, "model")


def test_quantize_spec_tree_matches_jax():
    """w_q takes w's spec; w_scale the output columns' split (each GLU
    half's for pw1) or none, as the reference's quantize_spec_tree."""
    specs = quantize_spec_tree(conformer.asr_param_specs(tiny_config()))
    jspecs = jax_qspecs(jax_conformer.asr_param_specs(jax_tiny_config()))
    blk, jblk = specs["blocks"][0], jspecs["blocks"][0]
    for path in (("ffn1", "w1"), ("ffn1", "w2"), ("mhsa", "wq"),
                 ("mhsa", "wo"), ("conv", "pw2")):
        t, j = _at(blk, path), _at(jblk, path)
        assert pm.as_split(t["w_q"]) == pm.as_split(tuple(j["w_q"]))
        assert pm.as_split(t["w_scale"]) == pm.as_split(tuple(j["w_scale"]))
    assert blk["conv"]["pw1"]["w_scale"] == pm.Split("model", 0, 2)
    assert specs["lid_head"]["w_scale"] == pm.Split("model", 0)
    assert specs["ctc_head"]["w_scale"] is None


def test_indivisible_model_axis_raises():
    cfg = tiny_config()                          # 2 heads
    params = conformer.asr_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="n_heads"):
        conformer.shard_for_tp(params, cfg, [CPU] * 4)
    shards = conformer.shard_for_tp(params, cfg, [CPU] * 2)
    mel = torch.zeros(1, 64, 128)
    mask = torch.ones(1, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="n_heads"):
        conformer.tp_asr_forward(shards * 2, mel, mask, cfg)


# ---------------------------------------------------------------------------
# Layers and the split conv module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_tp_layers_equal_unsharded_but_for_f32_order(n):
    """The TP FFN, attention (plain and the flash twin) and conv module
    (plain, and the split conv on its plain steps) against the unsharded
    layers on the same block, relative to each layer's update."""
    _, cfg = _cfg(heads=4)
    p = conformer.asr_init(torch.Generator().manual_seed(3), cfg)
    blk = p["blocks"][0]
    bs = [s["blocks"][0] for s in conformer.shard_for_tp(p, cfg, [CPU] * n)]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 64, 128, generator=gen)
    mask = torch.arange(64)[None] < torch.tensor([64, 30])[:, None]
    cos, sin = layers.rope_angles(64, 32)
    xs, masks = [x] * n, [mask] * n
    cases = {
        "ffn": (tp.tp_ffn_apply([b["ffn1"] for b in bs], xs),
                layers.ffn_apply(blk["ffn1"], x)),
        "mhsa": (tp.tp_mhsa_apply([b["mhsa"] for b in bs], xs, 4, masks,
                                  [cos] * n, [sin] * n),
                 layers.mhsa_apply(blk["mhsa"], x, 4, mask, cos, sin)),
        "flash": (tp.tp_mhsa_apply([b["mhsa"] for b in bs], xs, 4, masks,
                                   [cos] * n, [sin] * n, use_flash=True),
                  layers.mhsa_apply(blk["mhsa"], x, 4, mask, cos, sin,
                                    use_flash=True)),
        "conv": (tp.tp_convmod_apply([b["conv"] for b in bs], xs, masks),
                 layers.convmod_apply(blk["conv"], x, mask)),
        "conv_split": (cm.tp_convmod_apply_fused(
            [b["conv"] for b in bs], xs, masks),
            cm.convmod_apply_fused(blk["conv"], x, mask)),
    }
    for name, (got, want) in cases.items():
        assert all(g is got[0] for g in got), name    # one shared result
        err = float((got[0] - want).abs().max() / (want - x).abs().max())
        tol = REL_LAYER_CONV if name.startswith("conv") else REL_LAYER
        assert err <= tol, f"{name}: {err:.3e}"


@pytest.mark.parametrize("n", [2, 4])
def test_split_conv_plain_matches_whole_and_jax(n):
    """The plain split at n shards against ``conv_module_plain`` on the
    whole weights and against JAX ``convmod_apply`` (masked rows), within
    TOL_K3; each shard's own statistics merge to the whole frame's."""
    jcfg, cfg = _cfg(heads=4)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(5), jcfg)
    p = zoo.params_from_jax(jp)
    conv = p["blocks"][0]["conv"]
    shards = conformer.shard_for_tp(p, cfg, [CPU] * n)
    convs = [s["blocks"][0]["conv"] for s in shards]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 96, 128)).astype(np.float32)
    mask = np.arange(96)[None] < np.asarray([96, 40, 0])[:, None]
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = cm.conv_module_split_plain(
        [xt] * n, [mt] * n, [c["ln"]["scale"] for c in convs],
        [c["ln"]["bias"] for c in convs], [c["pw1"]["w"] for c in convs],
        [c["dw"] for c in convs], [c["dw_ln"]["scale"] for c in convs],
        [c["dw_ln"]["bias"] for c in convs], [c["pw2"]["w"] for c in convs])
    whole = cm.conv_module_plain(xt, mt, conv["ln"]["scale"],
                                 conv["ln"]["bias"], conv["pw1"]["w"],
                                 conv["dw"], conv["dw_ln"]["scale"],
                                 conv["dw_ln"]["bias"], conv["pw2"]["w"])
    want = jax_layers.convmod_apply(jp["blocks"][0]["conv"], jnp.asarray(x),
                                    jnp.asarray(mask))
    assert float((got[0] - whole).abs().max()) <= TOL_K3
    assert float(np.abs(got[0].numpy() - np.asarray(want)).max()) <= TOL_K3
    # (i)'s statistics, merged over the shards, are the whole frame's.
    cs, stats = zip(*[cm.split_stage1_plain(
        xt, mt, c["ln"]["scale"], c["ln"]["bias"], c["pw1"]["w"], c["dw"])
        for c in convs])
    merged = cm.merge_moments(torch.stack(stats, dim=-2), 128 // n)
    np.testing.assert_allclose(merged.numpy(),
                               cm.moments(torch.cat(cs, -1)).numpy(),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

CASES = {"2x2": (2, 2, 2), "1x4": (1, 4, 4)}   # data, model, heads


@pytest.mark.parametrize("flags", ["stored", "inference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_forward_matches_unsharded(case, flags):
    """tp_asr_forward over each data row's model shards against the
    port's unsharded forward on the whole batch: plain attention and conv
    ("stored"), and the flash twin with the split conv module
    ("inference", the engine's flags; the twins of K2 and the split K3 on
    the CPU)."""
    data, model, heads = CASES[case]
    fl = flags == "inference"
    _, cfg = _cfg(heads, flash=fl, fused=fl)
    p = conformer.asr_init(torch.Generator().manual_seed(7), cfg)
    mel, mask = _mel(4, 1024, [1024, 601, 300, 0])
    mel, mask = torch.from_numpy(mel), torch.from_numpy(mask)
    mesh = pm.build_mesh(MeshConfig(data=data, model=model),
                         [CPU] * (data * model))
    grid = _grid(p, conformer.asr_param_specs(cfg), mesh)
    with torch.inference_mode():
        want = conformer.asr_forward(p, mel, mask, cfg)
        rows = [conformer.tp_asr_forward(
            grid[r], mel[r * 4 // data:(r + 1) * 4 // data],
            mask[r * 4 // data:(r + 1) * 4 // data], cfg)
            for r in range(data)]
    got = {k: torch.cat([o[k] for o in rows]) for k in rows[0]
           if k != "moe_aux"}
    assert torch.equal(got["mask"], want["mask"])
    for key in ("ctc_logits", "lid_logits", "emotion_logits",
                "speaker_frames", "encoder_states"):
        err = _rel(got[key], want[key])
        assert err <= REL_TP, f"{key}: {err:.3e}"


@pytest.mark.parametrize("flags", ["stored", "inference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_forward_matches_jax_sharded(case, flags):
    """The port's TP forward against jitted JAX asr_forward on the same
    tree sharded over the same (data, model) mesh of host devices (GSPMD,
    as tests/test_sharding.py::TestTPEquivalence builds it; the Pallas
    kernels in interpret mode under "inference"), within REL_MODEL."""
    data, model, heads = CASES[case]
    fl = flags == "inference"
    jcfg, cfg = _cfg(heads, flash=fl, fused=fl)
    jcfg = jcfg.replace(mesh=JaxMeshConfig(data=data, model=model))
    jp = jax_conformer.asr_init(jax.random.PRNGKey(8), jcfg)
    jmesh = jax_build(jcfg.mesh, devices=jax.devices()[:data * model])
    sharded = jax_shard(jp, jax_conformer.asr_param_specs(jcfg), jmesh)
    mel, mask = _mel(2 * data, 1024, [1024, 601, 300, 0][:2 * data])
    fwd = jax.jit(lambda pr, m, k: jax_conformer.asr_forward(
        pr, m, k, jcfg, flash_interpret=True))
    want = fwd(sharded, jnp.asarray(mel), jnp.asarray(mask))
    host = jax.tree.map(np.asarray, jp)
    mesh = pm.build_mesh(MeshConfig(data=data, model=model),
                         [CPU] * (data * model))
    grid = _grid(host, conformer.asr_param_specs(cfg), mesh)
    mt, kt = torch.from_numpy(mel), torch.from_numpy(mask)
    with torch.inference_mode():
        rows = [conformer.tp_asr_forward(grid[r], mt[2 * r:2 * r + 2],
                                         kt[2 * r:2 * r + 2], cfg)
                for r in range(data)]
    for key in ("ctc_logits", "lid_logits", "emotion_logits",
                "speaker_frames", "encoder_states"):
        got = torch.cat([o[key] for o in rows]).numpy()
        err = _rel(got, np.asarray(want[key]))
        assert err <= REL_MODEL, f"{key}: {err:.3e}"


def test_tp_moe_dense_and_alltoall_equal_unsharded():
    """A mixture-of-experts encoder under TP: the experts split over the
    shards, dense dispatch (partial combines summed) and the all-to-all
    dispatch inside the block (capacity where nothing drops), against the
    unsharded dense forward; moe_aux equal under dense dispatch."""
    _, cfg = _cfg(heads=2)
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, n_experts=4, moe_capacity_factor=16.0))
    p = conformer.asr_init(torch.Generator().manual_seed(9), cfg)
    mel, mask = _mel(2, 256, [256, 200])
    mel, mask = torch.from_numpy(mel), torch.from_numpy(mask)
    shards = conformer.shard_for_tp(p, cfg, [CPU] * 2)
    assert shards[0]["blocks"][0]["ffn2"]["w1"].shape[0] == 2
    with torch.inference_mode():
        want = conformer.asr_forward(p, mel, mask, cfg)
        dense = conformer.tp_asr_forward(shards, mel, mask, cfg)
        a2a = conformer.tp_asr_forward(shards, mel, mask, cfg.replace(
            encoder=dataclasses.replace(cfg.encoder,
                                        moe_dispatch="alltoall")))
    assert abs(float(dense["moe_aux"]) - float(want["moe_aux"])) <= 1e-4
    assert float(a2a["moe_aux"]) == 0.0
    for got in (dense, a2a):
        err = _rel(got["ctc_logits"], want["ctc_logits"])
        assert err <= REL_TP, f"{err:.3e}"


@pytest.mark.parametrize("name", sorted(K3_SPLIT_SHAPES))
def test_k3_split_card_case_is_a_shape_the_kernel_takes(name):
    """chip_smoke.py's split-K3 cases: D / n a multiple of the kernel's 64
    channels, D within its limit, a valid count a row."""
    B, T, D, n, valid = K3_SPLIT_SHAPES[name]
    assert len(valid) == B and all(0 <= v <= T for v in valid)
    assert D % n == 0 and (D // n) % 64 == 0 and D <= cm.KERNEL_MAX_D
