"""PyTorch port: training over a (data, model) mesh (``train/mesh_step.py``,
``parallel.tensor.MeshParams``, the differentiable tensor-parallel layers,
``ops.conv_module.FusedConvModuleSplit``, the translator's split) held to
the port's one-device step and to the JAX package's GSPMD steps.

``tiny_config`` with 4 heads in both packages, so that a model axis of 4
divides the heads. The port's meshes are shards on the CPU; JAX's are the
8 host devices that ``tests/conftest.py`` forces. The batch's rows differ
in valid frames and in label counts, and one row cannot be aligned, so a
mean of per-row means would differ from the global loss.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.models import translation as jax_translation
from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build
from omnilingual_asr_tpu.parallel.mesh import shard_params as jax_shard
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.config import MeshConfig, tiny_config
from omnilingual_asr_torch.models import conformer, layers, zoo
from omnilingual_asr_torch.parallel import mesh as pm
from omnilingual_asr_torch.parallel.tensor import MeshParams
from omnilingual_asr_torch.train import mesh_step, step, synth_train
from omnilingual_asr_torch.train.augment import SpecAugmentConfig

torch.set_num_threads(2)

CPU = torch.device("cpu")
B, T, L, LT = 8, 128, 10, 12
# Valid frames and label counts a row: row 5 has 16 frames (4 subsampled)
# for 9 labels, so it cannot be aligned.
VALID = [128, 100, 64, 128, 40, 16, 128, 90]
N_LABELS = [10, 3, 7, 10, 0, 9, 10, 5]
SCALARS = {"w_spk": 0.7, "w_trans": 0.5, "w_aug": 1.0, "w_fce": 0.3,
           "w_ctc": 0.9}
AUG = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16, n_time_masks=1,
                        time_mask_width=24)
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
MESHES = [(8, 1), (4, 2), (2, 4)]


def _cfgs(fused: bool = False, dropout: float = 0.0):
    """tiny_config() with 4 heads, both packages'; the port's with the
    kernel flags (their plain twins on the CPU) and dropout."""
    j = jax_tiny_config()
    j = j.replace(encoder=dataclasses.replace(j.encoder, n_heads=4))
    t = tiny_config()
    t = t.replace(encoder=dataclasses.replace(
        t.encoder, n_heads=4, use_flash_attention=fused,
        use_fused_conv=fused, dropout=dropout))
    return j, t


def _host_batch(seed: int = 0, translator: bool = True):
    rng = np.random.default_rng(seed)
    Tp = T // 4
    b = {"mel": (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(
             np.float32),
         "mask": np.arange(T)[None] < np.asarray(VALID)[:, None],
         "labels": rng.integers(1, 257, (B, L)).astype(np.int32),
         "label_mask": np.arange(L)[None] < np.asarray(N_LABELS)[:, None],
         "lid_label": rng.integers(0, 2048, B).astype(np.int32),
         "emotion_label": rng.integers(0, 4, B).astype(np.int32),
         "speaker_label": rng.integers(0, 1024, B).astype(np.int32),
         "lid_frame_label": rng.integers(-1, 40, (B, Tp)).astype(np.int32),
         "char_frame_label": rng.integers(-1, 257, (B, Tp)).astype(
             np.int32)}
    b["char_frame_label"][b["char_frame_label"] == 0] = -1
    if translator:
        b["trans_in"] = rng.integers(0, 257, (B, LT)).astype(np.int32)
        b["trans_tgt"] = rng.integers(0, 257, (B, LT)).astype(np.int32)
        b["trans_mask"] = np.arange(LT)[None] < rng.integers(
            1, LT + 1, B)[:, None]
    return b


def _port_batch(b, cfg):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out.update(SCALARS)
    out[step.CTC_INFEASIBLE] = step.ctc_rows(b, cfg)
    return out


@pytest.fixture(scope="module")
def jinit():
    """The JAX init (4 heads) with the translator, as numpy."""
    j, _ = _cfgs()
    p = {"asr": jax_conformer.asr_init(jax.random.PRNGKey(0), j),
         "translator": jax_translation.translator_init(
             jax.random.PRNGKey(1), j)}
    return jax.tree.map(np.asarray, p)


def _mesh(shape):
    data, model = shape
    return pm.build_mesh(MeshConfig(data=data, model=model),
                         [CPU] * (data * model))


def _rel_errs(got, want):
    out = []
    for a, b in zip(got, want):
        nb = float(b.norm())
        d = float((a - b).norm())
        out.append(d / nb if nb > 0 else d)
    return out


def _one_device(cfg, params, batch, n_steps=0, augment=None,
                dropout=False):
    """The one-device step from ``params``: (loss, grads, clipped grads,
    [parameter changes after each of n_steps steps])."""
    tx = step.make_optimizer(**OPT)
    _, tstep, lg = step.make_train_step(cfg, CPU, tx=tx, augment=augment,
                                        with_translator=True,
                                        dropout=dropout)
    p = step.trainable(zoo.params_from_jax(params), CPU)
    leaves = step.tree_leaves(p)
    m, g = lg(p, batch, 3)
    g = [torch.zeros_like(x) if a is None else a for a, x in zip(g, leaves)]
    clipped = tx.clip_and_zero_nans(g)
    p0 = [x.detach().clone() for x in leaves]
    opt = tx.init(p)
    moves = []
    for i in range(n_steps):
        tstep(p, opt, batch, i)
        moves.append([x.detach() - a for x, a in zip(step.tree_leaves(p),
                                                     p0)])
    return float(m["loss"]), g, clipped, moves


def _mesh_run(cfg, params, batch, shape, n_steps=0, augment=None,
              dropout=False, copy_per_shard=False):
    tx = step.make_optimizer(**OPT)
    init, mstep, lg = step.make_train_step(cfg, _mesh(shape), tx=tx,
                                           augment=augment,
                                           with_translator=True,
                                           dropout=dropout)
    mp = init.place(params, copy_per_shard)
    m, g = lg(mp, batch, 3)
    clipped = mp.merge(tx.clip_and_zero_nans(g, mp.counted(g)))
    p0 = mp.merge([x.detach().clone() for x in mp.leaves])
    opt = tx.init(mp.leaves)
    moves = []
    for i in range(n_steps):
        mstep(mp, opt, batch, i)
        moves.append([x - a for x, a in zip(mp.merge(
            [x.detach() for x in mp.leaves]), p0)])
    return float(m["loss"]), mp.merge(g), clipped, moves, mp


def _mismatches(one, mesh, grad_tol):
    """test_mesh_step_equals_one_device's criterion: the loss within
    MESH_LOSS_REL, the gradients and the clipped gradients (what AdamW
    takes) per leaf within ``grad_tol`` relative L2. Returns what failed."""
    bad = []
    rel = abs(mesh[0] - one[0]) / abs(one[0])
    if rel > testing.MESH_LOSS_REL:
        bad.append(f"loss {rel:.3e}")
    for name, a, b in (("grads", mesh[1], one[1]),
                       ("clipped", mesh[2], one[2])):
        worst = max(_rel_errs(a, b))
        if worst > grad_tol:
            bad.append(f"{name} {worst:.3e}")
    return bad


def _moves_agree(got_moves, want_moves, lr, leaf_share=1e-3):
    """test_three_train_steps_match_jax's criterion on each step's
    parameter changes: per leaf relative L2 <= 1e-1 and at most
    ``leaf_share`` of the elements more than lr / 2 apart, where a leaf of
    fewer than 1 / leaf_share elements may have one (an element whose
    Adam move is decided by a gradient near zero goes the other way when
    bf16 moves that gradient: measured, one of a translator FFN bias's 128
    at (4, 2)); over all leaves at most 1e-3 of the elements."""
    for i, (got, want) in enumerate(zip(got_moves, want_moves)):
        flipped_all = n_all = 0
        for k, (a, b) in enumerate(zip(got, want)):
            nb = float(b.norm())
            err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
            assert err <= 1e-1, (i, k, err)
            flipped = int(((a - b).abs() > lr / 2).sum())
            assert flipped <= max(1, leaf_share * a.numel()), (i, k, flipped)
            flipped_all += flipped
            n_all += a.numel()
        assert flipped_all <= 1e-3 * n_all, (i, flipped_all, n_all)


# ---------------------------------------------------------------------------
# 1. The mesh step against the port's one-device step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device(jinit):
    """The one-device step with the kernel flags, SpecAugment and dropout
    on, and its three steps."""
    _, cfg = _cfgs(fused=True, dropout=0.1)
    batch = _port_batch(_host_batch(), cfg)
    return cfg, batch, _one_device(cfg, jinit, batch, 3, AUG, True)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_equals_one_device(shape, jinit, one_device):
    """``make_train_step`` over the mesh (the translator, SpecAugment and
    dropout on, the kernel flags on: the twins of K2/K6/K7 on each shard's
    heads and ``FusedConvModuleSplit``) against the same step on one
    device from the same parameters: the loss within MESH_LOSS_REL, each
    leaf's gradient and clipped gradient within MESH_GRAD_REL, and after
    three steps test_three_train_steps_match_jax's criterion."""
    cfg, batch, one = one_device
    mesh = _mesh_run(cfg, jinit, batch, shape, 3, AUG, True)
    assert not _mismatches(one, mesh, testing.MESH_GRAD_REL)
    _moves_agree(mesh[3], one[3], OPT["lr"])


def _f32_case(jinit, monkeypatch):
    """The plain layers with bf16 rounding taken out (``layers.round_to``
    the identity, for this test only): one device's step."""
    monkeypatch.setattr(layers, "round_to",
                        lambda x, dtype: x.to(torch.float32))
    _, cfg = _cfgs(dropout=0.1)
    batch = _port_batch(_host_batch(1), cfg)
    return cfg, batch, _one_device(cfg, jinit, batch, dropout=True)


@pytest.mark.parametrize("shape", MESHES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_equals_one_device_in_f32(shape, jinit, monkeypatch):
    """Where the gradients differ: with the matmul operands' bf16 rounding
    taken out, the mesh's gradients equal one device's up to the f32
    order of sums (MESH_F32_GRAD_REL). With it, each data row's and model
    shard's dense call rounds its own partial of a weight's gradient to
    bf16 before the partials are summed, where one device rounds the sum
    once: ~2^-8 of a leaf, the gap MESH_GRAD_REL allows."""
    cfg, batch, one = _f32_case(jinit, monkeypatch)
    mesh = _mesh_run(cfg, jinit, batch, shape, dropout=True)
    assert not _mismatches(one, mesh, testing.MESH_F32_GRAD_REL)


def _row_batch(batch, r, data):
    """Data row r's block of a global batch (tensors with the batch's rows
    cut; the ramp scalars and the host's unalignable rows dropped)."""
    lo, hi = r * B // data, (r + 1) * B // data
    return {k: (v[lo:hi] if isinstance(v, torch.Tensor) and v.dim() > 0
                and v.shape[0] == B else v) for k, v in batch.items()
            if k != step.CTC_INFEASIBLE}


def _per_row_means(p0, batch, cfg, rows, part=(0, 1)):
    """A planted fault: each row's own loss, averaged over the rows."""
    total, metrics = 0.0, {}
    for r, o in enumerate(rows):
        out = {k: o[k] for k in mesh_step._OUT_KEYS + ("trans_logits",)}
        out["moe_aux"] = torch.zeros(())
        b = _row_batch(batch, r, len(rows))
        t, metrics = step.loss_fn(p0, b, cfg, out=out)
        total = total + t / len(rows)
    return total, dict(metrics, loss=total)


def _norm_per_shard(self, grads):
    """A planted fault: a replicated leaf counted once a mesh shard."""
    n = self.mesh.size
    return [grads[idx[0]] for blocks in self.blocks for idx in blocks
            for _ in range(n if len(blocks) == 1 else 1)]


def _dropout_per_row(shape, enc, seed, device, firsts):
    """A planted fault: each row draws its own masks over its rows."""
    rows = shape[0] // len(firsts)
    return [[conformer.dropout_mask((rows,) + tuple(shape[1:]), enc.dropout,
                                    seed, salt, d)
             for salt in range(enc.n_layers + 1)] for d in firsts]


@pytest.mark.parametrize("fault", ["per_row_means", "norm_per_shard",
                                   "dropout_per_row"])
def test_planted_fault_misses(fault, jinit, monkeypatch):
    """Each planted fault fails the comparison with one device at (4, 2):
    per-row means averaged in place of the global loss, the global norm
    counting a replicated leaf once a shard, dropout masks drawn per
    row."""
    target = {"per_row_means": (mesh_step, "global_loss", _per_row_means),
              "norm_per_shard": (MeshParams, "counted", _norm_per_shard),
              "dropout_per_row": (conformer, "row_dropout_masks",
                                  _dropout_per_row)}[fault]
    cfg, batch, one = _f32_case(jinit, monkeypatch)
    monkeypatch.setattr(*target)
    mesh = _mesh_run(cfg, jinit, batch, (4, 2), dropout=True)
    assert _mismatches(one, mesh, testing.MESH_F32_GRAD_REL)


def test_reduction_over_copies(jinit):
    """Shard trees whose every block has a copy of its own a mesh position
    (``copy_per_shard``: what distinct cards hold), at (2, 2): each copy
    gets a partial gradient and ``MeshParams.reduce`` sums them; the summed
    gradients, the clip and one update equal the shared-copy run's (1e-5
    relative: the same terms summed in another order), and every copy of
    a block holds the same values after the update."""
    _, cfg = _cfgs(dropout=0.1)
    batch = _port_batch(_host_batch(2), cfg)
    shared = _mesh_run(cfg, jinit, batch, (2, 2), 1, dropout=True)
    own = _mesh_run(cfg, jinit, batch, (2, 2), 1, dropout=True,
                    copy_per_shard=True)
    mp = own[4]
    assert len(mp.leaves) > len(shared[4].leaves)
    assert any(len(idx) == 4 for b in mp.blocks for idx in b)
    assert abs(own[0] - shared[0]) <= 1e-6 * abs(shared[0])
    for got, want in ((own[1], shared[1]), (own[2], shared[2]),
                      (own[3][0], shared[3][0])):
        assert max(_rel_errs(got, want)) <= 1e-5
    for blocks in mp.blocks:
        for idx in blocks:
            for i in idx[1:]:
                assert torch.equal(mp.leaves[i], mp.leaves[idx[0]])


# ---------------------------------------------------------------------------
# 2. Against JAX's GSPMD steps
# ---------------------------------------------------------------------------

def _jax_mesh(jcfg, shape):
    data, model = shape
    jcfg = jcfg.replace(mesh=JaxMeshConfig(data=data, model=model))
    return jcfg, jax_build(jcfg.mesh, devices=jax.devices()[:data * model])


def _jax_batch(b, jmesh):
    out = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        jmesh, jax_step._BATCH_KEY_SPECS[k])) for k, v in b.items()}
    out.update({k: jnp.float32(v) for k, v in SCALARS.items()})
    return out


@pytest.mark.parametrize("shape,translator", [((4, 2), False),
                                              ((2, 4), False)],
                         ids=["4x2", "2x4"])
def test_mesh_gradients_match_jax_gspmd(shape, translator, jinit):
    """The port's mesh gradients against ``jax.value_and_grad(loss_fn)``
    jitted over the same mesh with the reference's shardings (GSPMD),
    from the same parameters: the loss within TRAINER_LOSS_REL, each
    leaf's gradient within TRAINER_GRAD_REL (bf16 operands rounded from
    f32 sums in other orders, as test_loss_grads_match_jax)."""
    j, cfg = _cfgs()
    jcfg, jmesh = _jax_mesh(j, shape)
    hb = _host_batch(3, translator)
    params = jinit if translator else {"asr": jinit["asr"]}
    specs = {"asr": jax_conformer.asr_param_specs(jcfg)}
    if translator:
        specs["translator"] = jax_translation.translator_specs()
    placed = jax_shard(params, specs, jmesh)

    def loss(p, b):
        return jax_step.loss_fn(p["asr"], b, jcfg,
                                trans_params=p.get("translator"))

    (want, _), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        placed, _jax_batch(hb, jmesh))
    jleaves = [torch.from_numpy(np.array(x)) for x in
               step.tree_leaves(jax.tree.map(np.asarray, jg))]
    tx = step.make_optimizer(**OPT)
    if translator:
        init, _, lg = step.make_train_step(cfg, _mesh(shape), tx=tx,
                                           with_translator=True)
    else:
        init, _, lg = step.make_train_step(cfg, _mesh(shape), tx=tx)
        params = params["asr"]
    mp = init.place(params)
    m, g = lg(mp, _port_batch(hb, cfg), 0)
    got = float(m["loss"])
    assert abs(got - float(want)) <= testing.TRAINER_LOSS_REL * abs(
        float(want))
    errs = _rel_errs(mp.merge(g), jleaves)
    assert max(errs) <= testing.TRAINER_GRAD_REL, max(errs)


# ---------------------------------------------------------------------------
# 3. A mixture of experts over the mesh
# ---------------------------------------------------------------------------

N_EXPERTS = 4
MOE_MESHES = [(2, 1), (1, 2), (2, 2)]


def _moe_cfgs(fused: bool = True, dtype: str = "bfloat16"):
    """_cfgs() with 4 experts in each block's second FFN (and ``dtype``)."""
    j, t = _cfgs(fused)
    j = j.replace(encoder=dataclasses.replace(
        j.encoder, n_experts=N_EXPERTS, dtype=dtype))
    t = t.replace(encoder=dataclasses.replace(
        t.encoder, n_experts=N_EXPERTS, dtype=dtype))
    return j, t


@pytest.fixture(scope="module")
def moe_init():
    """The JAX init of the MoE tree (4 heads, 4 experts) with the
    translator, as numpy."""
    j, _ = _moe_cfgs()
    p = {"asr": jax_conformer.asr_init(jax.random.PRNGKey(5), j),
         "translator": jax_translation.translator_init(
             jax.random.PRNGKey(6), j)}
    return jax.tree.map(np.asarray, p)


def _moe_grads(cfg, params, batch, where, translator: bool = True):
    """(metrics, whole-leaf gradients) of one step's ``loss_and_grads`` on
    one device (``where`` a device) or over a mesh."""
    if not translator:
        params = params["asr"]
    init, _, lg = step.make_train_step(cfg, where,
                                       tx=step.make_optimizer(**OPT),
                                       with_translator=translator)
    if isinstance(where, pm.Mesh):
        mp = init.place(params)
        m, g = lg(mp, batch, 3)
        return m, mp.merge(g)
    p = step.trainable(zoo.params_from_jax(params), where)
    m, g = lg(p, batch, 3)
    return m, [torch.zeros_like(x) if a is None else a
               for a, x in zip(g, step.tree_leaves(p))]


@pytest.fixture(scope="module")
def moe_one_device(moe_init):
    """The one-device MoE step (kernel flags on, their plain versions)."""
    _, cfg = _moe_cfgs()
    batch = _port_batch(_host_batch(4), cfg)
    return cfg, batch, _moe_grads(cfg, moe_init, batch, CPU)


@pytest.mark.parametrize("shape", MOE_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_mesh_step_equals_one_device(shape, moe_init, moe_one_device):
    """``make_train_step`` with 4 experts over the mesh (the experts split
    by expert over the model shards, dense dispatch, the router and the
    MoE LayerNorm replicated) against the same step on one device: the
    loss within MESH_LOSS_REL, ``moe_aux`` (the load-balance term over
    every frame of the global batch, from the rows' routing sums) within
    1e-4 relative (measured under 1e-6), every leaf's gradient within
    MESH_GRAD_REL."""
    cfg, batch, (m1, g1) = moe_one_device
    m, g = _moe_grads(cfg, moe_init, batch, _mesh(shape))
    assert abs(float(m["loss"]) - float(m1["loss"])) <= \
        testing.MESH_LOSS_REL * abs(float(m1["loss"]))
    assert abs(float(m["moe_aux"]) - float(m1["moe_aux"])) <= \
        1e-4 * float(m1["moe_aux"])
    errs = _rel_errs(g, g1)
    assert max(errs) <= testing.MESH_GRAD_REL, max(errs)


def test_moe_mesh_step_equals_one_device_in_f32(moe_init):
    """The f32 encoder with experts at (2, 2) (the plain layers, no
    translator, whose decoder computes in bf16 at either encoder dtype):
    every product f32, so the gradients equal one device's up to the f32
    order of sums (MESH_F32_GRAD_REL; measured 6.7e-6), the experts' and
    the router's included, and ``moe_aux`` within 1e-6 relative. The batch
    is ``test_mesh_step_equals_one_device_in_f32``'s. (On _host_batch(5)
    the speaker leaves read 2.3e-4 at model 2 and the encoder's up to
    7e-5: the speaker projection rounds its inputs to bf16 at either
    encoder dtype, as the reference's does, and the mesh's f32 order of
    sums flips one of those roundings there;
    ``test_moe_f32_batch_5_reading_is_the_bf16_speaker_projection``.)"""
    _, cfg = _moe_cfgs(fused=False, dtype="float32")
    batch = _port_batch(_host_batch(1, translator=False), cfg)
    m1, g1 = _moe_grads(cfg, moe_init, batch, CPU, translator=False)
    m, g = _moe_grads(cfg, moe_init, batch, _mesh((2, 2)), translator=False)
    assert abs(float(m["moe_aux"]) - float(m1["moe_aux"])) <= \
        1e-6 * float(m1["moe_aux"])
    assert max(_rel_errs(g, g1)) <= testing.MESH_F32_GRAD_REL


def _f32_speaker_projection(params, frames, weights):
    """``conformer.pooled_speaker_embed`` with its projection at f32 (the
    model's rounds the pooled statistics to bf16, as the reference's)."""
    w = weights[..., None].to(torch.float32)
    denom = torch.clamp(w.sum(dim=-2), min=1e-6)
    mean = (frames * w).sum(dim=-2) / denom
    var = (w * (frames - mean[..., None, :]) ** 2).sum(dim=-2) / denom
    e = layers.dense_apply(params["spk_proj"], torch.cat(
        [mean, torch.sqrt(var + 1e-6)], dim=-1), torch.float32)
    return e * torch.rsqrt((e * e).sum(dim=-1, keepdim=True) + 1e-8)


def test_moe_f32_batch_5_reading_is_the_bf16_speaker_projection(
        moe_init, monkeypatch):
    """Why the f32 MoE mesh step reads 2.3e-4 on _host_batch(5)'s speaker
    leaves: not the mesh. On one device, the batch's rows permuted move no
    leaf by more than MESH_F32_GRAD_REL (measured 2.7e-6: the order of the
    batch's sums), but the mel times (1 + 1e-7 N(0, 1)), a change of the
    size of the mesh's own f32 order of sums, moves the speaker leaves by
    more than it (measured 2.3e-4, as the mesh): the speaker projection
    rounds the pooled statistics to bf16 (``layers.dense_apply``'s
    default, as in the reference), and the change flips one rounding.
    With that projection at f32 the (2, 2) mesh equals one device on this
    batch within MESH_F32_GRAD_REL (measured 4.9e-6)."""
    _, cfg = _moe_cfgs(fused=False, dtype="float32")
    hb = _host_batch(5, translator=False)
    batch = _port_batch(hb, cfg)
    _, g1 = _moe_grads(cfg, moe_init, batch, CPU, translator=False)
    perm = np.random.default_rng(123).permutation(B)
    _, gp = _moe_grads(cfg, moe_init, _port_batch(
        {k: v[perm] for k, v in hb.items()}, cfg), CPU, translator=False)
    assert max(_rel_errs(gp, g1)) <= testing.MESH_F32_GRAD_REL
    noise = np.random.default_rng(1).standard_normal(hb["mel"].shape)
    nudged = dict(hb, mel=(hb["mel"] * (1 + 1e-7 * noise)).astype(
        np.float32))
    _, gn = _moe_grads(cfg, moe_init, _port_batch(nudged, cfg), CPU,
                       translator=False)
    assert max(_rel_errs(gn, g1)) > testing.MESH_F32_GRAD_REL
    monkeypatch.setattr(step, "pooled_speaker_embed",
                        _f32_speaker_projection)
    _, g1 = _moe_grads(cfg, moe_init, batch, CPU, translator=False)
    _, gm = _moe_grads(cfg, moe_init, batch, _mesh((2, 2)),
                       translator=False)
    assert max(_rel_errs(gm, g1)) <= testing.MESH_F32_GRAD_REL


def test_moe_aux_is_not_a_mean_of_rows(moe_init):
    """The load-balance term is not linear in the batch: at (2, 1) the
    mean of the two rows' own terms misses the global term by more than
    the 1e-4 the mesh is held to, so the mesh comparison would catch a
    per-row aux (measured 1.2e-3 on this batch)."""
    _, cfg = _moe_cfgs(fused=False)
    batch = _port_batch(_host_batch(5), cfg)
    mp = step.make_train_step(cfg, _mesh((2, 1)), with_translator=True)[
        0].place(moe_init)
    with torch.no_grad():
        rows = mesh_step.mesh_outputs(mp, batch, cfg, True)
    whole = float(conformer.mesh_moe_aux(rows, CPU))
    mean = float(sum(o["moe_aux"] for o in rows)) / len(rows)
    assert abs(mean - whole) > 5e-4 * whole, (mean, whole)


# ---------------------------------------------------------------------------
# 4. Checkpoints, the mesh's resolution, refusals
# ---------------------------------------------------------------------------

def test_mesh_checkpoint_equals_gathered_and_serves(tmp_path):
    """``train_synth`` over a (2, 2) mesh of CPU shards for one step: the
    saved ``asr.npz`` and ``translator.npz`` equal the gathered parameters
    exactly, the train state holds one device's layout (one moment pair a
    whole leaf), the file loads back into a mesh and into the one-device
    engine, which transcribes."""
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models.translation import load_translator

    _, cfg = _cfgs()
    cfg = cfg.replace(mesh=MeshConfig(data=2, model=2))
    params, _ = synth_train.train_synth(
        steps=1, batch_size=4, cfg=cfg, window_seconds=1.0,
        ckpt_dir=str(tmp_path), log_every=1, eval_every=1, device="cpu")
    assert isinstance(params, MeshParams)
    whole = params.full()
    last = tmp_path / "last"
    got = zoo.load_checkpoint(last / "asr.npz", cfg)
    for k, v in zoo.flatten(whole["asr"]).items():
        np.testing.assert_array_equal(zoo.flatten(got)[k].numpy(),
                                      v.numpy(), err_msg=k)
    tr = load_translator(last / "translator.npz", cfg)
    for k, v in zoo.flatten(whole["translator"]).items():
        np.testing.assert_array_equal(zoo.flatten(tr)[k].numpy(),
                                      v.numpy(), err_msg=k)
    with np.load(last / "train_state.npz") as z:
        assert sum(f.startswith("m") for f in z.files) == len(
            step.tree_leaves(whole))
    again = MeshParams(whole, params.specs, params.mesh)
    opt = step.make_optimizer().init(again.leaves)
    synth_train.load_train_state(last / "train_state.npz", opt, again)
    for a, b in zip(step.tree_leaves(again.full()), step.tree_leaves(whole)):
        assert torch.equal(a, b)
    engine = TranscriptionEngine(config=cfg, params=got, device="cpu")
    res = engine.transcribe(testing.GOLDEN_WAV)
    assert res.to_dict()["segments"] is not None


def test_collectives_are_differentiable():
    """``scatter``, ``gather``, ``psum`` and ``all_gather`` carry gradients
    back to their inputs (autograd through ``to_device`` and the sums):
    each against the same function written with plain ops."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 6, generator=gen, requires_grad=True)
    w = torch.randn(4, 6, generator=gen)
    rows = pm.scatter(x, [CPU, CPU])
    parts = [r * (i + 1) for i, r in enumerate(rows)]
    out = (pm.gather(pm.psum(parts), dim=0) * w[:4]).sum() \
        + (pm.all_gather(parts, dim=1)[1] * torch.cat([w[:2], w[2:]], 1)
           ).sum()
    g, = torch.autograd.grad(out, x)
    s = x[:2] * 1 + x[2:] * 2
    ref = (torch.cat([s, s]) * w[:4]).sum() + (torch.cat(
        [x[:2], 2 * x[2:]], 1) * torch.cat([w[:2], w[2:]], 1)).sum()
    want, = torch.autograd.grad(ref, x)
    torch.testing.assert_close(g, want)


def test_training_mesh_resolution_and_refusals():
    """``training_mesh``: one shard is the one-device step (None); an
    explicit device holds every shard; a batch that does not split over
    the data rows and a model axis that does not divide the heads raise;
    a mixture of experts trains over a mesh (here at (2, 1): a finite
    loss and its load-balance term), and experts that the model axis does
    not divide raise ValueError (the reference's ``device_put`` refuses
    them too: ``tests/test_torch_mesh_train_gspmd.py``)."""
    assert mesh_step.training_mesh(MeshConfig(), "cpu") is None
    m = mesh_step.training_mesh(MeshConfig(data=-1, model=2), "cpu")
    assert m.shape == {"data": 1, "model": 2}
    assert [str(d) for d in m.devices.flat] == ["cpu", "cpu"]
    assert mesh_step.training_mesh(MeshConfig(data=2, model=2),
                                   "cpu").size == 4
    _, cfg = _cfgs()
    init, _, lg = step.make_train_step(cfg, _mesh((4, 1)))
    state = init(0)
    b = _port_batch(_host_batch(translator=False), cfg)
    b = {k: (v[:6] if isinstance(v, torch.Tensor) and v.dim() else v)
         for k, v in b.items() if k != step.CTC_INFEASIBLE}
    with pytest.raises(ValueError, match="6 rows"):
        lg(state.params, b, 0)
    with pytest.raises(ValueError, match="n_heads"):
        step.make_train_step(tiny_config(), _mesh((1, 4)))
    moe = cfg.replace(encoder=dataclasses.replace(cfg.encoder, n_experts=2))
    init, _, lg = step.make_train_step(moe, _mesh((2, 1)))
    metrics, grads = lg(init(0).params, _port_batch(
        _host_batch(translator=False), cfg), 0)
    assert np.isfinite(float(metrics["loss"]))
    assert 0.5 < float(metrics["moe_aux"]) < 2.0 * moe.encoder.n_layers
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    with pytest.raises(ValueError, match="n_experts"):
        step.make_train_step(moe, _mesh((1, 4)))


def test_train_synth_trains_experts_over_a_mesh():
    """``train_synth`` (``synth_train --mesh-data 2 --mesh-model 2``) with
    a mixture of 4 experts over a (2, 2) mesh of CPU shards: two steps,
    the experts placed a block of 2 a model shard, the router and the MoE
    LayerNorm one copy on the CPU, finite parameters after the updates."""
    _, cfg = _moe_cfgs(fused=False)
    cfg = cfg.replace(mesh=MeshConfig(data=2, model=2))
    params, _ = synth_train.train_synth(
        steps=2, batch_size=4, cfg=cfg, window_seconds=1.0, log_every=1,
        eval_every=1000, device="cpu")
    assert isinstance(params, MeshParams)
    ffn2 = params.grid[1][1]["asr"]["blocks"][0]["ffn2"]
    assert ffn2["w1"].shape[0] == N_EXPERTS // 2
    assert ffn2["router"]["w"] is params.grid[0][0]["asr"]["blocks"][0][
        "ffn2"]["router"]["w"]
    assert all(bool(torch.isfinite(x).all()) for x in params.leaves)
