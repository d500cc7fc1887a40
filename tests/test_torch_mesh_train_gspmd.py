"""PyTorch port: training over a (data, model) mesh against the JAX
package's GSPMD steps, over several steps and for the pool and pretraining
steps (``tests/test_torch_mesh_train.py`` holds the rest; the two files
split the JAX compiles, 10-25 s each on the CPU, between xdist workers).

The helpers, the batch and the criteria are ``test_torch_mesh_train``'s.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.parallel.mesh import shard_params as jax_shard
from omnilingual_asr_tpu.train import device_pool as jax_pool
from omnilingual_asr_tpu.train import pretrain as jax_pretrain
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.train import device_pool, pretrain, step, synth
from test_torch_mesh_train import (CPU, OPT, SCALARS, T, _cfgs, _host_batch,
                                   _jax_mesh, _mesh, _moves_agree,
                                   _port_batch)

torch.set_num_threads(2)


def test_three_mesh_steps_match_jax_gspmd():
    """Three ``make_train_step`` steps over a (4, 2) mesh against the
    reference's ``make_train_step`` over the same mesh (augment and dropout
    off, every batch key but the translator's), from the same parameters
    and batches: the losses within 1e-3 relative and
    test_three_train_steps_match_jax's criterion on the parameter
    changes, but for one leaf: the speaker head's weight, where 4.4e-3 of
    the elements land more than lr / 2 apart (measured; the port on one
    device against the reference on one device measures the same on these
    batches: bf16 rounding flips ReLU gates of that head, and an element
    whose gradient the flip decides takes the other Adam sign). Each leaf
    is held to 1e-2 of its elements, the whole model to 1e-3 (measured
    1.4e-4)."""
    j, cfg = _cfgs()
    jcfg, jmesh = _jax_mesh(j, (4, 2))
    batches = [_host_batch(10 + i, translator=False) for i in range(3)]
    jinit_s, jstep = jax_step.make_train_step(
        jcfg, jmesh, tx=jax_step.make_optimizer(**OPT),
        batch_keys=tuple(batches[0]) + tuple(SCALARS))
    state = jinit_s(seed=0)
    jp, jo, js = state.params, state.opt_state, state.step
    p0 = [torch.from_numpy(np.array(x)) for x in
          step.tree_leaves(jax.tree.map(np.asarray, jp))]
    tx = step.make_optimizer(**OPT)
    init, mstep, _ = step.make_train_step(cfg, _mesh((4, 2)), tx=tx)
    mp = init.place(jax.tree.map(np.asarray, jp))
    opt = tx.init(mp.leaves)
    want_moves, got_moves = [], []
    # The reference's jitted step pins its parameters' input shardings but
    # not its outputs', and at model 2 GSPMD hands a bias back split over
    # the model axis, which its next call refuses: put them back first.
    # Its optimizer state and step come back committed to the mesh, which
    # would make the second call compile the step again (10 s): they go in
    # from the host each time, as the first call takes them.
    sh = jax.tree.map(lambda sp: NamedSharding(jmesh, sp),
                      jax_conformer.asr_param_specs(jcfg),
                      is_leaf=lambda x: isinstance(x, P))
    for i, hb in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in hb.items()}
        jb.update({k: jnp.float32(v) for k, v in SCALARS.items()})
        jp, jo, js, jm = jstep(jax.device_put(jp, sh), jax.device_get(jo),
                               jb, jax.device_get(js))
        _, _, _, m = mstep(mp, opt, _port_batch(hb, cfg), i)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
            float(jm["loss"]))
        want_moves.append([torch.from_numpy(np.array(x)) - a for x, a in
                           zip(step.tree_leaves(jax.tree.map(np.asarray,
                                                             jp)), p0)])
        got_moves.append([x - a for x, a in zip(mp.merge(
            [x.detach() for x in mp.leaves]), p0)])
    _moves_agree(got_moves, want_moves, OPT["lr"], leaf_share=1e-2)


# ---------------------------------------------------------------------------
# 3. The pool step and pretraining against JAX
# ---------------------------------------------------------------------------

def _update_mismatches(got, want, before, lr):
    """One Adam update at its peak rate, from ``before``: each element
    moves by about lr * sign(g). Over all the leaves at most 2e-3 of the
    elements may land more than lr / 2 apart (an element whose gradient
    is near zero takes the other sign when bf16 moves the gradient: on a
    mesh each shard rounds its own partials, and the reference's GSPMD
    rounds at other places; measured 1.1e-3 in the pool step, 1-2 elements
    of a 128- to 512-element bias in pretraining); each leaf of at least
    1000 elements within TRAINER_PARAM_REL relative L2 of the reference's
    move. Returns what failed."""
    bad, flipped, n = [], 0, 0
    for k, (a, b, p) in enumerate(zip(got, want, before)):
        flipped += int(((a - b).abs() > lr / 2).sum())
        n += a.numel()
        if a.numel() >= 1000:
            rel = float((a - b).norm()) / max(float((b - p).norm()), 1e-30)
            if rel > testing.TRAINER_PARAM_REL:
                bad.append(f"leaf {k}: {rel:.3e}")
    if flipped > 2e-3 * n:
        bad.append(f"{flipped} of {n} elements flipped")
    return bad


def test_pool_step_over_mesh_matches_jax():
    """One pool step over a (2, 2) mesh (mu-law pool, on-device gain and
    noise, the step's indices split over the data rows) against the
    reference's ``make_pool_train_step`` over the same mesh from the same
    parameters, with its gain, SNR and noise passed in: the loss within
    TRAINER_LOSS_REL and the update by ``_update_mismatches``."""
    j, cfg = _cfgs()
    jcfg, jmesh = _jax_mesh(j, (2, 2))
    bake = synth.SynthBatcher(cfg, batch_size=4, window_seconds=1.0, seed=3,
                              n_threads=1, real_fraction=0.0,
                              codeswitch_fraction=0.0, bake_mode=True)
    try:
        it = iter(bake)
        pool_np = device_pool.build_pool(it, 8, wire="mulaw")
    finally:
        bake.close()
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    jinit_s, jstep, _ = jax_pool.make_pool_train_step(
        jcfg, jmesh, tx=jax_step.make_optimizer(**kw))
    state = jinit_s(seed=2)
    host = jax.tree.map(np.asarray, state.params)
    idx = np.array([5, 2, 2, 7])
    s = 3
    jp, _, _, jm = jstep(state.params, state.opt_state,
                         {k: jnp.asarray(v) for k, v in pool_np.items()},
                         jnp.asarray(idx, jnp.int32), jnp.int32(s),
                         {k: jnp.float32(v) for k, v in SCALARS.items()})
    key = jax.random.fold_in(jax.random.PRNGKey(17), s)
    kg, ks, kn = jax.random.split(key, 3)
    W = pool_np["samples"].shape[1]
    draws = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(kg, (4, 1), jnp.float32, 0.7, 1.3),
        jax.random.uniform(ks, (4, 1), jnp.float32, 15.0, 40.0),
        jax.random.normal(kn, (4, W), jnp.float32)))
    tx = step.make_optimizer(**kw)
    init, pstep, _, _ = device_pool.make_pool_train_step(
        cfg, _mesh((2, 2)), tx=tx)
    mp = init.place(host)
    opt = tx.init(mp.leaves)
    pool = device_pool.pool_to_device(pool_np, CPU)
    _, _, _, m = pstep(mp, opt, pool, torch.from_numpy(idx), s,
                       dict(SCALARS), draws)
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= testing.TRAINER_LOSS_REL * want
    bad = _update_mismatches(
        mp.merge([x.detach() for x in mp.leaves]),
        [torch.from_numpy(np.array(x)) for x in
         step.tree_leaves(jax.tree.map(np.asarray, jp))],
        [torch.from_numpy(np.array(x)) for x in step.tree_leaves(host)],
        kw["lr"])
    assert not bad, bad


PCFG = dict(codebook_size=512, codebook_dim=8, mask_prob=0.1, mask_span=3)


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pretrain_update_over_mesh_matches_jax(shape):
    """One ``make_pretrain_step`` update over the mesh (the head's codes
    split over the model shards, as ``pretrain_param_specs`` places them)
    against the reference's over the same mesh from the same parameters,
    quantizer and mel, fed the JAX step's span starts and noise: the loss
    within TRAINER_LOSS_REL and the update by ``_update_mismatches``."""
    j, cfg = _cfgs()
    jcfg, jmesh = _jax_mesh(j, shape)
    jp = jax_pretrain.PretrainConfig(**PCFG)
    pcfg = pretrain.PretrainConfig(**PCFG)
    jparams = jax_pretrain.pretrain_init(jax.random.PRNGKey(3), jcfg, jp)
    jq = jax_pretrain.make_quantizer(jax.random.PRNGKey(4), jcfg, jp)
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    rng = np.random.default_rng(5)
    mel = (rng.standard_normal((4, T, 128)) * 2.0 - 5.0).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, 100, 60, 16])[:, None]
    _, jstep = jax_pretrain.make_pretrain_step(
        jcfg, jmesh, jp, tx=jax_step.make_optimizer(**kw))
    host = jax.tree.map(np.asarray, jparams)
    jout, _, _, jm = jstep(
        jax_shard(jparams, jax_pretrain.pretrain_param_specs(jcfg), jmesh),
        jq, jax_step.make_optimizer(**kw).init(jparams),
        {"mel": jnp.asarray(mel), "mask": jnp.asarray(mask)}, jnp.int32(0))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    k1, k2 = jax.random.split(key)
    starts = np.array(jax.random.bernoulli(k1, jp.mask_prob, (4, T // 4)))
    noise = np.array(jax.random.normal(k2, (4, T, 128), jnp.float32))
    tx = step.make_optimizer(**kw)
    init, pstep, _ = pretrain.make_pretrain_step(cfg, _mesh(shape), pcfg,
                                                 tx=tx)
    mp = init.place(host)
    _, _, nxt, m = pstep(mp, zoo.params_from_jax(jq), tx.init(mp.leaves),
                         {"mel": torch.from_numpy(mel),
                          "mask": torch.from_numpy(mask)}, 0,
                         draws=(torch.from_numpy(starts),
                                torch.from_numpy(noise)))
    assert nxt == 1
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= testing.TRAINER_LOSS_REL * want
    bad = _update_mismatches(
        mp.merge([x.detach() for x in mp.leaves]),
        [torch.from_numpy(np.array(x)) for x in
         step.tree_leaves(jax.tree.map(np.asarray, jout))],
        [torch.from_numpy(np.array(x)) for x in step.tree_leaves(host)],
        kw["lr"])
    assert not bad, bad


# ---------------------------------------------------------------------------
# 4. A mixture of experts over the mesh against JAX
# ---------------------------------------------------------------------------

def test_moe_mesh_step_matches_jax_gspmd():
    """One ``make_train_step`` update with 4 experts over a (2, 2) mesh
    (the experts split by expert over the model shards, dense dispatch)
    against the reference's ``make_train_step`` over the same mesh (GSPMD
    with the experts placed ``P("model", ...)``), from the same parameters
    and batch: the loss, its ``moe_aux`` term included, within 1e-3
    relative, ``moe_aux`` within 1e-4 relative, and the update by
    ``_update_mismatches``. A model axis that does not divide the experts
    raises ValueError in both packages."""
    from test_torch_mesh_train import _moe_cfgs

    j, cfg = _moe_cfgs()
    jcfg, jmesh = _jax_mesh(j, (2, 2))
    hb = _host_batch(4, translator=False)
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    jinit_s, jstep = jax_step.make_train_step(
        jcfg, jmesh, tx=jax_step.make_optimizer(**kw),
        batch_keys=tuple(hb) + tuple(SCALARS))
    state = jinit_s(seed=0)
    host = jax.tree.map(np.asarray, state.params)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    jb.update({k: jnp.float32(v) for k, v in SCALARS.items()})
    jp, _, _, jm = jstep(state.params, state.opt_state, jb, state.step)
    tx = step.make_optimizer(**kw)
    init, mstep, _ = step.make_train_step(cfg, _mesh((2, 2)), tx=tx)
    mp = init.place(host)
    _, _, _, m = mstep(mp, tx.init(mp.leaves), _port_batch(hb, cfg), 0)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
        float(jm["loss"]))
    assert abs(float(m["moe_aux"]) - float(jm["moe_aux"])) <= 1e-4 * float(
        jm["moe_aux"])
    bad = _update_mismatches(
        mp.merge([x.detach() for x in mp.leaves]),
        [torch.from_numpy(np.array(x)) for x in
         step.tree_leaves(jax.tree.map(np.asarray, jp))],
        [torch.from_numpy(np.array(x)) for x in step.tree_leaves(host)],
        kw["lr"])
    assert not bad, bad
    j2 = j.replace(encoder=dataclasses.replace(j.encoder, n_experts=2))
    j2cfg, j2mesh = _jax_mesh(j2, (1, 4))
    with pytest.raises(ValueError, match="divisible"):
        jax_step.make_train_step(j2cfg, j2mesh)[0](seed=0)
    c2 = cfg.replace(encoder=dataclasses.replace(cfg.encoder, n_experts=2))
    with pytest.raises(ValueError, match="n_experts"):
        step.make_train_step(c2, _mesh((1, 4)))
