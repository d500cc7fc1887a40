"""PyTorch port: the multi-controller mesh (``parallel/mesh.py::
init_distributed``), training over a (data, model) mesh whose data rows lie
in two processes joined over gloo, held to the JAX package's one-device
step and to the port's single-process mesh of the same global shape.

One spawn of two processes (``tests/torch_multiprocess_worker.py``, on
127.0.0.1, each one data row and its model shards on the CPU) runs every
update; rank 1 is given another batch, which the step must replace with
rank 0's. ``tiny_config`` with 4 heads, the batch of
``tests/test_torch_mesh_train.py`` (rows that differ in valid frames, one
unalignable row), SpecAugment and dropout 0.1. Against JAX the port takes
the JAX draws (its SpecAugment output and dropout masks, pretraining's
span starts and noise); against the single-process mesh the port draws
its own. The parameters are the port's ``asr_init`` (and the
translator's, the pretraining head's), handed to both packages.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import pickle
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build
from omnilingual_asr_tpu.train import augment as jax_augment
from omnilingual_asr_tpu.train import pretrain as jax_pretrain
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.config import MeshConfig
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.models.conformer import asr_init
from omnilingual_asr_torch.models.translation import translator_init
from omnilingual_asr_torch.parallel import mesh as pm
from omnilingual_asr_torch.train import pretrain, step
from test_torch_mesh_train import (AUG, OPT, SCALARS, T, _cfgs, _host_batch,
                                   _port_batch)

import torch_multiprocess_worker as worker

torch.set_num_threads(2)

CPU = torch.device("cpu")
STEP = 3                 # the train step's number (its draws' salt)
DROPOUT = 0.1
N_EXPERTS = 4
PCFG = dict(codebook_size=512, codebook_dim=8, mask_prob=0.1, mask_span=3)
PRE_VALID = [T, 100, 60, 16]
CHILD_TIMEOUT_S = 300
F32_REL = 1e-6           # a leaf, with bf16 rounding taken out
JAX_AUG = jax_augment.SpecAugmentConfig(
    n_freq_masks=AUG.n_freq_masks, freq_mask_width=AUG.freq_mask_width,
    n_time_masks=AUG.n_time_masks, time_mask_width=AUG.time_mask_width)
JAX_JOBS = ["jax_train_m1", "jax_train_m2", "jax_moe_m2", "jax_pretrain_m1"]
BF16_JOBS = ["train_m1", "train_m2", "moe_m2", "pretrain_m1"]
F32_JOBS = ["train_f32_m1", "train_f32_m2", "pretrain_f32_m1"]
FAULTS = ["speaker", "batch", "allreduce"]


def _capture():
    """An optax transformation whose state after an update is the update's
    gradient (and which moves nothing): the JAX step's gradients, read
    from its optimizer state."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


def _one_jax_device(jcfg):
    jcfg = jcfg.replace(mesh=JaxMeshConfig(data=1, model=1))
    return jcfg, jax_build(jcfg.mesh, devices=jax.devices()[:1])


def _numpy_tree(tree):
    """A port parameter tree as numpy, its dicts in sorted key order (the
    order in which JAX hands a tree back, so that both packages' leaves
    align)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().numpy()


def _init(cfg, seed: int, translator: bool = False):
    """The port's initial parameters (``asr_init``, the translator from
    seed + 1), as numpy."""
    p = asr_init(torch.Generator().manual_seed(seed), cfg)
    if translator:
        p = {"asr": p, "translator": translator_init(
            torch.Generator().manual_seed(seed + 1), cfg)}
    return _numpy_tree(p)


def _leaves(tree):
    """A JAX tree's leaves as numpy, in the port's leaf order."""
    return step.tree_leaves(jax.tree.map(np.asarray, tree))


def _jax_draws(jcfg, hb):
    """The JAX step's draws at STEP as the port takes them: the augmented
    mel and the kept elements of each dropout salt."""
    aug = jax_augment.spec_augment(
        jax.random.fold_in(jax.random.PRNGKey(0), STEP),
        jnp.asarray(hb["mel"]), jnp.asarray(hb["mask"]), JAX_AUG)
    dkey = jax.random.fold_in(jax.random.PRNGKey(1), STEP)
    enc = jcfg.encoder
    shape = (hb["mel"].shape[0], T // enc.subsample_factor, enc.d_model)
    keep = [torch.from_numpy(np.array(jax.random.bernoulli(
        jax.random.fold_in(dkey, salt), 1.0 - DROPOUT, shape)))
        for salt in range(enc.n_layers + 1)]
    return dict(patches=("jax_draws",), jax_aug=torch.from_numpy(
        np.array(aug)), jax_keep=keep)


def _jax_train(jcfg, params, hb):
    """The JAX package's jitted ``make_train_step`` on one device (augment
    and dropout on) from ``params`` and ``hb`` -> (loss, gradients)."""
    jcfg, jmesh = _one_jax_device(jcfg)
    translator = "translator" in params
    keys = tuple(hb) + tuple(SCALARS)
    _, jstep = jax_step.make_train_step(
        jcfg, jmesh, tx=_capture(), augment=JAX_AUG, batch_keys=keys,
        with_translator=translator, dropout=True)
    p = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    jb.update({k: jnp.float32(v) for k, v in SCALARS.items()})
    _, grads, _, metrics = jstep(p, _capture().init(p), jb, jnp.int32(STEP))
    return float(metrics["loss"]), _leaves(grads)


def _with(jcfg, cfg, **enc):
    return (jcfg.replace(encoder=dataclasses.replace(jcfg.encoder, **enc)),
            cfg.replace(encoder=dataclasses.replace(cfg.encoder, **enc)))


def _pretrain_inputs(cfg):
    """The pretraining job's inputs at ``cfg``, the JAX draws among
    them."""
    jp = jax_pretrain.PretrainConfig(**PCFG)
    pcfg = pretrain.PretrainConfig(**PCFG)
    params = _numpy_tree(pretrain.pretrain_init(
        torch.Generator().manual_seed(3), cfg, pcfg))
    jq = _numpy_tree(pretrain.make_quantizer(
        torch.Generator().manual_seed(4), cfg, pcfg))
    rng = np.random.default_rng(5)
    mel = (rng.standard_normal((4, T, 128)) * 2.0 - 5.0).astype(np.float32)
    mask = np.arange(T)[None] < np.array(PRE_VALID)[:, None]
    k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))
    starts = np.array(jax.random.bernoulli(k1, jp.mask_prob, (4, T // 4)))
    noise = np.array(jax.random.normal(k2, (4, T, 128), jnp.float32))
    other = np.random.default_rng(6)
    return dict(kind="pretrain", cfg=cfg, pcfg=pcfg, params=params,
                quantizer=zoo.params_from_jax(jq), jax_quantizer=jq,
                batch={"mel": torch.from_numpy(mel),
                       "mask": torch.from_numpy(mask)},
                other_batch={"mel": torch.from_numpy(
                    other.standard_normal(mel.shape).astype(np.float32)),
                    "mask": torch.from_numpy(mask[::-1].copy())},
                draws=(torch.from_numpy(starts), torch.from_numpy(noise)),
                opt=dict(lr=1e-3, warmup_steps=0, decay_steps=10), step=0)


def _jax_pretrain(jcfg, pre):
    """The JAX package's jitted ``make_pretrain_step`` on one device from
    the job's inputs -> (loss, gradients)."""
    jcfg, jmesh = _one_jax_device(jcfg)
    _, jstep = jax_pretrain.make_pretrain_step(
        jcfg, jmesh, jax_pretrain.PretrainConfig(**PCFG), tx=_capture())
    p = jax.tree.map(jnp.asarray, pre["params"])
    batch = {k: jnp.asarray(v.numpy()) for k, v in pre["batch"].items()}
    _, grads, _, metrics = jstep(p, jax.tree.map(jnp.asarray,
                                                 pre["jax_quantizer"]),
                                 _capture().init(p), batch, jnp.int32(0))
    return float(metrics["loss"]), _leaves(grads)


def _jobs():
    """Every job the processes run, and a function that gives the JAX
    package's (loss, grads) for the jobs held to it (``jax_*``). Those run
    the plain layers and the f32 encoder in both packages: JAX's kernels
    run in its step on a TPU only, and the port's plain versions of K2/K3
    round where those kernels round, not where JAX's plain layers do (4.0e-2
    a leaf apart); at the bf16 encoder the two packages' roundings alone
    put a leaf up to 2.3e-2 apart on these parameters (measured: the
    ground of TRAINER_GRAD_REL, not of the mesh). The others run the kernel
    flags and the port's own draws."""
    j, plain = _cfgs(dropout=DROPOUT)
    _, fused = _cfgs(fused=True, dropout=DROPOUT)
    j, _ = _with(j, plain, dropout=DROPOUT)
    jf, plain_f = _with(j, plain, dtype="float32")
    hb = _host_batch()
    params = _init(plain, 0, translator=True)
    train = dict(kind="train", cfg=fused, params=params,
                 batch=_port_batch(hb, fused),
                 other_batch=_port_batch(_host_batch(9), fused), opt=OPT,
                 augment=AUG, translator=True, step=STEP)
    jmf, plain_mf = _with(jf, plain_f, n_experts=N_EXPERTS)
    _, fused_m = _with(j, fused, n_experts=N_EXPERTS)
    moe_params = _init(fused_m, 5)
    hm = _host_batch(4, translator=False)
    moe = dict(train, cfg=fused_m, params=moe_params,
               batch=_port_batch(hm, fused_m),
               other_batch=_port_batch(_host_batch(8, translator=False),
                                       fused_m), translator=False)
    jpf, pre_f = _with(*_cfgs(), dtype="float32")
    pre = _pretrain_inputs(pre_f)
    _, f32_cfg = _cfgs(dropout=DROPOUT)
    f32 = dict(train, cfg=f32_cfg, patches=("f32",), batch=_port_batch(
        _host_batch(1), f32_cfg), other_batch=_port_batch(_host_batch(2),
                                                          f32_cfg))
    draws = _jax_draws(jf, hb)
    jobs = [dict(train, name="jax_train_m1", model=1, cfg=plain_f, **draws),
            dict(train, name="jax_train_m2", model=2, cfg=plain_f, **draws),
            dict(moe, name="jax_moe_m2", model=2, cfg=plain_mf,
                 **_jax_draws(jmf, hm)),
            dict(pre, name="jax_pretrain_m1", model=1),
            dict(train, name="train_m1", model=1),
            dict(train, name="train_m2", model=2),
            dict(moe, name="moe_m2", model=2),
            dict(pre, name="pretrain_m1", model=1,
                 cfg=_cfgs(fused=True)[1], draws=None),
            dict(f32, name="train_f32_m1", model=1),
            dict(f32, name="train_f32_m2", model=2),
            dict(pre, name="pretrain_f32_m1", model=1, cfg=_cfgs()[1],
                 draws=None, patches=("f32",))]
    jobs += [dict(f32, name=f"fault_{f}", model=1, patches=("f32", f))
             for f in FAULTS]

    def want_jax():
        train_m = _jax_train(jf, params, hb)
        return {"jax_train_m1": train_m, "jax_train_m2": train_m,
                "jax_moe_m2": _jax_train(jmf, moe_params, hm),
                "jax_pretrain_m1": _jax_pretrain(jpf, pre)}

    return jobs, want_jax


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two processes' results, the single-process meshes' and the JAX
    package's, by job."""
    root = tmp_path_factory.mktemp("multiprocess")
    jobs, jax_updates = _jobs()
    (root / "jobs.pkl").write_bytes(pickle.dumps(jobs))
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=worker.main,
                         args=(r, port, str(root / "jobs.pkl"), str(root)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:      # the references, while the processes run
        want_jax = jax_updates()
        single = {}
        for job in jobs:
            if job["name"] in BF16_JOBS + F32_JOBS:
                model = job["model"]
                single[job["name"]] = worker.run_job(job, pm.build_mesh(
                    MeshConfig(data=2, model=model), [CPU] * (2 * model)))
    finally:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes())
             for r in range(2)]
    return ranks, single, want_jax


def _mismatches(got, want, loss_rel, grad_rel, clipped=True):
    """The loss within ``loss_rel`` and each leaf's gradient (and clipped
    gradient) within ``grad_rel`` relative L2. Returns what failed."""
    bad = []
    rel = abs(got[0] - want[0]) / abs(want[0])
    if rel > loss_rel:
        bad.append(f"loss {rel:.3e}")
    for name, a, b in (("grads", got[1], want[1]),
                       ("clipped", got[2], want[2]))[:2 if clipped else 1]:
        worst = max(float(np.linalg.norm(x - y)) / max(
            float(np.linalg.norm(y)), 1e-30) for x, y in zip(a, b))
        if worst > grad_rel:
            bad.append(f"{name} {worst:.3e}")
    return bad


def test_processes_join_over_gloo(runs):
    """Two processes on the CPU: gloo, ranks 0 and 1 of 2, the (2, m)
    meshes' rows one a process; a model group over both processes and
    serving over a mesh that spans them raise NotImplementedError naming
    A10."""
    ranks, _, _ = runs
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo"
        assert (out["index"], out["count"]) == (r, 2)
        assert out["processes"] == [[0], [1]]
        for what in ("model_group", "engine"):
            assert "A10" in out["refusals"][what], out["refusals"]


@pytest.mark.parametrize("name", JAX_JOBS)
def test_update_matches_jax(name, runs):
    """Each update over 2 processes x (1, m) (the plain layers, the f32
    encoder, SpecAugment and dropout from the JAX draws, pretraining's
    spans and noise too) against the JAX package's jitted step on one
    device from the same parameters and batch: the loss within
    MESH_LOSS_REL, every leaf's gradient within MESH_GRAD_REL (measured
    4.3e-3 with the translator, 3.8e-5 without, 2.3e-3 pretraining: the
    translator, the speaker projection and the pretraining head still
    round to bf16 in both)."""
    ranks, _, want = runs
    got = ranks[0]["jobs"][name]
    bad = _mismatches(got, want[name] + (None,), testing.MESH_LOSS_REL,
                      testing.MESH_GRAD_REL, clipped=False)
    assert not bad, bad


@pytest.mark.parametrize("name", BF16_JOBS + F32_JOBS)
def test_update_matches_single_process_mesh(name, runs):
    """Each update over 2 processes x (1, m) against the single-process
    (2, m) mesh from the same parameters and batch: with bf16 rounding
    taken out within F32_REL a leaf (gradients and clipped gradients), at
    bf16 within MESH_LOSS_REL and MESH_GRAD_REL (measured 0 to 1e-8 in
    both: each row computes what it computes in one process, and the two
    rows' gradients are summed in the same order). Rank 1 holds rank 0's loss
    and gradients exactly, though it was given another batch."""
    ranks, single, _ = runs
    got = ranks[0]["jobs"][name]
    rel = F32_REL if name in F32_JOBS else testing.MESH_GRAD_REL
    loss_rel = F32_REL if name in F32_JOBS else testing.MESH_LOSS_REL
    bad = _mismatches(got, single[name], loss_rel, rel)
    assert not bad, bad
    other = ranks[1]["jobs"][name]
    assert other[0] == got[0]
    for a, b in zip(other[1] + other[2], got[1] + got[2]):
        assert np.array_equal(a, b)
    assert got[3] > 0        # bytes crossed processes


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(fault, runs):
    """Each planted fault fails the f32 comparison with the single-process
    mesh: the speaker leaves' direct term counted once a process (no
    ``loss_tree``), rank 1 training on its own batch (no
    ``broadcast_batch``), no sum of the gradients over the processes
    (measured 1.0, 1.44 and 0.90 on the worst leaf)."""
    ranks, single, _ = runs
    got = ranks[0]["jobs"][f"fault_{fault}"]
    assert _mismatches(got, single["train_f32_m1"], F32_REL, F32_REL)
