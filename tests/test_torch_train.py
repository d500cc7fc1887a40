"""PyTorch port: the synthetic-corpus training slice against the JAX package.

Small sizes only (``tiny_config``: d_model 128, 2 layers, 2 heads of 64,
conv kernel 8); every input is made from a seed with numpy and handed to
both packages, and every JAX parameter tree is carried across with
``models.zoo.params_from_jax``. Each test states its tolerance.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from omnilingual_asr_tpu.config import MeshConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.models import translation as jax_translation
from omnilingual_asr_tpu.models import zoo as jax_zoo
from omnilingual_asr_tpu.ops import ctc as jax_ctc
from omnilingual_asr_tpu.parallel.mesh import build_mesh
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_tpu.train import synth as jax_synth
from omnilingual_asr_tpu.utils import metrics as jax_metrics
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import conformer, translation, zoo
from omnilingual_asr_torch.ops import ctc
from omnilingual_asr_torch.train import augment, step, synth, synth_train
from omnilingual_asr_torch.utils import metrics

torch.set_num_threads(2)

VOCAB = 512


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {k: v.detach().float().numpy() for k, v in zoo.flatten(tree).items()}


def _rel_l2(got, want):
    """Per-leaf ||got - want|| / ||want|| over two {keystr: array} dicts
    with the same keys (0 where both are 0)."""
    assert set(got) == set(want)
    out = {}
    for k in want:
        nw = float(np.linalg.norm(want[k]))
        d = float(np.linalg.norm(got[k] - want[k]))
        out[k] = d / nw if nw > 0 else d
    return out


def _jax_params(cfg, seed=0, translator=False):
    p = jax_conformer.asr_init(jax.random.PRNGKey(seed), cfg)
    if translator:
        p = {"asr": p, "translator": jax_translation.translator_init(
            jax.random.PRNGKey(seed + 1), cfg)}
    return p


def _to_port(tree, grad=True):
    p = zoo.params_from_jax(tree)
    if grad:
        p = step.tree_map(lambda t: t.requires_grad_(True), p)
    return p


def _batch(B, T, seed=0, Lt=12, L=10):
    """Every batch key of the reference's loss, numpy, from a seed: a
    ragged mel mask, byte labels (one row without any), frame LID and char
    labels with unlabeled (-1) frames, speaker labels, translation tensors."""
    rng = np.random.default_rng(seed)
    Tp = T // 4
    mel = (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(np.float32)
    n_valid = np.array([T, T * 3 // 4][:B])
    mask = np.arange(T)[None, :] < n_valid[:, None]
    labels = rng.integers(1, 257, (B, L)).astype(np.int32)
    lmask = np.arange(L)[None, :] < np.array([L, 0][:B])[:, None]
    lid_frame = rng.integers(-1, 40, (B, Tp)).astype(np.int32)
    char_frame = rng.integers(-1, 257, (B, Tp)).astype(np.int32)
    char_frame[char_frame == 0] = -1
    tin = rng.integers(0, 257, (B, Lt)).astype(np.int32)
    ttgt = rng.integers(0, 257, (B, Lt)).astype(np.int32)
    tmask = np.arange(Lt)[None, :] < np.array([Lt, Lt // 2][:B])[:, None]
    return {"mel": mel, "mask": mask, "labels": labels, "label_mask": lmask,
            "lid_label": rng.integers(0, 2048, B).astype(np.int32),
            "emotion_label": rng.integers(0, 4, B).astype(np.int32),
            "speaker_label": rng.integers(0, 1024, B).astype(np.int32),
            "lid_frame_label": lid_frame, "char_frame_label": char_frame,
            "trans_in": tin, "trans_tgt": ttgt, "trans_mask": tmask}


W_SCALARS = {"w_spk": 0.7, "w_trans": 0.5, "w_aug": 1.0, "w_fce": 0.3,
             "w_ctc": 0.9}


def _port_batch(b):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in b.items()}


# ---------------------------------------------------------------------------
# The model in kernel mode
# ---------------------------------------------------------------------------

def _kernel_mode_case():
    cfg = tiny_config()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    b = _batch(2, 1024, seed=1)
    rng = np.random.default_rng(2)
    proj = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("ctc_logits", (2, 256, VOCAB)), ("speaker_frames", (2, 256, 256)),
        ("encoder_states", (2, 256, 128)))}
    return cfg, b, proj


def _port_kernel_mode_grads(jp, cfg, mel, mask, proj):
    tp = _to_port(jp)
    out = conformer.asr_forward(tp, torch.from_numpy(mel),
                                torch.from_numpy(mask), cfg)
    terms = [out[k] * torch.from_numpy(v) for k, v in proj.items()]
    loss = sum(t.sum() for t in terms)
    loss.backward()
    grads = {k: (np.zeros(tuple(v.shape), np.float32) if v.grad is None
                 else v.grad.numpy()) for k, v in zoo.flatten(tp).items()}
    scale = float(sum(t.detach().abs().sum() for t in terms))
    return float(loss.detach()), scale, grads


def test_kernel_mode_gradient_floor():
    """The floor under the kernel-mode comparison: the port's own gradients
    (the inputs of ``test_kernel_mode_forward_grads_match_jax``) under a
    1e-6 relative perturbation of the mel input. Where a perturbation that
    small flips a bf16 rounding of q/k or a ReLU gate, whole leaves move by
    percents: the worst leaf moves by more than 1e-2 (so no comparison of
    two implementations can be held tighter) and less than 5e-2 (the
    tolerance the JAX comparison uses)."""
    cfg, b, proj = _kernel_mode_case()
    jp = _jax_params(jax_tiny_config(), seed=3)
    _, _, g0 = _port_kernel_mode_grads(jp, cfg, b["mel"], b["mask"], proj)
    noise = np.random.default_rng(0).standard_normal(b["mel"].shape)
    mel = (b["mel"] * (1 + 1e-6 * noise)).astype(np.float32)
    _, _, g1 = _port_kernel_mode_grads(jp, cfg, mel, b["mask"], proj)
    errs = _rel_l2(g1, g0)
    assert 1e-2 < max(errs.values()) < 5e-2, max(errs.values())


def test_kernel_mode_forward_grads_match_jax():
    """``asr_forward`` with flash attention and the fused conv module on
    (their plain versions here, the Pallas kernels in interpret mode in
    JAX), B 2, T 1024 mel frames with a ragged mask, loss = a fixed random
    projection of the CTC logits, speaker frames and encoder states (the
    loss within 1e-5 of the sum of its terms' magnitudes, which cancel).
    Per-leaf relative L2 error of the gradients <= 5e-2: both round q, k,
    v, o, the matmul operands and their gradients to bf16 at the same
    places, from f32 sums taken in another order, so single elements differ
    by about a bf16 ulp (2^-8); where that flips a ReLU gate or a rounding
    of q/k the gradient jumps. The port's own gradients move by a few
    percent under a 1e-6 relative perturbation of the input
    (``test_kernel_mode_gradient_floor``), so the two packages may differ
    by that much.
    """
    jcfg = jax_tiny_config()
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, use_flash_attention=True, use_fused_conv=True))
    cfg, b, proj = _kernel_mode_case()
    jp = _jax_params(jcfg, seed=3)

    def jloss(p):
        out = jax_conformer.asr_forward(p, jnp.asarray(b["mel"]),
                                        jnp.asarray(b["mask"]), jcfg,
                                        flash_interpret=True)
        return sum(jnp.sum(out[k] * v) for k, v in proj.items())

    want_loss, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    loss, scale, got = _port_kernel_mode_grads(jp, cfg, b["mel"], b["mask"],
                                               proj)
    assert abs(loss - float(want_loss)) <= 1e-5 * scale
    errs = _rel_l2(got, _flat_jax(jg))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-2, (worst, errs[worst])


# ---------------------------------------------------------------------------
# Loss, optimizer, CTC, whole steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_case():
    """The non-kernel config's full loss in both packages, once."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jp = _jax_params(jcfg, seed=4, translator=True)
    b = _batch(2, 64, seed=5)

    def jloss(p):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jb.update({k: jnp.float32(v) for k, v in W_SCALARS.items()})
        return jax_step.loss_fn(p["asr"], jb, jcfg,
                                trans_params=p["translator"])

    (jtotal, jmetrics), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    tp = _to_port(jp)
    tb = _port_batch(dict(b, **W_SCALARS))
    total, m = step.loss_fn(tp["asr"], tb, cfg,
                            trans_params=tp["translator"])
    total.backward()
    return (float(jtotal), {k: float(v) for k, v in jmetrics.items()},
            _flat_jax(jg), float(total.detach()),
            {k: float(v.detach()) for k, v in m.items()},
            {k: v.grad.numpy() for k, v in zoo.flatten(tp).items()})


def test_loss_and_metrics_match_jax(loss_case):
    """The joint loss with every optional batch key and ramp scalar, and
    each metric: relative 1e-3. Both round matmul operands to bf16 at the
    same places, from f32 sums in another order; an operand that lands one
    bf16 ulp (2^-8) away moves its layer's outputs, and a mean over the
    batch averages those moves to the order of 1e-4."""
    jtotal, jm, _, total, m, _ = loss_case
    assert set(m) == set(jm) == {"ctc", "lid", "emotion", "frame_ce",
                                 "speaker", "translation", "loss"}
    for k in jm:
        assert abs(m[k] - jm[k]) <= 1e-3 * abs(jm[k]), (k, m[k], jm[k])
    assert abs(total - jtotal) <= 1e-3 * abs(jtotal)


def test_loss_grads_match_jax(loss_case):
    """Per-leaf gradients of the joint loss (encoder, heads, speaker AAM
    classes and the translator): relative L2 error <= 1e-2 per leaf, for
    the bf16 rounding of matmul operands and their gradients (about 2^-8
    per element, in another summation order)."""
    _, _, jg, _, _, g = loss_case
    errs = _rel_l2(g, jg)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-2, (worst, errs[worst])
    assert float(np.abs(g["['asr']['spk_aam']"]).max()) > 0
    assert float(np.abs(g["['translator']['embed']"]).max()) > 0


def test_optimizer_matches_optax():
    """Three updates of ``make_optimizer`` against the reference's optax
    chain on the same gradients, the second gradient with a NaN and the
    third with an inf element: the schedule's learning rate at each count,
    and the parameters after each update within 1e-6 relative (f32 Adam in
    another operation order)."""
    rng = np.random.default_rng(6)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    grads = []
    for bad in (None, np.nan, np.inf):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
             for k, v in init.items()}
        if bad is not None:
            g["b"][2] = bad
        grads.append(g)
    kw = dict(lr=1e-2, weight_decay=1e-2, warmup_steps=2, decay_steps=5)
    tx = jax_step.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=kw["lr"], warmup_steps=2, decay_steps=5,
        end_value=kw["lr"] * 0.05)
    opt = step.make_optimizer(**kw)
    for c in range(8):
        assert abs(opt.schedule(c) - float(sched(c))) <= 1e-9
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in init.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(ts, [torch.from_numpy(g[k].copy()) for k in ("a", "b")])
        for k in init:
            got, want = tp[k].detach().numpy(), np.asarray(jp[k])
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert ts.count == 3


def test_ctc_loss_matches_jax():
    """``ctc_loss`` against the reference's (optax) on ragged logits, a row
    with no labels and a row whose labels fit exactly: relative 1e-5. On a
    row that cannot be aligned (more labels than frames) the port runs
    optax's recursion too: the loss equals optax's within 1e-5 relative (a
    large finite value, where ``F.ctc_loss`` gives +inf), and the logits'
    gradient equals ``jax.grad`` of the reference within 1e-4 relative L2
    (both f32, the same recursion and logaddexp derivative rule, so only
    rounding in another operation order separates them), whether the rows
    are found from the tensors or given from the host."""
    rng = np.random.default_rng(7)
    B, T, V, L = 3, 12, 16, 6
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    lmask_t = np.arange(T)[None, :] < np.array([12, 9, 12])[:, None]
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[2] = [1, 2, 3, 4, 5, 6]
    lmask = np.arange(L)[None, :] < np.array([4, 0, 6])[:, None]

    @jax.jit                       # one compile for the five cases
    def jax_value_and_grad(x, lm, lb, lbm):
        return jax.value_and_grad(
            lambda y: jax_ctc.ctc_loss(y, lm, lb, lbm))(x)

    def both(lg, lm, lb, lbm, infeasible=None):
        want, jg = jax_value_and_grad(jnp.asarray(lg), jnp.asarray(lm),
                                      jnp.asarray(lb), jnp.asarray(lbm))
        x = torch.from_numpy(lg).requires_grad_(True)
        got = ctc.ctc_loss(x, torch.from_numpy(lm), torch.from_numpy(lb),
                           torch.from_numpy(lbm), infeasible=infeasible)
        got.backward()
        jg = np.asarray(jg)
        g_err = np.linalg.norm(x.grad.numpy() - jg) / np.linalg.norm(jg)
        return float(got.detach()), float(want), g_err

    got, want, g_err = both(logits, lmask_t, labels, lmask)
    assert abs(got - want) <= 1e-5 * abs(want)
    assert g_err <= 1e-4, g_err
    # Infeasible: 6 distinct labels in 4 frames (row 2); then row 0 too, 4
    # labels with a repeat (5 frames needed) in 4 frames.
    short = np.arange(T)[None, :] < np.array([12, 9, 4])[:, None]
    labels[0, 1] = labels[0, 0]
    shorter = np.arange(T)[None, :] < np.array([4, 9, 4])[:, None]
    for lm, rows in ((short, [2]), (shorter, [0, 2])):
        assert ctc.infeasible_rows(lm.sum(axis=1), labels,
                                   lmask).tolist() == rows
        for given in (None, np.array(rows)):
            got, want, g_err = both(logits, lm, labels, lmask, given)
            assert np.isfinite(want) and want > 1e4
            assert abs(got - want) <= 1e-5 * abs(want), (rows, got, want)
            assert g_err <= 1e-4, (rows, g_err)


def test_text_to_byte_labels_matches_jax():
    from omnilingual_asr_tpu.config import VocabConfig as JV
    from omnilingual_asr_torch.config import VocabConfig

    for text in ("hello world", "Привет мир", "", "x" * 300):
        a = ctc.text_to_byte_labels(text, VocabConfig(), 256)
        b = jax_ctc.text_to_byte_labels(text, JV(), 256)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_three_train_steps_match_jax():
    """Three steps of ``make_train_step`` (augment and dropout off, the
    translator on, every batch key) against the reference's on a one-device
    CPU mesh, from the same parameters and batches. Adam's first updates
    are about +-lr per element wherever |g| >> eps, so an element whose
    gradient differs by bf16 rounding moves the same way and distance, and
    only elements whose gradient is near zero (the sign decided by the
    rounding) can move the other way. After each step, per leaf, the
    parameter change (p - p0) agrees within relative L2 1e-1 and at most
    1e-3 of its elements differ by more than lr / 2. The losses agree
    within 1e-3 relative, as in ``test_loss_and_metrics_match_jax``."""
    jcfg = jax_tiny_config().replace(mesh=MeshConfig(data=1, model=1))
    cfg = tiny_config()
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    batches = [dict(_batch(2, 64, seed=10 + i), **W_SCALARS)
               for i in range(3)]
    mesh = build_mesh(jcfg.mesh)
    init, jstep = jax_step.make_train_step(
        jcfg, mesh, tx=jax_step.make_optimizer(**kw),
        batch_keys=tuple(batches[0]), with_translator=True)
    state = init(seed=0)
    jp, jo, js = state.params, state.opt_state, state.step
    # The jitted step hands its optimizer state and step back committed to
    # the mesh; commit them so before the first call too, or the second
    # call compiles the step again (15 s).
    jo, js = jax.device_put((jo, js), NamedSharding(mesh, PartitionSpec()))
    p0 = _flat_jax(jp)
    _, tstep, _ = step.make_train_step(cfg, "cpu",
                                       tx=step.make_optimizer(**kw),
                                       with_translator=True)
    tp = _to_port(jax.device_get(jp))
    opt = step.make_optimizer(**kw).init(tp)
    for i, b in enumerate(batches):
        jb = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                  else jnp.float32(v)) for k, v in b.items()}
        jp, jo, js, jm = jstep(jp, jo, jb, js)
        tp, opt, _, m = tstep(tp, opt, _port_batch(b), i)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-3 * abs(
            float(jm["loss"]))
        want = {k: v - p0[k] for k, v in _flat_jax(jp).items()}
        got = {k: v - p0[k] for k, v in _flat_port(tp).items()}
        errs = _rel_l2(got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-1, (i, worst, errs[worst])
        for k in want:
            flipped = np.mean(np.abs(got[k] - want[k]) > kw["lr"] / 2)
            assert flipped <= 1e-3, (i, k, flipped)


def test_train_step_with_unalignable_row_matches_jax():
    """One ``make_train_step`` update (learning rate at its peak from the
    first update) against the reference's on a batch whose second row has
    more labels plus repeats (17) than frames (12). The port's CTC takes
    optax's finite value for that row (rows given from the host, as the
    trainer gives them), so the global norm stays finite and the update is
    the reference's step, not one zeroed by the clip and ``zero_nans``.

    Adam's first update is lr * g / (|g| + eps), about +-lr per element, so
    an element moves the other way wherever the two packages' gradients
    (bf16-rounded operands summed in another order) differ in sign: near
    zero, and in the speaker head's AAM terms a little above (2.8 % of its
    leaf's largest element here). Criteria: the loss within 1e-3 relative;
    the update's direction, cosine >= 0.99 over all parameters and >= 0.9
    per leaf (n flipped elements of a leaf of N give 1 - 2 n / N; a zeroed
    update, ~lr * weight decay * p, gives ~0); its norm within 10 % of the
    reference's; at most 1 % of the elements more than lr / 2 apart."""
    jcfg = jax_tiny_config().replace(mesh=MeshConfig(data=1, model=1))
    cfg = tiny_config()
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    b = dict(_batch(2, 64, seed=30), **W_SCALARS)
    b["labels"][1] = [3, 3, 3, 3, 8, 8, 8, 8, 4, 4]
    b["label_mask"][1] = True
    assert step.ctc_rows(b, cfg).tolist() == [1]
    mesh = build_mesh(jcfg.mesh)
    init, jstep = jax_step.make_train_step(
        jcfg, mesh, tx=jax_step.make_optimizer(**kw),
        batch_keys=tuple(b), with_translator=True)
    state = init(seed=0)
    jp = state.params
    p0 = _flat_jax(jp)
    tp = _to_port(jax.device_get(jp))
    jb = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
              else jnp.float32(v)) for k, v in b.items()}
    jp, _, _, jm = jstep(jp, state.opt_state, jb, state.step)
    _, tstep, _ = step.make_train_step(cfg, "cpu",
                                       tx=step.make_optimizer(**kw),
                                       with_translator=True)
    tb = dict(_port_batch(b), **{step.CTC_INFEASIBLE: step.ctc_rows(b, cfg)})
    tp, _, _, m = tstep(tp, step.make_optimizer(**kw).init(tp), tb, 0)
    loss, jloss = float(m["loss"]), float(jm["loss"])
    assert np.isfinite(loss) and loss > 1e3
    assert abs(loss - jloss) <= 1e-3 * abs(jloss), (loss, jloss)
    want = {k: (v - p0[k]).astype(np.float64)
            for k, v in _flat_jax(jp).items()}
    got = {k: (v - p0[k]).astype(np.float64)
           for k, v in _flat_port(tp).items()}

    def cos(a, b):
        return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))

    per_leaf = {k: cos(got[k], want[k]) for k in want}
    worst = min(per_leaf, key=per_leaf.get)
    assert per_leaf[worst] >= 0.9, (worst, per_leaf[worst])
    g_all = np.concatenate([got[k].ravel() for k in want])
    w_all = np.concatenate([want[k].ravel() for k in want])
    assert np.isfinite(g_all).all()
    far = np.abs(g_all - w_all) > kw["lr"] / 2
    assert cos(g_all, w_all) >= 0.99, cos(g_all, w_all)
    assert abs(np.linalg.norm(g_all) - np.linalg.norm(w_all)) <= 0.1 * \
        np.linalg.norm(w_all)
    assert far.mean() <= 1e-2, far.mean()


# ---------------------------------------------------------------------------
# Data, randomness, metrics
# ---------------------------------------------------------------------------

def test_synth_batches_equal_jax():
    """The first ``SynthBatcher`` batch (one producer thread, a seed, the
    kernel mode's frame multiple) and ``eval_set(4)``: equal element for
    element to the JAX module's (both are numpy)."""
    from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
    from omnilingual_asr_torch.config import PipelineConfig

    kw = dict(batch_size=3, window_seconds=4.0, seed=11, n_threads=1,
              frame_multiple=1024, reuse_pool=64, reuse_p=0.8)
    got_b = synth.SynthBatcher(PipelineConfig(), **kw)
    want_b = jax_synth.SynthBatcher(JaxConfig(), **kw)
    try:
        got, want = next(iter(got_b)), next(iter(want_b))
    finally:
        got_b.close()
        want_b.close()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(synth.eval_set(4), jax_synth.eval_set(4)):
        np.testing.assert_array_equal(a.samples, b.samples)
        assert (a.text, a.language, a.emotion, a.speaker_id, a.translation,
                a.char_spans) == (b.text, b.language, b.emotion,
                                  b.speaker_id, b.translation, b.char_spans)


def test_spec_augment_masks():
    """Masked bins and frames take the utterance's valid-frame mean; time
    masks start inside the valid span; widths stay within the config's."""
    cfg = augment.SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                                    n_time_masks=1, time_mask_width=24)
    rng = np.random.default_rng(8)
    B, T, F = 6, 200, 128
    mel = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
    n_valid = torch.tensor([200, 150, 90, 40, 5, 120])
    mask = torch.arange(T)[None, :] < n_valid[:, None]
    for seed in range(5):
        out = augment.spec_augment(torch.Generator().manual_seed(seed), mel,
                                   mask, cfg)
        mean = (mel * mask[:, :, None]).sum(dim=(1, 2)) / (
            n_valid.float() * F)
        hit = out != mel
        for b in range(B):
            assert torch.allclose(out[b][hit[b]], mean[b].expand(
                int(hit[b].sum())))
            cols = hit[b].all(dim=0).nonzero().flatten()
            rows = hit[b].all(dim=1).nonzero().flatten()
            assert len(cols) <= 16 and len(rows) <= 24
            if len(rows):
                assert int(rows[0]) < max(int(n_valid[b]), 1)
    a = augment.spec_augment(torch.Generator().manual_seed(1), mel, mask, cfg)
    b = augment.spec_augment(torch.Generator().manual_seed(1), mel, mask, cfg)
    assert torch.equal(a, b)


def test_dropout_keep_rate_and_scaling():
    """Inverted dropout: kept elements scaled by 1/(1 - rate), the keep
    share within 5 standard deviations of 1 - rate, a salt or a seed
    changes the mask, the same (seed, salt) repeats it."""
    x = torch.ones(200_000)
    rate = 0.1
    y = conformer.dropout(x, rate, seed=5, salt=0)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    share = float(kept.float().mean())
    assert abs(share - 0.9) <= 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.equal(y, conformer.dropout(x, rate, seed=5, salt=0))
    assert not torch.equal(y, conformer.dropout(x, rate, seed=5, salt=1))
    assert not torch.equal(y, conformer.dropout(x, rate, seed=6, salt=0))


def test_forward_dropout_and_remat():
    """``dropout_seed`` with ``encoder.dropout > 0`` changes the forward
    and repeats with the seed; without a seed the forward is the serving
    one. ``encoder.remat`` recomputes blocks in the backward and gives the
    same gradients (exactly: the same operations run again)."""
    cfg = tiny_config()
    p = conformer.asr_init(torch.Generator().manual_seed(0), cfg)
    p = step.tree_map(lambda t: t.requires_grad_(True), p)
    b = _batch(2, 64, seed=9)
    mel, mask = torch.from_numpy(b["mel"]), torch.from_numpy(b["mask"])
    plain = conformer.asr_forward(p, mel, mask, cfg)["ctc_logits"]
    d1 = conformer.asr_forward(p, mel, mask, cfg, dropout_seed=3)
    d2 = conformer.asr_forward(p, mel, mask, cfg, dropout_seed=3)
    assert not torch.equal(plain, d1["ctc_logits"])
    assert torch.equal(d1["ctc_logits"], d2["ctc_logits"])
    rcfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, remat=True))
    grads = []
    for c in (cfg, rcfg):
        out = conformer.asr_forward(p, mel, mask, c)["ctc_logits"]
        grads.append(torch.autograd.grad(out.square().sum(),
                                         step.tree_leaves(p),
                                         allow_unused=True))
    for a, b_ in zip(*grads):
        assert (a is None) == (b_ is None)
        if a is not None:
            assert torch.equal(a, b_)


def test_metrics_match_jax():
    pairs = [("The quick brown fox", "the quick brown box"),
             ("Привет, мир!", "привет мир"), ("", ""), ("a b c", ""),
             ("jumps over", "jumps over the lazy dog")]
    for r, h in pairs:
        assert metrics.normalize_text(r) == jax_metrics.normalize_text(r)
        assert metrics.wer(r, h) == jax_metrics.wer(r, h)
        assert metrics.cer(r, h) == jax_metrics.cer(r, h)
        assert metrics.edit_distance(r, h) == jax_metrics.edit_distance(r, h)
    assert metrics.aggregate_wer(pairs) == jax_metrics.aggregate_wer(pairs)
    ref = [(0.0, 2.0, "A"), (2.0, 5.0, "B")]
    hyp = [(0.0, 2.5, "x"), (2.5, 5.0, "y")]
    assert metrics.der(ref, hyp) == jax_metrics.der(ref, hyp)


# ---------------------------------------------------------------------------
# Checkpoints and the entry point
# ---------------------------------------------------------------------------

def test_translator_forward_and_save_load_match_jax(tmp_path):
    """``decoder_forward`` on a JAX translator tree carried across equals
    JAX's within 2^-8 of the largest logit: both round each dense layer's
    input to bf16, and an input that lands one bf16 ulp away (2^-8
    relative) moves the logits by about that; ``save_translator`` then
    ``load_translator`` round-trips it exactly."""
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jt = jax_translation.translator_init(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 257, (2, 9)).astype(np.int32)
    enc = rng.standard_normal((2, 16, 128)).astype(np.float32)
    emask = np.arange(16)[None, :] < np.array([16, 5])[:, None]
    want = np.asarray(jax_translation.decoder_forward(
        jt, jnp.asarray(tokens), jnp.asarray(enc), jnp.asarray(emask), jcfg))
    tt = zoo.params_from_jax(jt)
    got = translation.decoder_forward(tt, torch.from_numpy(tokens),
                                      torch.from_numpy(enc),
                                      torch.from_numpy(emask), cfg).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()
    path = tmp_path / "translator.npz"
    translation.save_translator(path, tt)
    back = translation.load_translator(path, cfg)
    for k, v in zoo.flatten(tt).items():
        assert torch.equal(zoo.flatten(back)[k], v)


def test_train_synth_entry_point(tmp_path):
    """``train_synth(device="cpu")``: 2 steps of ``--tiny`` without kernel
    mode write ``best``/``last`` checkpoints whose ``asr.npz`` both
    packages' ``load_checkpoint`` read back (equal leaves), and a
    ``train_state.npz`` that restores the optimizer. Kernel mode on the CPU
    raises, as does the default device without a card."""
    cfg = tiny_config()
    params, best = synth_train.train_synth(
        steps=2, batch_size=2, cfg=cfg, window_seconds=2.0, eval_every=2,
        ckpt_dir=str(tmp_path), device="cpu", warmup_steps=1)
    assert np.isfinite(best)
    path = tmp_path / "last" / "asr.npz"
    mine = zoo.flatten(zoo.load_checkpoint(path, cfg))
    theirs = _flat_jax(jax_zoo.load_checkpoint(path, jax_tiny_config()))
    live = zoo.flatten(params["asr"])
    assert set(mine) == set(theirs) == set(live)
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k])
        np.testing.assert_array_equal(mine[k].numpy(),
                                      live[k].detach().numpy())
    init, _, _ = step.make_train_step(cfg, "cpu", with_translator=True)
    state = init(0)
    opt, n, score = synth_train.load_train_state(
        tmp_path / "last" / "train_state.npz", state.opt_state)
    assert (n, opt.count) == (2, 2) and score == best
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_train.train_synth(steps=1, batch_size=2, cfg=cfg,
                                device="cpu", pallas_kernels=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            synth_train.train_synth(steps=1, batch_size=2, cfg=cfg)


class _NoEval:
    """Stands in for the trainer's evaluator (no held-out decode)."""

    def __init__(self, *args, **kwargs):
        pass

    def run(self, params):
        return {"synth": {"wer": 1.0, "cer": 1.0}}


def _jax_moments(opt_state):
    """{keystr: (mu, nu)} of a JAX ``make_optimizer`` state."""
    adam = opt_state[2][0]
    mu, nu = _flat_jax(adam.mu), _flat_jax(adam.nu)
    return {k: (mu[k], nu[k]) for k in mu}


def _port_moments(opt_state, params):
    """{keystr: (exp_avg, exp_avg_sq)} of the port's optimizer, whose
    leaves follow the parameter tree's order."""
    keys = list(zoo.flatten(params))
    return {k: tuple(opt_state.opt.state[p][m].numpy()
                     for m in ("exp_avg", "exp_avg_sq"))
            for k, p in zip(keys, opt_state.leaves)}


def test_unported_training_options_raise(tmp_path, monkeypatch):
    """``--resume-from`` on the JAX trainer's directory (Orbax ``asr/`` and
    ``translator/``, its ``train_state.npz``, written by the JAX package's
    own save functions) resumes: the trunk and the decoder equal the JAX
    package's restore bit for bit, and so do Adam's moments (random here),
    its count and the step, which the JAX layout orders by sorted key. The
    batcher's English sentences and bake mode construct
    (``tests/test_torch_device_pool.py`` holds them, the mu-law wire and
    the device pool to the JAX package)."""
    from omnilingual_asr_tpu.train import synth_train as jax_synth_train

    cfg, jcfg = tiny_config(), jax_tiny_config()
    run = tmp_path / "jax_run"
    gen = torch.Generator().manual_seed(0)
    tree = jax.tree.map(lambda t: t.numpy(), {
        "asr": conformer.asr_init(gen, cfg),
        "translator": translation.translator_init(gen, cfg)})
    jax_zoo.save_checkpoint(run / "asr", tree["asr"])
    jax_translation.save_translator(run / "translator", tree["translator"])
    rng = np.random.default_rng(0)
    tx = jax_step.make_optimizer()
    state = tx.init(tree)
    adam = state[2][0]._replace(
        count=jnp.asarray(5, jnp.int32),
        mu=jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), tree),
        nu=jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                        tree))
    state = (state[0], state[1], (adam,) + tuple(state[2][1:]))
    jax_synth_train.save_train_state(run / "train_state.npz", state, 5, 0.25)

    loaded = {}
    real = synth_train.load_train_state

    def recording(*args):
        loaded["opt"], *_ = real(*args)
        return loaded["opt"], *_

    monkeypatch.setattr(synth_train, "load_train_state", recording)
    monkeypatch.setattr(synth_train, "Evaluator", _NoEval)
    params, best = synth_train.train_synth(
        steps=1, total_steps=5, batch_size=2, cfg=cfg, device="cpu",
        resume_from=str(run), window_seconds=2.0)
    assert best == 0.25
    want = {"asr": jax_zoo.load_checkpoint(run / "asr", jcfg),
            "translator": jax_translation.load_translator(run / "translator",
                                                          jcfg)}
    mine = _flat_port(params)
    for k, v in _flat_jax(want).items():
        np.testing.assert_array_equal(mine[k], v)
    jopt, jstep, jbest = jax_synth_train.load_train_state(
        run / "train_state.npz", tx.init(tree))
    theirs = _jax_moments(jopt)
    ours = _port_moments(loaded["opt"], params)
    assert sorted(ours) == sorted(theirs) and (jstep, jbest) == (5, 0.25)
    for k in theirs:
        np.testing.assert_array_equal(ours[k][0], theirs[k][0])
        np.testing.assert_array_equal(ours[k][1], theirs[k][1])
    assert loaded["opt"].count == int(jopt[2][0].count) == 5
    for kw in ({"english_sentence_p": 0.5}, {"bake_mode": True}):
        synth.SynthBatcher(cfg, batch_size=2, n_threads=1, **kw).close()


def _entry_points():
    from omnilingual_asr_torch.ops import mel
    from omnilingual_asr_torch.train import (device_pool, pretrain,
                                             summary_train, translator_train)

    cfg = tiny_config()
    params = conformer.asr_init(torch.Generator().manual_seed(0), cfg)
    consts = mel.build_mel_constants(cfg.frontend)
    return {
        "make_train_step": lambda: step.make_train_step(cfg),
        "make_pretrain_step": lambda: pretrain.make_pretrain_step(cfg),
        "make_pool_train_step": lambda: device_pool.make_pool_train_step(cfg),
        "MelFrontend": lambda: mel.MelFrontend(cfg.frontend),
        "mel_plan": lambda: mel.mel_plan(*consts),
        "Evaluator": lambda: synth_train.Evaluator(cfg, window_seconds=2.0),
        "UtteranceEncoder": lambda: translator_train.UtteranceEncoder(
            cfg, params),
        "WindowEncoder": lambda: summary_train.WindowEncoder(cfg, params),
    }


@pytest.mark.parametrize("name", ["make_train_step", "make_pretrain_step",
                                  "make_pool_train_step", "MelFrontend",
                                  "mel_plan", "Evaluator",
                                  "UtteranceEncoder", "WindowEncoder"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Each compute entry point that names no device runs on the card, as
    the engine does: without one (``torch.cuda.is_available()`` False, as
    here) it raises a RuntimeError naming device='cpu' instead of running
    on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
