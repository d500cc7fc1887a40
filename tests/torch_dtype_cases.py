"""Cases that ``tests/test_torch_f32.py`` and ``tests/test_torch_f16.py``
share: seeded inputs, the JAX package's jitted functions at a given
encoder dtype (each compiled once a process and cached here, so that
parametrised tests and both files reuse one compile), and the comparisons
both make. Not a test module: it holds no tests.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.ops import attention as jax_attention
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import zoo

#: The engine tests' audio: the golden file at the start of each of two
#: 30 s windows.
TWO_WINDOWS_S = 30.0


def flash_inputs(B, T, H, D, valid, seed, dtype=np.float32):
    """q, k, v, dO [B, T, H, D] of ``dtype`` (standard normal draws) and
    the key mask of ``valid`` keys a row."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, D)).astype(dtype)
                   for _ in range(4))
    mask = np.arange(T)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, do, mask


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@functools.lru_cache(maxsize=None)
def jax_flash_vjp(dtype: str):
    """JAX's ``flash_attention`` (Pallas, interpret mode) and its custom
    VJP, jitted: (q, k, v, mask, dO) -> (o, (dq, dk, dv)) at ``dtype``."""

    def run(q, k, v, mask, do):
        o, vjp = jax.vjp(lambda q_, k_, v_: jax_attention.flash_attention(
            q_, k_, v_, mask, interpret=True), q, k, v)
        return o, vjp(do)

    return jax.jit(run)


def jax_flash(q, k, v, mask, do):
    """(o, (dq, dk, dv)) of :func:`jax_flash_vjp` at q's dtype, as numpy."""
    o, g = jax_flash_vjp(str(q.dtype))(q, k, v, jnp.asarray(mask), do)
    return np.array(o), tuple(np.array(x) for x in g)


def dtype_cfgs(dtype: str, kernels: bool):
    """tiny_config() with the encoder at ``dtype`` in both packages; the
    kernel flags (their plain versions on the CPU) when ``kernels``."""
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        out.append(cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, dtype=dtype, use_flash_attention=kernels,
            use_fused_conv=kernels)))
    return tuple(out)


def mel_batch(B, T, valid, seed):
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(np.float32)
    return mel, np.arange(T)[None, :] < np.asarray(valid)[:, None]


HEADS = ("ctc_logits", "lid_logits", "emotion_logits", "speaker_frames",
         "speaker_embed", "encoder_states")


def asr_forward_errors(dtype: str, kernels: bool) -> dict:
    """``asr_forward`` on tiny_config at ``dtype`` in both packages on the
    same JAX-initialised tree (B 3, T 1024, one row ragged, one padded):
    each head's max abs error over its largest magnitude (the JAX side
    jitted, its Pallas kernels in interpret mode); the masks must be
    equal."""
    jcfg, cfg = dtype_cfgs(dtype, kernels)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(4), jcfg)
    mel, mask = mel_batch(3, 1024, [1024, 601, 0], seed=5)
    want = jax.jit(lambda p, m, k: jax_conformer.asr_forward(
        p, m, k, jcfg, flash_interpret=True))(jp, mel, mask)
    with torch.inference_mode():
        got = port_forward(jp, mel, mask, cfg)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    # Padded rows: the plain path's uniform softmax over no valid key and
    # the flash path's zeros agree in both packages.
    return {key: rel(got[key].float().numpy(), want[key]) for key in HEADS}


def port_forward(jp, mel, mask, cfg):
    from omnilingual_asr_torch.models import conformer

    return conformer.asr_forward(zoo.params_from_jax(jp),
                                 torch.from_numpy(mel),
                                 torch.from_numpy(mask), cfg)


def flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat(tree):
    return {k: v.detach().float().numpy() for k, v in zoo.flatten(
        tree).items()}


def rel_l2(got, want):
    assert set(got) == set(want)
    out = {}
    for k in want:
        nw = float(np.linalg.norm(want[k]))
        d = float(np.linalg.norm(got[k] - want[k]))
        out[k] = d / nw if nw > 0 else d
    return out


def kernel_mode_grads(dtype: str):
    """The kernel-mode forward's gradients at ``dtype`` in both packages
    (B 2, T 1024, a ragged row; the loss a fixed random projection of the
    CTC logits, speaker frames and encoder states): (port loss, JAX loss,
    the terms' magnitude, each leaf's relative L2 error)."""
    from omnilingual_asr_torch.models import conformer
    from omnilingual_asr_torch.train import step

    jcfg, cfg = dtype_cfgs(dtype, True)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(3), jcfg)
    mel, mask = mel_batch(2, 1024, [1024, 768], seed=1)
    rng = np.random.default_rng(2)
    proj = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("ctc_logits", (2, 256, 512)), ("speaker_frames", (2, 256, 256)),
        ("encoder_states", (2, 256, 128)))}

    def jloss(p):
        out = jax_conformer.asr_forward(p, jnp.asarray(mel),
                                        jnp.asarray(mask), jcfg,
                                        flash_interpret=True)
        return sum(jnp.sum(out[k].astype(jnp.float32) * v)
                   for k, v in proj.items())

    want_loss, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = step.tree_map(lambda t: t.requires_grad_(True),
                       zoo.params_from_jax(jp))
    out = conformer.asr_forward(tp, torch.from_numpy(mel),
                                torch.from_numpy(mask), cfg)
    terms = [out[k].float() * torch.from_numpy(v) for k, v in proj.items()]
    loss = sum(t.sum() for t in terms)
    loss.backward()
    scale = float(sum(t.detach().abs().sum() for t in terms))
    got = {k: (np.zeros(tuple(v.shape), np.float32) if v.grad is None
               else v.grad.numpy()) for k, v in zoo.flatten(tp).items()}
    return (float(loss.detach()), float(want_loss), scale,
            rel_l2(got, flat_jax(jg)))


def train_step_errors(dtype: str):
    """One ``make_train_step`` update at ``dtype`` (the plain paths: the
    reference's loss calls its kernels without interpret mode) against
    the reference's ``make_train_step`` on a one-device CPU mesh, from
    the same parameters and batch (a ragged mask, one row without labels,
    every supervised key): (port loss, JAX loss, each leaf's update's
    relative L2 error)."""
    from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
    from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_mesh
    from omnilingual_asr_tpu.train import step as jax_step
    from omnilingual_asr_torch.train import step

    jcfg, cfg = dtype_cfgs(dtype, False)
    jcfg = jcfg.replace(mesh=JaxMeshConfig(data=1, model=1))
    rng = np.random.default_rng(7)
    B, T, L = 2, 256, 10
    b = {"mel": (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(
             np.float32),
         "mask": np.arange(T)[None, :] < np.array([T, 190])[:, None],
         "labels": rng.integers(1, 257, (B, L)).astype(np.int32),
         "label_mask": np.arange(L)[None, :] < np.array([L, 0])[:, None],
         "lid_label": rng.integers(0, 2048, B).astype(np.int32),
         "emotion_label": rng.integers(0, 4, B).astype(np.int32),
         "speaker_label": rng.integers(0, 1024, B).astype(np.int32),
         "char_frame_label": rng.integers(-1, 257, (B, T // 4)).astype(
             np.int32)}
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    init, jstep = jax_step.make_train_step(
        jcfg, jax_mesh(jcfg.mesh), tx=jax_step.make_optimizer(**kw),
        batch_keys=tuple(b))
    state = init(seed=0)
    p0 = flat_jax(state.params)
    jp, _, _, jm = jstep(state.params, state.opt_state,
                         {k: jnp.asarray(v) for k, v in b.items()},
                         state.step)
    tx = step.make_optimizer(**kw)
    _, tstep, _ = step.make_train_step(cfg, "cpu", tx=tx)
    tp = step.tree_map(lambda t: t.requires_grad_(True),
                       zoo.params_from_jax(jax.device_get(state.params)))
    tp, _, _, m = tstep(tp, tx.init(tp),
                        {k: torch.from_numpy(v) for k, v in b.items()}, 0)
    want = {k: v - p0[k] for k, v in flat_jax(jp).items()}
    got = {k: v - p0[k] for k, v in flat(tp).items()}
    return float(m["loss"]), float(jm["loss"]), rel_l2(got, want)
