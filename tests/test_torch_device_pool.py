"""PyTorch port: the sample wires, the synthetic batcher's English sentences
and bake mode, and the device-resident example pool
(``train/device_pool.py``) against the JAX package.

Small sizes only (``tiny_config``: d_model 128, 2 layers). Batches are
numpy in both packages and held equal element for element; the JAX pool
step's gain, SNR and noise (from ``fold_in(PRNGKey(17), step)``) are
rebuilt with the JAX keys and passed to the port's step, which takes them
as inputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import MeshConfig
from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.ops import mel_pallas
from omnilingual_asr_tpu.parallel.mesh import build_mesh
from omnilingual_asr_tpu.train import device_pool as jax_pool
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_tpu.train import synth as jax_synth
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.audio.codec import mulaw_decode_np, mulaw_encode
from omnilingual_asr_torch.config import PipelineConfig, tiny_config
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.ops.mel import MelFrontend
from omnilingual_asr_torch.train import device_pool, step, synth, synth_train

torch.set_num_threads(2)

SCALARS = {"w_spk": 1.0, "w_trans": 1.0, "w_aug": 1.0, "w_fce": 0.5,
           "w_ctc": 1.0}
BAKE = dict(batch_size=4, window_seconds=2.0, seed=3, n_threads=1,
            real_fraction=0.0, codeswitch_fraction=0.0, bake_mode=True)


def _first_batches(batcher, n):
    try:
        it = iter(batcher)
        return [next(it) for _ in range(n)]
    finally:
        batcher.close()


@pytest.mark.parametrize("wire", ["i16", "mulaw", "f32"])
def test_mel_of_each_wire_matches_jax(wire):
    """``step.mel_from_samples`` on the int16, uint8 mu-law and f32 wires
    against the JAX ``_mel_from_samples`` (its Pallas kernel in interpret
    mode) on the same wire bytes: the frontend tests' criterion (linear mel
    within 1e-5 of each frame's peak, log-mel within 2e-3 where the bin is
    within 60 dB of the peak, all-zero frames exactly on the floor). The
    port's wire decode equals the host decoders."""
    rng = np.random.default_rng(4)
    n = 16_000
    x = np.zeros((2, n), np.float32)
    x[0] = 0.3 * np.sin(np.arange(n) * 0.03) + 0.05 * rng.standard_normal(n)
    x[1, :9_000] = 0.2 * rng.standard_normal(9_000)
    enc = {"i16": lambda v: device_pool.encode_wire(v, "i16"),
           "mulaw": mulaw_encode, "f32": lambda v: v}[wire](x)
    T = 100
    mask = np.arange(T)[None, :] < np.array([T, 55])[:, None]
    jcfg = JaxConfig()
    want = np.asarray(jax_step._mel_from_samples(
        {"samples": jnp.asarray(enc), "mask": jnp.asarray(mask)}, jcfg,
        mel_pallas.MelFrontend(jcfg.frontend, interpret=True))["mel"])
    got = step.mel_from_samples(
        {"samples": torch.from_numpy(enc), "mask": torch.from_numpy(mask)},
        MelFrontend(PipelineConfig().frontend))
    assert "samples" not in got and got["mask"].shape == (2, T)
    got = got["mel"].numpy()
    assert got.shape == want.shape == (2, T, 128)
    lin_w, lin_g = np.exp(want), np.exp(got)
    peak = lin_w.max(axis=-1, keepdims=True)
    np.testing.assert_allclose(lin_g / peak, lin_w / peak, atol=1e-5, rtol=0)
    sig = lin_w > peak * 1e-6
    np.testing.assert_allclose(got[sig], want[sig], atol=2e-3, rtol=0)
    decoded = step.decode_wire(torch.from_numpy(enc)).numpy()
    host = {"i16": lambda: enc.astype(np.float32) / 32768.0,
            "mulaw": lambda: mulaw_decode_np(enc), "f32": lambda: x}[wire]()
    np.testing.assert_allclose(decoded, host, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["english_sentences", "bake"])
def test_synth_batches_equal_jax(mode):
    """The first two ``SynthBatcher`` batches (one producer thread, a seed)
    with English sentences at p 0.65 (English draws pinned at 0.5, so the
    sentence bank is drawn from) and in bake mode: equal element for element
    to the JAX module's. A bake batch carries ``n_samples`` and exact zeros
    past it (no additive noise)."""
    if mode == "bake":
        kw = dict(BAKE, batch_size=3)
        cfg, jcfg = tiny_config(), jax_tiny_config()
    else:
        kw = dict(batch_size=3, window_seconds=3.0, seed=11, n_threads=1,
                  english_fraction=0.5, english_sentence_p=0.65)
        cfg, jcfg = PipelineConfig(), JaxConfig()
    got = _first_batches(synth.SynthBatcher(cfg, **kw), 2)
    want = _first_batches(jax_synth.SynthBatcher(jcfg, **kw), 2)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if mode == "bake":
        n = got[0]["n_samples"]
        assert n.dtype == np.int32 and (n > 0).all()
        for b in range(len(n)):
            assert not got[0]["samples"][b, n[b]:].any()
    else:
        assert "n_samples" not in got[0]


@pytest.fixture(scope="module")
def bake_batches():
    """Four bake-mode batches of 4 (tiny config, 2 s windows) from the
    port's batcher."""
    return _first_batches(synth.SynthBatcher(tiny_config(), **BAKE), 4)


@pytest.mark.parametrize("wire", ["i16", "mulaw"])
def test_build_pool_equals_jax(bake_batches, wire):
    """``build_pool`` of 6 entries over the same bake batches at both wires
    (int16 and uint8 mu-law samples): equal to the JAX function's; a batch
    without ``n_samples`` is refused."""
    got = device_pool.build_pool(iter(bake_batches), 6, wire=wire)
    want = jax_pool.build_pool(iter(bake_batches), 6, wire=wire)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["samples"].dtype == (np.uint8 if wire == "mulaw"
                                    else np.int16)
    assert got["samples"].shape[0] == 6 == got["n_samples"].shape[0]
    plain = [{k: v for k, v in bake_batches[0].items() if k != "n_samples"}]
    with pytest.raises(ValueError, match="bake_mode"):
        device_pool.build_pool(iter(plain), 4)


def test_pool_step_equals_host_batch_step(bake_batches):
    """With on-device augmentation off (``snr_range=None``), one pool step
    on rows [1, 3, 0, 6] of a mu-law pool is the host-batch train step fed
    those rows on the same wire: the same loss and the same updated
    parameters (the same operations; 1e-6 relative allows for thread
    scheduling in the CPU's reductions)."""
    cfg = tiny_config()
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    pool_np = device_pool.build_pool(iter(bake_batches), 8, wire="mulaw")
    pool = device_pool.pool_to_device(pool_np, "cpu")
    init, pstep, _, _ = device_pool.make_pool_train_step(
        cfg, "cpu", tx=step.make_optimizer(**kw), with_translator=True,
        snr_range=None)
    _, tstep, _ = step.make_train_step(cfg, "cpu",
                                       tx=step.make_optimizer(**kw),
                                       from_samples=True,
                                       with_translator=True)
    p0 = init(1).params
    idx = np.array([1, 3, 0, 6])
    pa = step.tree_map(lambda t: t.detach().clone().requires_grad_(True), p0)
    pb = step.tree_map(lambda t: t.detach().clone().requires_grad_(True), p0)
    pa, _, _, ma = pstep(pa, step.make_optimizer(**kw).init(pa), pool,
                         torch.from_numpy(idx), 0, dict(SCALARS))
    host = {k: torch.from_numpy(v[idx]) for k, v in pool_np.items()
            if k != "n_samples"}
    pb, _, _, mb = tstep(pb, step.make_optimizer(**kw).init(pb),
                         dict(host, **SCALARS), 0)
    assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-6 * abs(
        float(mb["loss"]))
    for a, b in zip(step.tree_leaves(pa), step.tree_leaves(pb)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_pool_step_with_jax_draws_matches_jax(bake_batches):
    """One pool step (mu-law pool, on-device gain and noise at SNR 15-40 dB,
    the joint translator on: the pool trainer's ``{"asr", "translator"}``
    tree carried across) against the JAX ``pool_step`` on a one-device CPU
    mesh from the same parameters, with the JAX step's gain, SNR and noise
    passed in: the loss within ``testing.TRAINER_LOSS_REL``. The port's own
    draws at another step give another loss (fresh noise a step); past
    each row's ``n_samples`` the augmented samples are the gained wire
    samples, without noise (mu-law's zero code decodes to 7.7e-5)."""
    jcfg = jax_tiny_config().replace(mesh=MeshConfig(data=1, model=1))
    cfg = tiny_config()
    kw = dict(lr=1e-3, warmup_steps=1, decay_steps=10)
    pool_np = device_pool.build_pool(iter(bake_batches), 8, wire="mulaw")
    init, jstep, _ = jax_pool.make_pool_train_step(
        jcfg, build_mesh(jcfg.mesh), tx=jax_step.make_optimizer(**kw),
        with_translator=True)
    state = init(seed=2)
    params = zoo.params_from_jax(jax.device_get(state.params))
    idx = np.array([5, 2, 2, 7])
    s = 3
    _, _, _, jm = jstep(state.params, state.opt_state,
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
    _, _, _, lg = device_pool.make_pool_train_step(cfg, "cpu",
                                                   with_translator=True)
    pool = device_pool.pool_to_device(pool_np, "cpu")
    m, _ = lg(step.tree_map(lambda t: t.requires_grad_(True), params), pool,
              torch.from_numpy(idx), s, dict(SCALARS), draws)
    want = float(jm["loss"])
    assert abs(float(m["loss"]) - want) <= testing.TRAINER_LOSS_REL * want
    m2, _ = lg(params, pool, torch.from_numpy(idx), s + 1, dict(SCALARS))
    assert float(m2["loss"]) != float(m["loss"])
    clean = step.decode_wire(pool["samples"][idx])
    x = device_pool.augment_samples(clean, pool["n_samples"][idx], *draws)
    for r, i in enumerate(idx):
        n = int(pool_np["n_samples"][i])
        torch.testing.assert_close(x[r, n:], clean[r, n:] * draws[0][r],
                                   rtol=0, atol=0)
        assert not torch.equal(x[r, :n], clean[r, :n] * draws[0][r])


def test_refresh_pool_overwrites_exactly_its_slice(bake_batches):
    """``refresh_pool(pool, 4, new)`` copies a fresh batch into rows [4, 8)
    of every pool tensor, in place (the same storage), and leaves the other
    rows as they were."""
    pool_np = device_pool.build_pool(iter(bake_batches[:3]), 12, wire="i16")
    pool = device_pool.pool_to_device(pool_np, "cpu")
    ptrs = {k: v.data_ptr() for k, v in pool.items()}
    nb = bake_batches[3]
    new = {k: (device_pool.encode_wire(v, "i16") if k == "samples" else v)
           for k, v in nb.items()}
    _, _, refresh, _ = device_pool.make_pool_train_step(tiny_config(), "cpu")
    out = refresh(pool, 4, new)
    assert out is pool
    for k, v in pool.items():
        assert v.data_ptr() == ptrs[k], k
        np.testing.assert_array_equal(v[4:8].numpy(), new[k], err_msg=k)
        np.testing.assert_array_equal(v[:4].numpy(), pool_np[k][:4])
        np.testing.assert_array_equal(v[8:].numpy(), pool_np[k][8:])


class _NoEval:
    def __init__(self, *args, **kwargs):
        pass

    def run(self, params):
        return {"synth": {"wer": 1.0, "cer": 1.0}}


def test_train_synth_device_pool_draws_the_jax_rows(monkeypatch):
    """``train_synth(device_pool=5, wire="mulaw")`` on the CPU: the pool
    rounds up to 6 (a multiple of the batch), lives at uint8, and each step
    takes the rows the JAX trainer's host index stream draws
    (``default_rng(seed + 104729)``); a refresh every 2 steps overwrites
    rows in place."""
    seen = []
    make = synth_train.make_pool_train_step

    def watching(*args, **kwargs):
        init, pstep, refresh, lg = make(*args, **kwargs)

        def watched(params, opt_state, pool, idx, i, scalars, draws=None):
            seen.append((idx.numpy().copy(), pool["samples"].dtype,
                         pool["samples"].shape[0],
                         sorted(scalars[step.CTC_INFEASIBLE].tolist())))
            return pstep(params, opt_state, pool, idx, i, scalars, draws)
        return init, watched, refresh, lg

    monkeypatch.setattr(synth_train, "make_pool_train_step", watching)
    monkeypatch.setattr(synth_train, "Evaluator", _NoEval)
    synth_train.train_synth(steps=3, batch_size=2, cfg=tiny_config(),
                            window_seconds=1.0, seed=5, device="cpu",
                            device_pool=5, pool_refresh_every=2,
                            wire="mulaw", english_sentences=0.65,
                            eval_every=100)
    rng = np.random.default_rng(5 + 104729)
    assert len(seen) == 3
    for idx, dtype, n, bad in seen:
        np.testing.assert_array_equal(idx, rng.integers(0, 6, 2))
        assert dtype == torch.uint8 and n == 6
        assert all(0 <= r < 2 for r in bad)
