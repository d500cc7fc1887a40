"""PyTorch port: BEST-RQ pretraining against the JAX package.

Small sizes only (``tiny_config``: d_model 128, 2 layers; a codebook of 512
x 8). The JAX side's random draws (span starts and noise, from
``fold_in(PRNGKey(0), step)``) are rebuilt here with the JAX keys and passed
to the port, whose loss takes them as inputs; the JAX quantizer and
parameters are carried across with ``models.zoo.params_from_jax``.
"""

from __future__ import annotations

import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import MeshConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import zoo as jax_zoo
from omnilingual_asr_tpu.parallel.mesh import build_mesh
from omnilingual_asr_tpu.train import pretrain as jax_pretrain
from omnilingual_asr_tpu.train import pretrain_cli as jax_pretrain_cli
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_tpu.train import synth_train as jax_synth_train
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.train import pretrain, pretrain_cli, step
from omnilingual_asr_torch.train import synth_train

torch.set_num_threads(2)

PCFG = dict(codebook_size=512, codebook_dim=8, mask_prob=0.1, mask_span=3)


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mel(B, T, seed):
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, T * 3 // 4, T // 2,
                                             T][:B])[:, None]
    return mel, mask


def _jax_draws(step_n, B, T, pcfg):
    """The draws of the JAX ``pretrain_loss`` at step ``step_n``: its span
    starts (k1) and its standard-normal noise (k2)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), step_n)
    k1, k2 = jax.random.split(key)
    starts = jax.random.bernoulli(k1, pcfg.mask_prob, (B, T // 4))
    noise = jax.random.normal(k2, (B, T, 128), jnp.float32)
    return np.array(starts), np.array(noise)


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jp = jax_pretrain.PretrainConfig(**PCFG)
    pcfg = pretrain.PretrainConfig(**PCFG)
    jparams = jax_pretrain.pretrain_init(jax.random.PRNGKey(3), jcfg, jp)
    jq = jax_pretrain.make_quantizer(jax.random.PRNGKey(4), jcfg, jp)
    return jcfg, cfg, jp, pcfg, jparams, jq


def test_quantizer_targets_agree_with_jax(case):
    """``quantize_targets`` from the JAX quantizer carried across, on 4 x
    512 mel frames (512 ids) at the tiny codebook and at the default one
    (8192 x 16): the ids equal the JAX ids on at least
    ``testing.MIN_CTC_AGREEMENT`` of the frames (an argmax over codes can
    flip on a near tie across summation orders). The port's own quantizer
    has unit-norm projection columns and codebook rows."""
    jcfg, cfg, jp, pcfg, _, jq = case
    mel, _ = _mel(4, 512, seed=1)
    for jpc, pc, q in ((jp, pcfg, jq), (
            jax_pretrain.PretrainConfig(), pretrain.PretrainConfig(), None)):
        if q is None:
            q = jax_pretrain.make_quantizer(jax.random.PRNGKey(5), jcfg, jpc)
        want = np.asarray(jax_pretrain.quantize_targets(q, jnp.asarray(mel),
                                                        4))
        got = pretrain.quantize_targets(zoo.params_from_jax(q),
                                        torch.from_numpy(mel), 4).numpy()
        assert got.shape == want.shape == (4, 128)
        assert np.mean(got == want) >= testing.MIN_CTC_AGREEMENT
        assert len(np.unique(want)) > 16
    own = pretrain.make_quantizer(torch.Generator().manual_seed(0), cfg, pcfg)
    assert own["proj"].shape == (512, 8) and own["codebook"].shape == (512, 8)
    torch.testing.assert_close(own["proj"].norm(dim=0), torch.ones(8))
    torch.testing.assert_close(own["codebook"].norm(dim=1), torch.ones(512))


def test_span_mask_from_the_same_starts_equals_jax(case):
    """``make_span_mask`` from the JAX function's own Bernoulli starts (the
    same key) equals the JAX mask; the port's draws mask a share near
    mask_prob * span, as the JAX test of the rate asks (0.1-0.35)."""
    _, _, jp, pcfg, _, _ = case
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_pretrain.make_span_mask(key, 8, 500, jp))
    starts = np.array(jax.random.bernoulli(key, jp.mask_prob, (8, 500)))
    got = pretrain.make_span_mask(torch.from_numpy(starts), pcfg).numpy()
    np.testing.assert_array_equal(got, want)
    own = pretrain.make_span_mask(pretrain.span_starts(
        torch.Generator().manual_seed(0), 8, 500, pcfg), pcfg)
    assert 0.1 < float(own.float().mean()) < 0.35


def test_pretrain_loss_matches_jax(case):
    """``pretrain_loss`` with the JAX span starts and noise passed in and
    the JAX targets fed in: the loss within 1e-4 relative (bf16 matmul
    operands rounded from f32 sums in another order, averaged over ~100
    masked frames), the masked-frame count equal and the masked accuracy
    within one frame's share."""
    jcfg, cfg, jp, pcfg, jparams, jq = case
    mel, mask = _mel(4, 512, seed=2)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 5)
    jb = {"mel": jnp.asarray(mel), "mask": jnp.asarray(mask)}
    _, jm = jax_pretrain.pretrain_loss(jparams, jq, jb, key, jcfg, jp)
    starts, noise = _jax_draws(5, 4, 512, jp)
    targets = jax_pretrain.quantize_targets(jq, jb["mel"], 4)
    loss, m = pretrain.pretrain_loss(
        zoo.params_from_jax(jparams), zoo.params_from_jax(jq),
        {"mel": torch.from_numpy(mel), "mask": torch.from_numpy(mask)},
        torch.from_numpy(starts), torch.from_numpy(noise), cfg, pcfg,
        targets=torch.from_numpy(np.array(targets)))
    n = float(jm["masked_frames"])
    assert float(m["masked_frames"]) == n > 80
    assert abs(float(loss) - float(jm["loss"])) <= 1e-4 * float(jm["loss"])
    assert abs(float(m["masked_acc"]) - float(jm["masked_acc"])) <= 1.0 / n


def test_one_pretrain_update_matches_jax(case):
    """One ``make_pretrain_step`` update (learning rate at its peak from the
    first update) against the JAX step on a one-device CPU mesh, from the
    same parameters, quantizer and mel, with the JAX step's draws passed
    in: the loss within ``TRAINER_LOSS_REL`` and the parameters per leaf
    within ``TRAINER_PARAM_REL`` (relative L2; Adam moves each element by
    about lr, and near-zero gradients of the other sign land 2 lr apart)."""
    jcfg, cfg, jp, pcfg, jparams, jq = case
    jcfg = jcfg.replace(mesh=MeshConfig(data=1, model=1))
    kw = dict(lr=1e-3, warmup_steps=0, decay_steps=10)
    mel, mask = _mel(4, 256, seed=3)
    mesh = build_mesh(jcfg.mesh)
    _, jstep = jax_pretrain.make_pretrain_step(
        jcfg, mesh, jp, tx=jax_step.make_optimizer(**kw))
    tparams = step.tree_map(lambda t: t.requires_grad_(True),
                            zoo.params_from_jax(jparams))
    tx = step.make_optimizer(**kw)
    jb = {"mel": jnp.asarray(mel), "mask": jnp.asarray(mask)}
    jout, jo, _, jm = jstep(jax.tree.map(jnp.copy, jparams), jq,
                            jax_step.make_optimizer(**kw).init(jparams), jb,
                            jnp.int32(0))
    _, tstep, _ = pretrain.make_pretrain_step(cfg, "cpu", pcfg, tx=tx)
    starts, noise = _jax_draws(0, 4, 256, jp)
    tout, _, nxt, m = tstep(
        tparams, zoo.params_from_jax(jq), tx.init(tparams),
        {"mel": torch.from_numpy(mel), "mask": torch.from_numpy(mask)}, 0,
        draws=(torch.from_numpy(starts), torch.from_numpy(noise)))
    assert nxt == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        testing.TRAINER_LOSS_REL * float(jm["loss"])
    want = _flat_jax(jout)
    got = {k: v.detach().numpy() for k, v in zoo.flatten(tout).items()}
    assert set(got) == set(want)
    for k in want:       # leaves the loss never reaches stay at zero
        nw = np.linalg.norm(want[k])
        rel = np.linalg.norm(got[k] - want[k]) / (nw if nw > 0 else 1.0)
        assert rel <= testing.TRAINER_PARAM_REL, (k, rel)
    moved = _flat_jax(jparams)
    assert any(not np.array_equal(got[k], moved[k]) for k in got)


def _write_wav(path, x, rate):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def test_real_crop_sampler_draws_equal_jax(tmp_path, monkeypatch):
    """``RealCropSampler`` over two written WAVs (one named gettysburg.wav,
    whose last quarter is held out, one at 8 kHz, resampled), patched into
    ``unique_real_audio`` in both packages: six draws equal element for
    element (both are numpy from the same seed)."""
    rng = np.random.default_rng(8)
    a, b = tmp_path / "gettysburg.wav", tmp_path / "other.wav"
    _write_wav(a, 0.3 * rng.standard_normal(40_000), 16_000)
    _write_wav(b, 0.2 * np.sin(np.arange(24_000) * 0.05), 8_000)
    for mod in (jax_pretrain_cli, pretrain_cli):
        monkeypatch.setattr(mod, "unique_real_audio", lambda: [a, b])
    got = pretrain_cli.RealCropSampler(16_000, seed=3)
    want = jax_pretrain_cli.RealCropSampler(16_000, seed=3)
    assert len(got.recs) == len(want.recs) == 2
    assert len(got.recs[0]) == 30_000
    for _ in range(6):
        (x, n), (y, m) = got.draw(), want.draw()
        assert n == m
        np.testing.assert_array_equal(x, y)


class _NoEval:
    def __init__(self, *args, **kwargs):
        pass

    def run(self, params):
        return {"synth": {"wer": 1.0, "cer": 1.0}}


def test_pretrainer_checkpoint_warm_starts_synth_train(tmp_path,
                                                       monkeypatch):
    """``pretrain_main`` (``--tiny``, 2 steps on the CPU, the mu-law wire
    and English sentences by default) writes ``last/{asr.npz, head.npz,
    config.json, train_state.npz}``; its ``asr.npz`` is the trained
    encoder and both packages' ``load_checkpoint`` read it; ``train_synth
    --init-encoder`` starts from it (one step at learning rate 0 leaves
    the trunk equal to the file). ``--resume-from`` resumes the
    pretrainer's own directory at its step, and the JAX pretrainer's (Orbax
    ``asr/``, ``head.npz``, its ``train_state.npz``) in both trainers, and
    ``train_synth --init-encoder`` takes its ``asr/``: the trunk, head and
    Adam's moments equal the JAX package's restore."""
    cfg = tiny_config()
    ck = tmp_path / "bestrq"
    captured = {}
    make = pretrain_cli.make_pretrain_step

    def capturing(*args, **kwargs):
        init, stp, lg = make(*args, **kwargs)

        def init_state(seed=0):
            captured["state"] = init(seed)
            return captured["state"]
        return init_state, stp, lg

    monkeypatch.setattr(pretrain_cli, "make_pretrain_step", capturing)
    pretrain_cli.pretrain_main(steps=2, batch_size=2, cfg=cfg,
                               window_seconds=1.0, ckpt_dir=str(ck),
                               save_every=2, warmup_steps=1, device="cpu")
    last = ck / "last"
    for name in ("asr.npz", "head.npz", "config.json", "train_state.npz"):
        assert (last / name).is_file(), name
    trained = zoo.flatten(captured["state"][0]["encoder"])
    mine = zoo.flatten(zoo.load_checkpoint(last / "asr.npz", cfg))
    theirs = _flat_jax(jax_zoo.load_checkpoint(last / "asr.npz",
                                               jax_tiny_config()))
    assert set(mine) == set(theirs) == set(trained)
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k])
        np.testing.assert_array_equal(mine[k].numpy(),
                                      trained[k].detach().numpy())
    assert json.loads((last / "config.json").read_text())

    monkeypatch.setattr(synth_train, "Evaluator", _NoEval)
    params, _ = synth_train.train_synth(
        steps=1, batch_size=2, cfg=cfg, window_seconds=1.0, device="cpu",
        init_encoder=str(last / "asr.npz"), eval_every=100)
    for k, v in zoo.flatten(params["asr"]).items():
        np.testing.assert_array_equal(v.detach().numpy(), mine[k].numpy())

    pretrain_cli.pretrain_main(steps=1, batch_size=2, cfg=cfg,
                               window_seconds=1.0, ckpt_dir=str(ck),
                               resume_from=str(last), total_steps=3,
                               warmup_steps=1, device="cpu")
    assert int(np.load(last / "train_state.npz")["__step__"]) == 3

    # The JAX pretrainer's directory, written with the JAX package's own
    # save functions on an init tree: Orbax asr/, head.npz, train_state.npz
    # (Adam's moments random, so that their order is checked).
    orbax = tmp_path / "orbax"
    jinit = step.tree_map(lambda t: t.detach().numpy(), pretrain.pretrain_init(
        torch.Generator().manual_seed(0), cfg,
        pretrain.PretrainConfig()))             # pretrain_main's own
    jax_zoo.save_checkpoint(orbax / "asr", jinit["encoder"])
    np.savez(orbax / "head.npz", **jinit["head"])
    tx = jax_step.make_optimizer()
    rng = np.random.default_rng(0)
    state = tx.init(jinit)
    adam = state[2][0]._replace(
        count=np.asarray(4, np.int32),
        mu=jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32), jinit),
        nu=jax.tree.map(lambda x: rng.random(x.shape).astype(np.float32),
                        jinit))
    state = (state[0], state[1], (adam,) + tuple(state[2][1:]))
    jax_synth_train.save_train_state(orbax / "train_state.npz", state, 4,
                                     0.0)
    pretrain_cli.pretrain_main(steps=1, batch_size=2, cfg=cfg,
                               window_seconds=1.0, device="cpu",
                               resume_from=str(orbax), total_steps=4,
                               warmup_steps=1)
    params, opt = captured["state"][0], captured["state"][2]
    want = _flat_jax(jax_zoo.load_checkpoint(orbax / "asr",
                                             jax_tiny_config()))
    got = zoo.flatten(params["encoder"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].detach().numpy(), want[k])
    for k in ("w", "b"):
        np.testing.assert_array_equal(params["head"][k].detach().numpy(),
                                      jinit["head"][k])
    jopt, jstep, _ = jax_synth_train.load_train_state(
        orbax / "train_state.npz", tx.init(jinit))
    mu, nu = _flat_jax(jopt[2][0].mu), _flat_jax(jopt[2][0].nu)
    for k, p in zip(zoo.flatten(params), opt.leaves):
        np.testing.assert_array_equal(opt.opt.state[p]["exp_avg"].numpy(),
                                      mu[k])
        np.testing.assert_array_equal(
            opt.opt.state[p]["exp_avg_sq"].numpy(), nu[k])
    assert opt.count == jstep == 4
    # synth_train from the same directory: the trunk from asr/, a fresh
    # joint translator (none saved) and optimizer (the pretrainer's state
    # is another optimizer's), as the reference resumes.
    # ... and --init-encoder from its Orbax asr/.
    for kw in ({"resume_from": str(orbax)},
               {"init_encoder": str(orbax / "asr")}):
        params, _ = synth_train.train_synth(
            steps=0, batch_size=2, cfg=cfg, window_seconds=1.0,
            device="cpu", eval_every=100, warmup_steps=1, **kw)
        got = zoo.flatten(params["asr"])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].detach().numpy(), want[k])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pretrain_cli.pretrain_main(steps=1, batch_size=2, cfg=cfg)


class _Parsed(Exception):
    pass


def _cli_options(main, monkeypatch):
    """{option: default} of the parser that ``main`` builds (stopped at
    ``parse_args``)."""
    import argparse

    def stop(self, *args, **kwargs):
        raise _Parsed({a.option_strings[0]: a.default for a in self._actions
                       if a.option_strings and a.dest != "help"})

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        m.setattr("sys.argv", ["x"])
        with pytest.raises(_Parsed) as e:
            main()
    return e.value.args[0]


def test_pretrain_cli_flags_and_defaults_equal_jax(monkeypatch):
    """``pretrain_cli.main`` has the JAX CLI's flags with the same
    defaults, plus ``--device``."""
    import signal

    old = signal.getsignal(signal.SIGTERM)
    try:
        got = _cli_options(pretrain_cli.main, monkeypatch)
        want = _cli_options(jax_pretrain_cli.main, monkeypatch)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert got.pop("--device") is None
    assert got == want
