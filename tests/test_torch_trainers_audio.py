"""PyTorch port: the audio trainers (x-vector, audio-mode translator,
summarizer) against the JAX package's, on the CPU.

Each whole run starts both packages' trainer from the same parameters: the
JAX trainer's own init is captured as it returns (``monkeypatch`` on the
JAX module) and handed to the port's trainer as ``init_params``. The data
are held bit for bit by recording, in each package, the module functions
the trainer calls in order (the windows, the utterances, the targets); the
frozen encoders' outputs, the losses, the eval numbers and the saved
parameters by the tolerances stated in ``omnilingual_asr_torch/testing.py``
(``TRAINER_*``). The JAX log-mel runs in interpret mode, as the JAX
package's own tests run it on the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as T
from omnilingual_asr_torch.config import PipelineConfig, tiny_config
from omnilingual_asr_torch.models import conformer, translation, xvector, zoo
from omnilingual_asr_torch.models.zoo import load_xvector
from omnilingual_asr_torch.train import (summary_train, translator_train,
                                         xvector_train)
from omnilingual_asr_tpu.config import PipelineConfig as JaxPipelineConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import translation as jax_translation
from omnilingual_asr_tpu.models import xvector as jax_xvector
from omnilingual_asr_tpu.train import summary_train as jax_summary_train
from omnilingual_asr_tpu.train import translator_train as jax_translator_train
from omnilingual_asr_tpu.train import xvector_train as jax_xvector_train

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """The trainers' ``main`` installs a SIGTERM handler: restore the
    worker's own after each test."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {k: v.detach().float().cpu().numpy()
            for k, v in zoo.flatten(tree).items()}


def _assert_params_close(got: dict, want: dict):
    """Per-leaf relative L2 within TRAINER_PARAM_REL (same leaves)."""
    assert set(got) == set(want)
    for k in want:
        nw = float(np.linalg.norm(want[k]))
        d = float(np.linalg.norm(got[k] - want[k]))
        assert (d / nw if nw > 0 else d) <= T.TRAINER_PARAM_REL, k


def _assert_losses_close(got, want_lines, key):
    """The port's loss a step against the JAX trainer's printed one (4
    decimals): within TRAINER_LOSS_REL plus the print's rounding."""
    want = [x[key] for x in want_lines if key in x]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= T.TRAINER_LOSS_REL * abs(w) + 5e-5


def _capture_init(monkeypatch, module, name):
    """Wraps ``module.name`` (a JAX init) so that the result of its first
    call (the trainer's; a loader traces it later) is kept as numpy
    arrays in the returned dict under "init"."""
    got = {}
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        p = inner(*args, **kwargs)
        if "init" not in got:
            got["init"] = jax.tree.map(np.asarray, p)
        return p

    monkeypatch.setattr(module, name, wrapped)
    return got


def _record(monkeypatch, module, name, into: list, keep=lambda a, r: r):
    """Wraps ``module.name`` so that each call appends ``keep(args,
    result)`` to ``into``."""
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        into.append(keep(args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def _jax_lines(fn, **kwargs):
    """Runs a JAX trainer; returns (its result, its JSON stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(**kwargs)
    return out, [json.loads(x) for x in buf.getvalue().splitlines()
                 if x.startswith("{")]


@pytest.fixture(scope="module")
def tiny_asr(tmp_path_factory):
    """A seeded tiny ASR checkpoint (``.npz`` with its ``config.json``)
    that both packages' ``load_checkpoint`` read."""
    d = tmp_path_factory.mktemp("tiny_asr")
    cfg = tiny_config()
    zoo.save_checkpoint(d / "asr.npz", conformer.asr_init(
        torch.Generator().manual_seed(3), cfg))
    (d / "config.json").write_text(cfg.to_json())
    return d / "asr.npz"


# ---------------------------------------------------------------------------
# x-vector
# ---------------------------------------------------------------------------

def test_xvector_init_and_pooled_match_jax():
    """``xvector_init`` gives the JAX init's tree (names, shapes); on the
    JAX init, ``xvector_pooled`` of a ragged batch and its gradient with
    respect to every leaf agree with the JAX function's: embeddings within
    TRAINER_EMBED_TOL, gradients within TRAINER_GRAD_REL per leaf."""
    cfg = PipelineConfig()
    jp = jax_xvector.xvector_init(jax.random.PRNGKey(5), JaxPipelineConfig())
    mine = xvector.xvector_init(torch.Generator().manual_seed(5), cfg)
    assert {k: v.shape for k, v in _flat_jax(jp).items()} == \
        {k: tuple(v.shape) for k, v in _flat_port(mine).items()}
    rng = np.random.default_rng(0)
    mel = rng.normal(-4.0, 2.0, (3, 64, 128)).astype(np.float32)
    mask = np.arange(64)[None, :] < np.array([64, 41, 9])[:, None]
    labels = np.array([3, 700, 1023])

    def jloss(p):
        e = jax_xvector.xvector_pooled(p, jnp.asarray(mel), jnp.asarray(mask))
        from omnilingual_asr_tpu.train.step import aam_softmax_loss
        return aam_softmax_loss(e, jnp.asarray(labels), p["aam"]), e

    (_, je), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    pp = zoo.params_from_jax(jp)
    for t in zoo.flatten(pp).values():
        t.requires_grad_(True)
    pe = xvector.xvector_pooled(pp, torch.from_numpy(mel),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(pe.detach().numpy(), np.asarray(je),
                               atol=T.TRAINER_EMBED_TOL)
    from omnilingual_asr_torch.train.step import aam_softmax_loss
    loss = aam_softmax_loss(pe, torch.from_numpy(labels), pp["aam"])
    loss.backward()
    want = _flat_jax(jg)
    for k, t in zoo.flatten(pp).items():
        g = t.grad.numpy()
        nw = float(np.linalg.norm(want[k]))
        assert float(np.linalg.norm(g - want[k])) <= \
            T.TRAINER_GRAD_REL * nw + 1e-12, k


def test_xvector_run_matches_jax(monkeypatch, tmp_path):
    """2 steps at batch 8 (``PipelineConfig()``'s x-vector) from the JAX
    init: the same eval set and batches (every 4 s window, its length and
    every speaker drawn, in order, bit for bit), the loss a step, the
    held-out eval numbers, the saved parameters; the port's saved file
    loads in the JAX ``load_xvector`` with the same values."""
    init = _capture_init(monkeypatch, jax_xvector, "xvector_init")
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jax_xvector_train), ("port", xvector_train)):
        _record(monkeypatch, mod, "_to_window", seen[name],
                lambda a, r: (r[0].copy(), r[1]))
        _record(monkeypatch, mod, "_draw", seen[name],
                lambda a, r: (a[1], r.copy()))
    kw = dict(steps=2, batch_size=8, log_every=1)
    jparams, lines = _jax_lines(jax_xvector_train.train_xvector,
                                ckpt_dir=str(tmp_path / "jax"), **kw)
    params, run = xvector_train.train_xvector(
        ckpt_dir=str(tmp_path / "port"), device="cpu",
        init_params=zoo.params_from_jax(init["init"]), **kw)

    assert len(seen["jax"]) == len(seen["port"]) > 48 + 16
    for (a, x), (b, y) in zip(seen["jax"], seen["port"]):
        assert a == b if np.isscalar(a) else np.array_equal(a, b)
        np.testing.assert_array_equal(x, y)
    rows = np.stack([r for r, _ in seen["port"] if isinstance(r, np.ndarray)
                     and r.shape == (64000,)][:4])
    np.testing.assert_array_equal(
        xvector_train.to_wire(rows),
        np.clip(rows * 32768.0, -32768, 32767).astype(np.int16))
    _assert_losses_close(run.losses, lines, "aam")
    want = [x["eval"] for x in lines if "eval" in x]
    assert len(run.evals) == len(want) == 1
    for k in ("intra_mean", "inter_mean"):
        assert abs(run.evals[0][k] - want[0][k]) <= T.TRAINER_DIST_TOL
    assert abs(run.evals[0]["viol"] - want[0]["viol"]) <= T.TRAINER_VIOL_TOL
    _assert_params_close(_flat_port(params), _flat_jax(jparams))

    path = tmp_path / "port" / "xvector.npz"
    theirs = _flat_jax(jax_xvector.load_xvector(path, JaxPipelineConfig()))
    mine = _flat_port(load_xvector(path, PipelineConfig()))
    for k, v in _flat_port(params).items():
        np.testing.assert_array_equal(mine[k], v.astype(np.float16))
        np.testing.assert_array_equal(theirs[k], mine[k])


# ---------------------------------------------------------------------------
# Audio-mode translator
# ---------------------------------------------------------------------------

def test_audio_translator_run_matches_jax(monkeypatch, tmp_path, tiny_asr):
    """2 steps from the JAX init over a tiny seeded ASR checkpoint (8
    training and 4 held-out utterances, batch 4): every target
    (``encode_target``) and every batch of utterances the frozen encoder
    takes, bit for bit; ``UtteranceEncoder``'s bf16 states within
    TRAINER_STATE_TOL of the JAX encoder's and its masks equal; the loss a
    step, the held-out word accuracy and the saved parameters; the port's
    ``.npz`` loads in the JAX ``load_translator`` with the same values."""
    init = _capture_init(monkeypatch, jax_translator_train, "translator_init")
    saved = {}
    monkeypatch.setattr(jax_translator_train, "save_translator",
                        lambda path, p: saved.update(p=p))
    targets = {"jax": [], "port": []}
    banks = {"jax": [], "port": []}
    for name, mod in (("jax", jax_translator_train),
                      ("port", translator_train)):
        _record(monkeypatch, mod, "encode_target", targets[name],
                lambda a, r: (a[0], *r))
        _record(monkeypatch, mod.UtteranceEncoder, "encode_batch",
                banks[name], lambda a, r: (
                    [u.copy() for u in a[1]], str(r[0].dtype),
                    np.asarray(r[0]).astype(np.float32)
                    if isinstance(r[0], np.ndarray) else r[0].float().numpy(),
                    np.asarray(r[1])))
    kw = dict(asr_ckpt=str(tiny_asr), steps=2, batch_size=4, n_train=8,
              n_eval=4, log_every=1)
    (jparams, jacc), lines = _jax_lines(
        jax_translator_train.train_translator, out_dir=str(tmp_path / "j"),
        cfg=jax_tiny_config(), **kw)
    params, run = translator_train.train_translator(
        out_dir=str(tmp_path / "p.npz"), cfg=tiny_config(), device="cpu",
        init_params=zoo.params_from_jax(init["init"]), **kw)

    assert len(targets["jax"]) == len(targets["port"]) == 12
    for a, b in zip(targets["jax"], targets["port"]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    assert len(banks["jax"]) == len(banks["port"]) == 1
    (ju, jd, je, jm), (pu, pd, pe, pm) = banks["jax"][0], banks["port"][0]
    for x, y in zip(ju, pu):
        np.testing.assert_array_equal(x, y)
    assert (jd, pd) == ("bfloat16", "torch.bfloat16")
    np.testing.assert_array_equal(jm, pm)
    assert float(np.abs(pe - je).max()) <= T.TRAINER_STATE_TOL
    _assert_losses_close(run.losses, lines, "ce")
    assert abs(run.evals[-1]["translation_word_acc"] - jacc) <= \
        T.TRANSLATION_ACC_TOL
    _assert_params_close(_flat_port(params), _flat_jax(saved["p"]))
    theirs = _flat_jax(jax_translation.load_translator(
        tmp_path / "p.npz", jax_tiny_config()))
    assert theirs.keys() == _flat_port(params).keys()
    for k, v in _flat_port(params).items():
        np.testing.assert_array_equal(theirs[k], v)


def test_audio_translator_main_warm_starts_on_cpu(tmp_path, tiny_asr,
                                                  capsys):
    """``main`` with ``--device cpu`` over a checkpoint directory, warm
    started from a translator ``.npz`` (``--init-from``): the saved
    decoder is one update away from the file it started from."""
    cfg = tiny_config()
    start = translation.translator_init(torch.Generator().manual_seed(9),
                                        cfg)
    translation.save_translator(tmp_path / "start.npz", start)
    translator_train.main([
        "--ckpt", str(tiny_asr.parent), "--out", str(tmp_path / "out"),
        "--init-from", str(tmp_path / "start.npz"), "--steps", "1",
        "--n-train", "2", "--n-eval", "1", "--batch-size", "2",
        "--device", "cpu"])
    assert "warm-started decoder from" in capsys.readouterr().out
    got = _flat_port(translation.load_translator(
        tmp_path / "out" / "translator.npz", cfg))
    # The first update has learning rate 0: the start comes back.
    for k, v in _flat_port(start).items():
        np.testing.assert_array_equal(got[k], v)


# ---------------------------------------------------------------------------
# Summarizer
# ---------------------------------------------------------------------------

def test_decoder_data_equal_jax():
    """``summary_text``, ``encode_summary`` (with and without a forced
    prefix) and ``facts_score`` equal the JAX functions on a seeded
    stream of facts; the audio translator's ``encode_target`` and
    ``word_accuracy`` on those texts (and an empty one) too."""
    rng = np.random.default_rng(11)
    vocab = tiny_config().vocab
    langs = ["Lisu", "English", "Hausa", "Yoruba"]
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(24):
        facts = {"n_speakers": int(rng.integers(1, 5)),
                 "languages": sorted(rng.choice(langs, int(rng.integers(1, 3)),
                                                replace=False).tolist()),
                 "tone": ("neutral", "happy", "sad", "angry")[
                     int(rng.integers(4))]}
        a = summary_train.summary_text(ra, facts)
        assert a == jax_summary_train.summary_text(rb, facts)
        for n_prefix in (0, int(rng.integers(1, 20))):
            for x, y in zip(
                    summary_train.encode_summary(a, vocab, n_prefix=n_prefix),
                    jax_summary_train.encode_summary(a, vocab,
                                                     n_prefix=n_prefix)):
                np.testing.assert_array_equal(x, y)
        for hyp in (a, a.upper(), a.replace("speakers", "people"), ""):
            assert summary_train.facts_score(hyp, facts) == \
                jax_summary_train.facts_score(hyp, facts)
            assert translator_train.word_accuracy(hyp, a) == \
                jax_translator_train.word_accuracy(hyp, a)
            assert translator_train.word_accuracy(a, hyp) == \
                jax_translator_train.word_accuracy(a, hyp)
        for x, y in zip(translator_train.encode_target(a, vocab),
                        jax_translator_train.encode_target(a, vocab)):
            np.testing.assert_array_equal(x, y)


def test_summarizer_run_matches_jax(monkeypatch, tmp_path, tiny_asr):
    """2 steps from the JAX init over the tiny ASR checkpoint (a pool of
    24 utterances, 6 training and 2 held-out conversations, batch 4):
    every conversation ``WindowEncoder`` takes bit for bit and its pooled
    memory within TRAINER_POOL_TOL of the JAX encoder's (the same windows
    used); the loss a step, the fact accuracies of the greedy eval under
    the forced prefix, the saved parameters with the ``fact_cond`` marker;
    the port's ``.npz`` loads in the JAX ``load_translator``."""
    init = _capture_init(monkeypatch, jax_summary_train, "translator_init")
    saved = {}
    monkeypatch.setattr(jax_summary_train, "save_translator",
                        lambda path, p: saved.update(p=p))
    mems = {"jax": [], "port": []}
    for name, mod in (("jax", jax_summary_train), ("port", summary_train)):
        _record(monkeypatch, mod.WindowEncoder, "encode", mems[name],
                lambda a, r: (a[1].copy(), np.asarray(
                    r[0].cpu() if torch.is_tensor(r[0]) else r[0]), r[1]))
    kw = dict(asr_ckpt=str(tiny_asr), steps=2, batch_size=4, pool_size=24,
              n_train=6, n_eval=2, log_every=1)
    agg, lines = _jax_lines(jax_summary_train.train_summarizer,
                            out_dir=str(tmp_path / "j"),
                            cfg=jax_tiny_config(), **kw)
    params, run = summary_train.train_summarizer(
        out_dir=str(tmp_path / "p"), cfg=tiny_config(), device="cpu",
        init_params=zoo.params_from_jax(init["init"]), **kw)

    assert len(mems["jax"]) == len(mems["port"]) == 8
    for (xa, ma, na), (xb, mb, nb) in zip(mems["jax"], mems["port"]):
        np.testing.assert_array_equal(xa, xb)
        assert na == nb
        assert float(np.abs(ma - mb).max()) <= T.TRAINER_POOL_TOL
    _assert_losses_close(run.losses, lines, "ce")
    assert run.evals[-1]["eval_fact_accuracy"] == agg
    want = _flat_jax(saved["p"])
    _assert_params_close(_flat_port(params), want)
    assert "['fact_cond']" in want
    path = tmp_path / "p" / "summarizer.npz"
    theirs = _flat_jax(jax_translation.load_translator(
        path, jax_tiny_config(), n_layers=2))
    mine = _flat_port(translation.load_translator(path, tiny_config(),
                                                  n_layers=2))
    assert theirs.keys() == mine.keys() == _flat_port(params).keys()
    for k, v in _flat_port(params).items():
        np.testing.assert_array_equal(theirs[k], v)
        np.testing.assert_array_equal(mine[k], v)


def test_summarizer_main_runs_on_cpu_tiny(tmp_path, tiny_asr):
    """``main --device cpu --tiny`` trains and writes
    ``<out>/summarizer.npz``, which the port's ``SummaryDecoder`` reads
    as fact-conditioned."""
    from omnilingual_asr_torch.models.summarizer import SummaryDecoder

    summary_train.main([
        "--ckpt", str(tiny_asr), "--out", str(tmp_path), "--tiny",
        "--steps", "1", "--pool-size", "12", "--n-train", "2",
        "--n-eval", "1", "--batch-size", "2", "--device", "cpu"])
    params = translation.load_translator(tmp_path / "summarizer.npz",
                                         tiny_config(), n_layers=2)
    assert SummaryDecoder(tiny_config(), params).fact_conditioned
