"""PyTorch port: the text translator trainer, its real-pair corpus, the
trainers' optimizer chains, the SIGTERM exit and the watchdog, against the
JAX package's, on the CPU.

The data are held bit for bit (the pair generators, the real-pair corpus
and its split, every pair a run encodes, in order); the optimizer chains
against optax on the same gradients, planted NaNs included; a whole run of
2 steps from the JAX trainer's captured init by the tolerances stated in
``omnilingual_asr_torch/testing.py`` (``TRAINER_*``). Each trainer's
``main`` installs the SIGTERM exit and raises before any work without a
card. The watchdog's decision table and supervisor run in both packages
on the JAX package's own fabricated states (``tests/test_watchdog.py``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omnilingual_asr_torch import testing as T
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import translation, zoo
from omnilingual_asr_torch.train import real_pairs, step
from omnilingual_asr_torch.train import text_translator_train as tt
from omnilingual_asr_torch.utils import term, watchdog
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import translation as jax_translation
from omnilingual_asr_tpu.train import real_pairs as jax_real_pairs
from omnilingual_asr_tpu.train import step as jax_step
from omnilingual_asr_tpu.train import text_translator_train as jax_tt
from omnilingual_asr_tpu.utils import watchdog as jax_watchdog

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MAINS = ("xvector_train", "text_translator_train", "translator_train",
         "summary_train", "synth_train")


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


def _main(name):
    import importlib

    return importlib.import_module(f"omnilingual_asr_torch.train.{name}").main


@pytest.fixture(scope="module")
def corpus():
    """The real-pair corpus where ``humanize`` and ``babel`` give pairs,
    else None (the synthetic draws are then held without it)."""
    return tt.real_corpus()


# ---------------------------------------------------------------------------
# Optimizer chains
# ---------------------------------------------------------------------------

def _optax_chains():
    """Each trainer's chain in both packages, the optax one as the JAX
    trainer builds it; learning rates at which the second update's rate is
    1000, so that an update with zero gradients (Adam's part 0) moves each
    parameter by 1000 times its weight decay."""
    def sched(lr, warmup, decay):
        return optax.warmup_cosine_decay_schedule(0.0, lr, warmup, decay,
                                                  lr * 0.05)

    steps = 10
    return {
        # xvector_train.py: make_optimizer(lr, warmup 300, decay
        # max(steps, 1000))
        "xvector": (step.make_optimizer(lr=3e5, warmup_steps=300,
                                        decay_steps=1000),
                    jax_step.make_optimizer(lr=3e5, warmup_steps=300,
                                            decay_steps=1000)),
        # text_translator_train.py:386-391, translator_train.py:233-238
        "translator": (step.make_translator_optimizer(2e3, steps),
                       optax.chain(optax.clip_by_global_norm(1.0),
                                   optax.zero_nans(),
                                   optax.adamw(sched(2e3, min(200, max(
                                       1, steps // 5)), steps),
                                       weight_decay=1e-6))),
        # summary_train.py:282-284: no zero_nans, optax's default decay
        "summarizer": (step.make_summarizer_optimizer(2e5, steps),
                       optax.chain(optax.clip_by_global_norm(1.0),
                                   optax.adamw(sched(2e5, 200,
                                                     max(steps, 201))))),
    }


@pytest.mark.parametrize("planted", [None, np.nan])
@pytest.mark.parametrize("chain", ["xvector", "translator", "summarizer"])
def test_optimizer_chain_matches_optax(chain, planted):
    """Four updates of each trainer's chain against optax on the same
    gradients: the first two all zeros (so the second update, the first
    at a nonzero rate, is the weight decay alone: within 1e-3 relative of
    optax's, so 1e-4 against 1e-6 shows), the third with one planted
    NaN. NaN where optax has NaN (the summarizer's chain has no
    ``zero_nans``, so a NaN reaches every parameter), elsewhere within
    1e-4 relative plus 1e-5 of the leaf's largest value (measured at most
    3.8e-4 relative, on an element that moved by ~3000 to -22: optax
    takes Adam's bias corrections, 1 - 0.999^t, in f32, the port in f64,
    ~1e-5 apart)."""
    port_tx, jax_tx = _optax_chains()[chain]
    rng = np.random.default_rng(8)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = jax_tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in init.items()}
    ts = port_tx.init(tp)
    n_nan = 0
    for i in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
             * (i >= 2) for k, v in init.items()}
        if i == 2 and planted is not None:
            g["b"][1] = planted
        before = {k: (tp[k].detach().numpy().astype(np.float64),
                      np.asarray(jp[k], np.float64)) for k in init}
        upd, js = jax_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp)
        jp = optax.apply_updates(jp, upd)
        port_tx.update(ts, [torch.from_numpy(g[k].copy()) for k in ("a", "b")])
        for k in init:
            got, want = tp[k].detach().numpy(), np.asarray(jp[k])
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            n_nan += int(np.isnan(want).sum())
            scale = float(np.abs(want[np.isfinite(want)]).max(initial=1.0))
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-5 * scale)
            if i == 1:
                np.testing.assert_allclose(got - before[k][0],
                                           want - before[k][1], rtol=1e-3)
    assert n_nan == (34 if chain == "summarizer" and planted else 0)


# ---------------------------------------------------------------------------
# Real pairs
# ---------------------------------------------------------------------------

def test_real_corpus_equals_jax(corpus):
    """Where ``humanize`` and ``babel`` import: the ``.po`` reader, the
    CLDR pairs, the merged corpus with its hash split, and a seeded stream
    of ``draw_real_pair`` from both splits equal the JAX module's."""
    pytest.importorskip("humanize")
    pytest.importorskip("babel")
    text = textwrap.dedent('''\
        # comment
        msgid ""
        msgstr "Plural-Forms: nplurals=2;"

        msgid "%d minute ago"
        msgid_plural "%d minutes ago"
        msgstr[0] "hace %d minuto"
        msgstr[1] "hace %d "
        "minutos"

        msgctxt "0"
        msgid "th"
        msgstr "o"
        ''')
    assert real_pairs._parse_po(text) == jax_real_pairs._parse_po(text)
    assert real_pairs.load_po_pairs() == jax_real_pairs.load_po_pairs()
    for loc in ("es", "hi", "zz"):
        assert real_pairs.load_cldr_pairs(loc) == \
            jax_real_pairs.load_cldr_pairs(loc)
    want = jax_real_pairs.build_real_corpus()
    assert corpus == want and corpus["n_train"] > 0
    for split in ("train", "heldout"):
        ra, rb = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(200):
            assert real_pairs.draw_real_pair(ra, corpus, split) == \
                jax_real_pairs.draw_real_pair(rb, want, split)


def test_no_real_corpus_without_humanize_and_babel(monkeypatch, tmp_path,
                                                   capsys):
    """With ``humanize`` and ``babel`` made unimportable, both packages'
    corpus is empty and the port's trainer takes the reference's path
    without real pairs: ``main --device cpu --tiny`` reports it, evaluates
    no real set and writes an ``.npz`` the JAX ``load_translator`` reads."""
    monkeypatch.setitem(sys.modules, "humanize", None)
    monkeypatch.setitem(sys.modules, "babel", None)
    for mod in (real_pairs, jax_real_pairs):
        c = mod.build_real_corpus()
        assert (c["n_train"], c["n_heldout"], c["languages"]) == (0, 0, [])
    assert tt.real_corpus() is None
    out = tmp_path / "t.npz"
    tt.main(["--out", str(out), "--tiny", "--device", "cpu", "--steps", "1",
             "--batch-size", "4", "--n-eval", "2", "--eval-every", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert any(x.startswith("no real corpus") for x in lines)
    evals = [json.loads(x)["eval"] for x in lines
             if x.startswith("{") and "eval" in x]
    assert evals and not any("translation_word_acc_real_heldout" in e
                             for e in evals)
    mine = _flat_port(translation.load_translator(out, tiny_config()))
    theirs = _flat_jax(jax_translation.load_translator(out, jax_tiny_config()))
    assert mine.keys() == theirs.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])


# ---------------------------------------------------------------------------
# Synthetic pairs
# ---------------------------------------------------------------------------

def test_text_pairs_equal_jax(corpus):
    """The language tables, grammar profiles and inflectors, then a seeded
    stream of ``draw_pair`` (plain, with grammar tables, with the real
    corpus), ``draw_grammar_pair``, ``ctc_noise``, ``encode_pair`` and
    ``make_batch`` (noisy, grammar and real), and ``word_accuracy``, bit
    for bit against the JAX module's."""
    from omnilingual_asr_torch.train.synth import LEXICON_SIZE

    vocab = tiny_config().vocab
    tables, english = tt._lang_tables()
    jtables, jenglish = jax_tt._lang_tables()
    assert (tables, english) == (jtables, jenglish)
    g, jg = (tt._grammar_tables(tables, english),
             jax_tt._grammar_tables(jtables, jenglish))
    assert g == jg
    for w in g["verbs"] + g["nouns"]:
        for f in ("_inflect_3sg", "_inflect_past", "_inflect_plural"):
            assert getattr(tt, f)(w) == getattr(jax_tt, f)(w)
    ra, rb = np.random.default_rng(21), np.random.default_rng(21)
    for i in range(60):
        gi, real = ((None, None), (g, None), (g, corpus))[i % 3]
        a = tt.draw_pair(ra, tables, english, LEXICON_SIZE, gi, real)
        b = jax_tt.draw_pair(rb, jtables, jenglish, LEXICON_SIZE,
                             jg if gi else None, real)
        assert a == b
        assert tt.draw_grammar_pair(ra, g) == \
            jax_tt.draw_grammar_pair(rb, jg)
        na, nb = tt.ctc_noise(ra, a[0]), jax_tt.ctc_noise(rb, b[0])
        assert na == nb
        for x, y in zip(tt.encode_pair(na, a[1], vocab),
                        jax_tt.encode_pair(nb, b[1], vocab)):
            np.testing.assert_array_equal(x, y)
        assert tt.word_accuracy(na, a[1]) == jax_tt.word_accuracy(nb, b[1])
    for x, y in zip(
            tt.make_batch(ra, tables, english, LEXICON_SIZE, vocab, 16,
                          noise=True, g=g, real=corpus),
            jax_tt.make_batch(rb, jtables, jenglish, LEXICON_SIZE, vocab, 16,
                              noise=True, g=jg, real=corpus)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_text_translator_run_matches_jax(monkeypatch, tmp_path):
    """2 steps at batch 8 of the tiny config from the JAX init, with the
    real corpus where it exists: every pair encoded (the eval sets', clean,
    noisy, grammar and real held-out, then the batches') bit for bit and
    in order; the loss a step, every eval number (word accuracies within
    TRANSLATION_ACC_TOL), the saved parameters; the port's ``.npz`` loads
    in the JAX ``load_translator`` with the same values."""
    got = {}
    inner = jax_tt.text_translator_init

    def capture(*args, **kwargs):
        p = inner(*args, **kwargs)
        got.setdefault("init", jax.tree.map(np.asarray, p))
        return p

    monkeypatch.setattr(jax_tt, "text_translator_init", capture)
    monkeypatch.setattr(jax_tt, "save_translator",
                        lambda path, p: got.update(saved=p))
    pairs = {"jax": [], "port": []}
    for name, mod in (("jax", jax_tt), ("port", tt)):
        enc = mod.encode_pair

        def recording(src, tgt, vocab, enc=enc, into=pairs[name]):
            into.append((src, tgt))
            return enc(src, tgt, vocab)

        monkeypatch.setattr(mod, "encode_pair", recording)
    kw = dict(steps=2, batch_size=8, n_eval=8, tiny=True, log_every=1)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_tt.train_translator(str(tmp_path / "j"), **kw)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    params, run = tt.train_translator(
        str(tmp_path / "p.npz"), device="cpu",
        init_params=zoo.params_from_jax(got["init"]), **kw)

    assert pairs["jax"] == pairs["port"] and len(pairs["port"]) >= 3 * 8 + 16
    want = [x["ce"] for x in lines if "ce" in x]
    assert len(run.losses) == len(want) == 2
    for a, b in zip(run.losses, want):
        assert abs(a - b) <= T.TRAINER_LOSS_REL * abs(b) + 5e-5
    jev = [x["eval"] for x in lines if "eval" in x and "step" in x]
    assert len(jev) == len(run.evals) == 1
    assert jev[0].keys() == run.evals[0].keys()
    for k, v in jev[0].items():
        if k.startswith("translation_word_acc"):
            assert abs(run.evals[0][k] - v) <= T.TRANSLATION_ACC_TOL, k
        else:
            assert run.evals[0][k] == v, k
    want = _flat_jax(got["saved"])
    mine = _flat_port(params)
    assert mine.keys() == want.keys()
    for k in want:
        nw = float(np.linalg.norm(want[k]))
        d = float(np.linalg.norm(mine[k] - want[k]))
        assert (d / nw if nw > 0 else d) <= T.TRAINER_PARAM_REL, k
    theirs = _flat_jax(jax_translation.load_translator(tmp_path / "p.npz",
                                                       jax_tiny_config()))
    for k in mine:
        np.testing.assert_array_equal(theirs[k], mine[k])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MAINS)
def test_main_installs_sigterm_exit(monkeypatch, name):
    """Every trainer's ``main`` installs the SIGTERM exit first (here
    before argparse refuses an unknown flag)."""
    calls = []
    monkeypatch.setattr(term, "install_sigterm_exit",
                        lambda: calls.append(1))
    with pytest.raises(SystemExit):
        _main(name)(["--no-such-flag"])
    assert calls == [1]


@pytest.mark.parametrize("name,argv", [
    ("xvector_train", ["--steps", "1", "--ckpt-dir", "{tmp}/x"]),
    ("text_translator_train", ["--out", "{tmp}/t.npz", "--steps", "1"]),
    ("translator_train", ["--ckpt", "{tmp}/asr.npz", "--out", "{tmp}/a"]),
    ("summary_train", ["--ckpt", "{tmp}/asr.npz", "--out", "{tmp}/s",
                       "--tiny"]),
])
def test_main_needs_a_card(name, argv, tmp_path):
    """Without ``--device cpu`` and without a card, each new ``main``
    raises before any work: nothing is read (the ASR checkpoint named does
    not exist) and nothing is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _main(name)([a.format(tmp=tmp_path) for a in argv])
    assert list(tmp_path.iterdir()) == []


def test_sigterm_runs_finally_blocks(tmp_path):
    """A process that installed the port's SIGTERM exit and is killed with
    SIGTERM leaves through its ``finally`` block, with exit code 0."""
    marker = tmp_path / "finally"
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(REPO)!r})
        from omnilingual_asr_torch.utils.term import install_sigterm_exit
        install_sigterm_exit()
        try:
            print("ready", flush=True)
            time.sleep(60)
        finally:
            open({str(marker)!r}, "w").write("ran")
        """)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        proc.kill()
        proc.wait()
    assert marker.read_text() == "ran"


# ---------------------------------------------------------------------------
# Watchdog (the JAX package's tests/test_watchdog.py states, both packages)
# ---------------------------------------------------------------------------

PACKAGES = {"jax": jax_watchdog, "port": watchdog}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("size,age,elapsed,kill,needle", [
    (0, None, 900.0, False, ""),          # (b) inside the start-up envelope
    (0, None, 1620.0, True, "(b)"),       # (b) an empty log past it
    (0, None, 2000.0, True, "empty"),     # a missing log counts as empty
    (4096, 30.0, 7200.0, False, ""),      # (c) fresh metrics
    (4096, 1100.0, 7200.0, False, ""),    # (c) an eval gap below the limit
    (4096, 1700.0, 7200.0, True, "(c)"),  # (c) silent past the limit
    (1 << 20, 10.0, 100_000.0, False, ""),  # elapsed alone never kills
])
def test_should_kill(pkg, size, age, elapsed, kill, needle):
    mod = PACKAGES[pkg]
    policy = mod.WatchdogPolicy(stale_s=1500.0, empty_limit_s=1560.0)
    got, reason = mod.should_kill(log_size=size, log_age_s=age,
                                  elapsed_s=elapsed, policy=policy)
    assert got == kill and needle in reason
    assert (got, reason) == jax_watchdog.should_kill(
        size, age, elapsed, jax_watchdog.WatchdogPolicy(1500.0, 1560.0))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_observe(pkg, tmp_path):
    mod = PACKAGES[pkg]
    size, age, elapsed = mod.observe(tmp_path / "nope.jsonl",
                                     started_at=time.time() - 5.0)
    assert size == 0 and age is None and 4.0 < elapsed < 30.0
    p = tmp_path / "metrics.jsonl"
    p.write_text('{"step": 1}\n')
    size, age, elapsed = mod.observe(p, started_at=time.time() - 5.0)
    assert size > 0 and age is not None and age < 30.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", ["clean_exit", "empty_log", "stale_log"])
def test_watch(pkg, case, tmp_path):
    """The supervisor on real processes: 0 for one that exits on its own,
    97 for one wedged with an empty log or a stale one."""
    mod = PACKAGES[pkg]
    log = tmp_path / "m.jsonl"
    if case == "stale_log":
        log.write_text('{"step": 1}\n')
        old = time.time() - 3600.0
        os.utime(log, (old, old))
    policy = {"clean_exit": mod.WatchdogPolicy(5.0, 5.0),
              "empty_log": mod.WatchdogPolicy(60.0, 1.0),
              "stale_log": mod.WatchdogPolicy(5.0, 600.0)}[case]
    body = "pass" if case == "clean_exit" else "import time; time.sleep(60)"
    proc = subprocess.Popen([sys.executable, "-c", body])
    t0 = time.time()
    rc = mod.watch(proc.pid, log, policy, poll_s=0.2, kill_grace_s=0.2)
    proc.wait(timeout=30)
    assert rc == (0 if case == "clean_exit" else 97)
    assert time.time() - t0 < 30.0
