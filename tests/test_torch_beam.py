"""PyTorch port: the prefix beam search (``ops/beam.py``), the lexicon LM
(``ops/lexicon.py``), the English sentence bank (``train/english_text.py``)
and the engine's top-K feed, against the JAX package's.

All inputs come from numpy seeds. The beams must carry the JAX search's
prefixes in the same order and scores within 1e-9; the LMs' states and
log-probability deltas must be equal on sampled byte strings.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_torch.config import DecodeConfig, tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine, ctc_topk
from omnilingual_asr_torch.ops import beam, lexicon
from omnilingual_asr_torch.train import english_text
from omnilingual_asr_tpu.ops import beam as jax_beam
from omnilingual_asr_tpu.ops import lexicon as jax_lexicon
from omnilingual_asr_tpu.train import english_text as jax_english_text

torch.set_num_threads(2)

SEED = 1_013


@pytest.fixture(scope="module")
def lms():
    """(port, JAX) pairs of the "synth" unigram and bigram lexicon LMs."""
    return {
        "unigram": (lexicon.synth_lexicon(), jax_lexicon.synth_lexicon()),
        "bigram": (lexicon.synth_lexicon(bigram=True),
                   jax_lexicon.synth_lexicon(bigram=True)),
    }


def _logp(rng, T, V, peaky=True):
    """Seeded log-softmax scores [T, V]; ``peaky`` makes a few classes
    dominate each frame, as a trained CTC head does."""
    x = rng.standard_normal((T, V)) * (4.0 if peaky else 1.0)
    x -= x.max(axis=1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=1, keepdims=True))).astype(
        np.float32)


def _assert_same_beams(got, want):
    assert [b.prefix for b in got] == [b.prefix for b in want]
    for g, w in zip(got, want):
        assert abs(g.score - w.score) <= 1e-9


@pytest.mark.parametrize("case", range(4))
def test_beam_search_equals_jax_without_lm(case):
    rng = np.random.default_rng(SEED + case)
    logp = _logp(rng, 40 + 10 * case, 257, peaky=case % 2 == 0)
    for beam_size, topk in ((1, 8), (4, 8), (8, 8), (16, 4)):
        got = beam.ctc_prefix_beam_search(logp, beam_size=beam_size,
                                          topk=topk)
        want = jax_beam.ctc_prefix_beam_search(logp, beam_size=beam_size,
                                               topk=topk)
        assert len(got) == min(beam_size, len(got)) and got
        _assert_same_beams(got, want)


@pytest.mark.parametrize("kind", ["unigram", "bigram"])
@pytest.mark.parametrize("case", range(3))
def test_beam_search_equals_jax_with_lm(lms, kind, case):
    """Shallow fusion with the synth lexicon: frames that favour the bytes
    of lexicon words (and spaces) so that the LM re-ranks beams."""
    port_lm, jax_lm = lms[kind]
    rng = np.random.default_rng(SEED + 100 + case)
    words = sorted(english_text.english_bank_words())
    text = " ".join(rng.choice(words, 4))
    T = 3 * len(text)
    logp = _logp(rng, T, 257, peaky=False)
    for i, ch in enumerate(text.encode()):
        logp[3 * i, ch + 1] += 3.0            # byte b is class b + 1
        logp[3 * i + 1, rng.integers(1, 257)] += 2.5
    logp -= np.log(np.exp(logp).sum(axis=1, keepdims=True))
    for alpha, bonus in ((0.3, 0.0), (1.0, 0.5)):
        got = beam.ctc_prefix_beam_search(logp, beam_size=8, lm=port_lm,
                                          lm_alpha=alpha, word_bonus=bonus)
        want = jax_beam.ctc_prefix_beam_search(
            logp, beam_size=8, lm=jax_lm, lm_alpha=alpha, word_bonus=bonus)
        _assert_same_beams(got, want)
    plain = beam.ctc_prefix_beam_search(logp, beam_size=8)
    assert [b.prefix for b in plain] != [b.prefix for b in got]


def test_beam_search_finds_the_exhaustive_best():
    """On tiny inputs a wide beam finds the label sequence of highest total
    probability; both packages' exhaustive references agree."""
    rng = np.random.default_rng(SEED + 7)
    for _ in range(4):
        logp = _logp(rng, 5, 4, peaky=False)
        best, score = beam.exhaustive_ctc_best(logp)
        assert (best, score) == jax_beam.exhaustive_ctc_best(logp)
        top = beam.ctc_prefix_beam_search(logp, beam_size=64, topk=4)[0]
        assert top.prefix == best
        assert abs(top.score - score) <= 1e-9


def _byte_strings(rng, n):
    """Lexicon words, bank words, mixed case, OOV bytes, digits,
    punctuation and UTF-8 of the cipher scripts."""
    from omnilingual_asr_torch.train.synth import LANGUAGES, lexicon as lex

    pool = sorted(english_text.english_bank_words())
    for lang in LANGUAGES[:6]:
        pool += lex(lang)[:30]
    out = []
    for i in range(n):
        ws = list(rng.choice(pool, int(rng.integers(1, 6))))
        if i % 3 == 1:
            ws[0] = ws[0].upper()
        if i % 4 == 2:
            ws.append("zqxj" + str(int(rng.integers(100))))
        sep = [" ", ", ", ". ", "  "][i % 4]
        out.append(sep.join(ws).encode("utf-8"))
    out.append(b"")
    out.append(bytes(rng.integers(0, 256, 40).tolist()))
    return out


@pytest.mark.parametrize("kind", ["unigram", "bigram"])
def test_lexicon_scores_equal_jax(lms, kind):
    """Each byte's (state, delta) and the finalize result are the JAX LM's,
    exactly, on sampled byte strings."""
    port_lm, jax_lm = lms[kind]
    assert port_lm.children == jax_lm.children
    assert port_lm.word_logp == jax_lm.word_logp
    rng = np.random.default_rng(SEED + 200)
    n_words = 0
    for data in _byte_strings(rng, 60):
        sp, sj = port_lm.start(), jax_lm.start()
        assert sp == sj
        for b in data:
            (sp, dp), (sj, dj) = port_lm.advance(sp, b), jax_lm.advance(sj, b)
            assert sp == sj and dp == dj
        assert port_lm.finalize(sp) == jax_lm.finalize(sj)
        n_words += port_lm.finalize(sp)[0]
    assert n_words > 100
    if kind == "bigram":
        assert port_lm.big_counts == jax_lm.big_counts
        assert port_lm.ctx_counts == jax_lm.ctx_counts
        assert port_lm.node_wid == jax_lm.node_wid
        assert port_lm.big_counts      # the bank's bigrams were collected


def test_pareto_index_logps_equal_jax():
    assert lexicon._pareto_index_logps(50) == \
        jax_lexicon._pareto_index_logps(50)


def test_english_bank_equals_jax():
    assert english_text.SENTENCES == jax_english_text.SENTENCES
    assert english_text.english_bank_words() == \
        jax_english_text.english_bank_words()
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for kw in ({}, {"min_words": 2, "max_words": 4}):
            assert english_text.sample_sentence(a, **kw) == \
                jax_english_text.sample_sentence(b, **kw)


@pytest.mark.parametrize("source", ["synth", "synth_bigram", "words"])
def test_engine_lexicon_equals_jax(tmp_path, source):
    """The engine's ``_decode_lm`` for each ``decode.lexicon`` form builds
    the JAX engine's trie (a word-list file: whitespace-separated words,
    uniform unigram); ``lm_alpha`` 0 turns fusion off."""
    from omnilingual_asr_tpu.config import DecodeConfig as JaxDecode
    from omnilingual_asr_tpu.config import tiny_config as jax_tiny
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine

    if source == "words":
        path = tmp_path / "lexicon.txt"
        path.write_text("Alpha beta\n gamma\tdelta  alpha ñandú\n\n",
                        encoding="utf-8")
        source = str(path)
    dec = dict(beam_size=4, lexicon=source, lm_alpha=0.3)
    eng = TranscriptionEngine(
        config=tiny_config().replace(decode=DecodeConfig(**dec)),
        device="cpu", speaker_mode="inline", params=_tiny_params())
    ref = SimpleNamespace(config=jax_tiny().replace(decode=JaxDecode(**dec)))
    got, want = eng._decode_lm(), JaxEngine._decode_lm(ref)
    assert type(got).__name__ == type(want).__name__
    assert got.children == want.children
    assert got.word_logp == want.word_logp
    assert eng._decode_lm() is got            # built once
    if source not in ("synth", "synth_bigram"):
        assert sorted(w for w in got.word_logp if w is not None) == \
            [-math.log(6)] * 5                # 6 words, "alpha" twice
    off = TranscriptionEngine(
        config=tiny_config().replace(decode=DecodeConfig(
            beam_size=4, lexicon=source, lm_alpha=0.0)),
        device="cpu", speaker_mode="inline", params=_tiny_params())
    assert off._decode_lm() is None


def _tiny_params():
    from omnilingual_asr_torch.models.conformer import asr_init

    return asr_init(torch.Generator().manual_seed(0), tiny_config())


@pytest.mark.parametrize("case", ["planted", "masked", "random"])
def test_topk_orders_ties_as_jax(case):
    """``ctc_topk`` against ``jax.lax.top_k`` of the same log-softmax: the
    same classes in the same order, ties lower class first."""
    rng = np.random.default_rng(SEED + 300)
    if case == "planted":
        # Rows of few distinct values, so most of the top 8 are ties.
        x = rng.integers(0, 4, (64, 257)).astype(np.float32)
        x[:8] = 1.0                              # a whole row tied
        x[8, [3, 200, 17, 256]] = 9.0            # ties among the best
    elif case == "masked":
        # An orthography mask: most classes at the same large negative.
        x = rng.standard_normal((64, 257)).astype(np.float32)
        x[:, 40:] += -1e9
        x[:, 5] = x[:, 6]
    else:
        x = rng.standard_normal((3, 50, 257)).astype(np.float32)
    lp, ids = ctc_topk(torch.from_numpy(x), 8)
    jlp, jids = jax.lax.top_k(jax.nn.log_softmax(jnp.asarray(x), axis=-1), 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6)
    if case == "planted":
        np.testing.assert_array_equal(ids[0].numpy(), np.arange(8))
        assert ids[8, :4].tolist() == [3, 17, 200, 256]
