"""PyTorch port of the decoders: greedy KV-cache decoding, the text-mode
translator, the neural summarizer and the engine's decoder plumbing.

Each piece is held against the JAX function on the same numpy-seeded inputs
and the same weights (a tiny random tree carried across, or the release
``translator.npz`` / ``summarizer.npz``). Decoded tokens must be equal;
continuous outputs agree within the tolerance stated at each test. The
port's CPU engine with both release decoders is held to
``testdata/golden_decoders.json`` (``tests/test_torch_golden.py`` keeps that
fixture current).
"""

from __future__ import annotations

import dataclasses
import shutil
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import PipelineConfig, tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models import summarizer as psum
from omnilingual_asr_torch.models import translation as ptr
from omnilingual_asr_torch.models.zoo import flatten, params_from_jax
from omnilingual_asr_torch.types import EMOTIONS, TranscriptSegment
from omnilingual_asr_tpu import engine as jeng
from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import summarizer as jsum
from omnilingual_asr_tpu.models import translation as jtr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RELEASE = REPO / "checkpoints" / "release"
SEED = 20_261_017
#: encode_source, per element: both round each dense input to bf16 from f32
#: values summed in another order, so an input may land one bf16 ulp
#: (2^-8 relative) apart; through two layers and the final LayerNorm that
#: moves an O(1) output by a few 1e-3 at most.
TOL_MEMORY = 2e-2


def _release_configs(**kw):
    text = (RELEASE / "config.json").read_text()
    return PipelineConfig.from_json(text, **kw), JaxConfig.from_json(text)


def _release_engine(**kwargs):
    cfg, _ = _release_configs(checkpoint_path=str(RELEASE / "asr.npz"))
    return TranscriptionEngine(config=cfg, device="cpu",
                               xvector_path=str(RELEASE / "xvector.npz"),
                               **kwargs)


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def release():
    """Both release decoders in both packages, and the configs."""
    cfg, jcfg = _release_configs()
    out = SimpleNamespace(cfg=cfg, jcfg=jcfg)
    for name, n_layers in (("translator", 4), ("summarizer", 2)):
        path = RELEASE / f"{name}.npz"
        setattr(out, name, ptr.load_translator(path, cfg, n_layers=n_layers))
        setattr(out, f"jax_{name}",
                jtr.load_translator(path, jcfg, n_layers=n_layers))
    return out


def _tiny_trees(seed: int, text: bool = False):
    """A tiny random decoder (d_model 128, 2 heads, 2 layers) in both
    packages, with a random position table."""
    jcfg = jax_tiny_config()
    init = jtr.text_translator_init if text else jtr.translator_init
    jp = init(jax.random.PRNGKey(seed), jcfg, n_layers=2)
    jp["pos"] = 0.5 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                        jp["pos"].shape)
    return params_from_jax(jp), jp, tiny_config(), jcfg


def _with_early_eos(jp, jcfg, enc, mask, max_len):
    """``jp`` whose EOS logit copies that of the lowest token id the JAX
    decode of (enc, mask) emits in some rows but not all, plus 1e-3: rows
    that would emit that token finish there, the others run on."""
    toks = np.asarray(jtr.greedy_translate(jp, jnp.asarray(enc),
                                           jnp.asarray(mask), jcfg,
                                           max_len=max_len))
    t = next(t for t in np.unique(toks)
             if 0 < sum(t in row for row in toks) < len(toks))
    w, b = jp["out"]["w"], jp["out"]["b"]
    return dict(jp, out={"w": w.at[:, 0].set(w[:, t]),
                         "b": b.at[0].set(b[t] + 1e-3)})


# ---------------------------------------------------------------------------
# greedy_translate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_forced", [False, True])
def test_greedy_translate_tiny_equals_jax(with_forced):
    """Tokens equal the JAX scan's on a tiny decoder over ragged memories,
    with and without a forced prefix (a forced 0 does not end a row), and
    some rows finish early while others run to max_len."""
    _, jp, cfg, jcfg = _tiny_trees(SEED)
    rng = np.random.default_rng(SEED)
    B, Te, max_len = 6, 19, 40
    enc = rng.standard_normal((B, Te, 128)).astype(np.float32)
    mask = np.arange(Te)[None] < np.array([19, 11, 4, 1, 19, 7])[:, None]
    jp = _with_early_eos(jp, jcfg, enc, mask, max_len)
    pp = params_from_jax(jp)
    forced = None
    if with_forced:
        forced = np.full((B, max_len), -1, np.int32)
        forced[0, :5] = [40, 0, 41, 0, 42]
        forced[3, :2] = [0, 0]
    want = np.asarray(jtr.greedy_translate(
        jp, jnp.asarray(enc), jnp.asarray(mask), jcfg, max_len=max_len,
        forced=None if forced is None else jnp.asarray(forced)))
    got = ptr.greedy_translate(
        pp, *_tensors(enc, mask), cfg, max_len=max_len,
        forced=None if forced is None else torch.from_numpy(forced))
    assert got.dtype == torch.int32 and got.shape == (B, max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    free = want if forced is None else np.where(forced >= 0, 1, want)
    finished = [(row == 0).any() for row in free]
    assert any(finished) and not all(finished)
    for row in free:       # after a free EOS a row emits only 0
        if (row == 0).any():
            assert not row[int(np.argmax(row == 0)):].any()
    if with_forced:
        assert (got.numpy()[0, :5] == [40, 0, 41, 0, 42]).all()


def test_greedy_argmax_ties_to_first_and_skips_padding_classes():
    """The argmax covers the first 1 + n_bytes logits only and gives ties
    to the first index: with a zero output weight, byte ids 3 and 7 tie
    and a larger logit at id 300 (outside the byte range) is ignored."""
    pp, jp, cfg, jcfg = _tiny_trees(SEED + 2)
    b = np.zeros(512, np.float32)
    b[[3, 7]], b[300] = 1.0, 5.0
    jp["out"] = {"w": jnp.zeros_like(jp["out"]["w"]), "b": jnp.asarray(b)}
    pp["out"] = {"w": torch.zeros_like(pp["out"]["w"]),
                 "b": torch.from_numpy(b)}
    enc = np.random.default_rng(SEED).standard_normal((2, 5, 128)).astype(
        np.float32)
    mask = np.ones((2, 5), bool)
    want = np.asarray(jtr.greedy_translate(jp, jnp.asarray(enc),
                                           jnp.asarray(mask), jcfg,
                                           max_len=6))
    got = ptr.greedy_translate(pp, *_tensors(enc, mask), cfg, max_len=6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 3).all()


@pytest.mark.parametrize("with_forced", [False, True])
def test_greedy_translate_release_summarizer_equals_jax(release,
                                                        with_forced):
    """The release summarizer over three pooled-state memories (1, 5 and
    128 valid slots), 192 steps, free or with a forced fact prefix: tokens
    equal, and the rows end with an EOS."""
    rng = np.random.default_rng(SEED + 3)
    B, Te, max_len = 3, 128, 192
    enc = (0.5 * rng.standard_normal((B, Te, 256))).astype(np.float32)
    mask = np.arange(Te)[None] < np.array([1, 5, 128])[:, None]
    forced = None
    if with_forced:
        ids = psum.fact_prefix_ids(release.cfg.vocab, n_speakers=2,
                                   tone="neutral",
                                   language_names=["Greek", "Georgian"])
        forced = np.full((B, max_len), -1, np.int32)
        forced[:, :len(ids)] = ids
    want = np.asarray(jtr.greedy_translate(
        release.jax_summarizer, jnp.asarray(enc), jnp.asarray(mask),
        release.jcfg, max_len=max_len,
        forced=None if forced is None else jnp.asarray(forced)))
    got = ptr.greedy_translate(
        release.summarizer, *_tensors(enc, mask), release.cfg,
        max_len=max_len,
        forced=None if forced is None else torch.from_numpy(forced))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -1] == 0).all()


# ---------------------------------------------------------------------------
# The text-mode translator
# ---------------------------------------------------------------------------

def _eval_spans(n: int = 3):
    from omnilingual_asr_tpu.train.synth import eval_set

    return [e.text for e in eval_set(12, seed=SEED)
            if e.code != "en"][:n]


def _source_batch(spans, vocab):
    ids, mask = zip(*(ptr.source_to_tokens(s, vocab) for s in spans))
    return np.stack(ids), np.stack(mask)


def test_encode_source_equals_jax(release):
    spans = _eval_spans() + ["", "a" * 300]
    ids, mask = _source_batch(spans, release.cfg.vocab)
    want = np.asarray(jtr.encode_source(release.jax_translator,
                                        jnp.asarray(ids), jnp.asarray(mask),
                                        release.jcfg))
    got = ptr.encode_source(release.translator, *_tensors(ids, mask),
                            release.cfg).numpy()
    assert got.shape == want.shape == (len(spans), 256, 256)
    assert float(np.abs(got - want).max()) <= TOL_MEMORY
    assert not got[~mask].any()


def test_translate_text_equals_jax(release):
    """The fixture's two spans and three eval_set transcripts: the port's
    tokens equal the JAX function's, and on the fixture's spans the tokens
    the JAX engine decoded (in its batch of 128 rows)."""
    stored = golden.load_golden_decoders()["translations"]
    spans = [t["span"] for t in stored] + _eval_spans()
    ids, mask = _source_batch(spans, release.cfg.vocab)
    want = np.asarray(jtr.translate_text(
        release.jax_translator, jnp.asarray(ids), jnp.asarray(mask),
        release.jcfg, max_len=128))
    got = ptr.translate_text(release.translator, *_tensors(ids, mask),
                             release.cfg, max_len=128).numpy()
    np.testing.assert_array_equal(got, want)
    for t, row in zip(stored, got):
        assert row.tolist() == t["tokens"]


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

_TEXTS = [
    "",
    "hello world",
    "Dialogue with 2 speakers in Georgian and Greek. Overall tone: neutral.",
    "Two people talk; the tone is happy and one of them is sad.",
    "A single speaker, calm and neutral throughout.",
    "2 speakers talk in 222 2 2222",
    "the the the end",
    "three speakers, 3 of them angry",
    "ŋ" * 150,                              # 300 bytes, cut at 256
    "a" + "€" * 100,                        # cut inside a 3-byte character
    "ქღქ ტვგ სᤠნსფ� ���",
]


@pytest.mark.parametrize("text", _TEXTS)
def test_host_helpers_equal_jax(text):
    """source_to_tokens, tokens_to_text (also on invalid UTF-8),
    fact_prefix_ids, _degenerate and summary_consistent give the JAX
    package's answers."""
    cfg, jcfg = _release_configs()
    vocab, jvocab = cfg.vocab, jcfg.vocab
    ids, mask = ptr.source_to_tokens(text, vocab)
    jids, jmask = jtr.source_to_tokens(text, jvocab)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
    invalid = list(ids[:9]) + [vocab.byte_to_id(b) for b in (0xC3, 0x28,
                                                             0xFF)]
    for toks in (ids, ids[::-1], invalid, [300, 5, 0, 7]):
        assert ptr.tokens_to_text(toks, vocab) == \
            jtr.tokens_to_text(toks, jvocab)
    names = text.split()[:5]
    for n in (0, 1, 2, 3, 7):
        kw = dict(n_speakers=n, tone=EMOTIONS[n % len(EMOTIONS)],
                  language_names=names)
        assert psum.fact_prefix_ids(vocab, **kw) == \
            jsum.fact_prefix_ids(jvocab, **kw)
        for tone in EMOTIONS:
            assert psum.summary_consistent(text, n_speakers=n, tone=tone) \
                == jsum.summary_consistent(text, n_speakers=n, tone=tone)
    assert psum._degenerate(text) == jsum._degenerate(text)
    assert psum._COUNT_WORDS == jsum._COUNT_WORDS


@pytest.mark.parametrize("n_windows", [0, 3, 128, 131, 300])
def test_pool_states_equals_jax(n_windows):
    """Window means padded to 128 slots; more windows are averaged in
    groups. Both run the same numpy, so the results are identical."""
    cfg, jcfg = _release_configs()
    rng = np.random.default_rng(SEED + n_windows)
    states = [rng.standard_normal((int(rng.integers(1, 40)), 256))
              .astype(np.float16).astype(np.float32)
              for _ in range(n_windows)]
    port = psum.SummaryDecoder(cfg, params=ptr.translator_init(
        torch.Generator().manual_seed(0), cfg, n_layers=2))
    ref = jsum.SummaryDecoder(jcfg, params={})
    got, want = port.pool_states(states), ref.pool_states(states)
    assert got.shape == (128, 256) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("facts", [None, {
    "n_speakers": 2, "tone": "neutral",
    "language_names": ["Georgian", "Greek"]}])
def test_summarize_equals_jax(release, facts):
    """SummaryDecoder.summarize on the release weights over five windows of
    seeded states, with the facts forced and without: the same text (or
    None) as the JAX summarizer."""
    rng = np.random.default_rng(SEED + 5)
    states = [(0.5 * rng.standard_normal((int(n), 256))).astype(np.float16)
              .astype(np.float32) for n in rng.integers(50, 750, 5)]
    port = psum.SummaryDecoder(release.cfg, release.summarizer)
    ref = jsum.SummaryDecoder(release.jcfg, release.jax_summarizer)
    assert port.fact_conditioned and ref.fact_conditioned
    got = port.summarize(states, facts=facts)
    assert got == ref.summarize(states, facts=facts)
    if facts is not None:
        assert got is not None and "[2 |" not in got


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

def _jax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name,n_layers", [("translator", 4),
                                           ("summarizer", 2)])
def test_load_translator_equals_jax(release, name, n_layers):
    """The release files load into JAX's tree: the same keys (the "src"
    subtree, the "fact_cond" marker), shapes and values."""
    got = {k: v.numpy() for k, v in flatten(getattr(release, name)).items()}
    want = _jax_leaves(getattr(release, f"jax_{name}"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))
    assert ptr.is_text_translator(getattr(release, name)) == \
        jtr.is_text_translator(getattr(release, f"jax_{name}")) == \
        (name == "translator")


def test_load_positionless_translator_equals_jax(tmp_path):
    """A checkpoint from before the learned position table loads with a
    zero table, as in the JAX loader."""
    pp, _, cfg, jcfg = _tiny_trees(SEED + 4)
    pp.pop("pos")
    path = tmp_path / "old.npz"
    ptr.save_translator(path, pp)
    got = ptr.load_translator(path, cfg, n_layers=2)
    want = jtr.load_translator(path, jcfg, n_layers=2)
    assert not got["pos"].any() and got["pos"].shape == (256, 128)
    got = {k: v.numpy() for k, v in flatten(got).items()}
    assert sorted(got) == sorted(_jax_leaves(want))
    for k, v in _jax_leaves(want).items():
        np.testing.assert_array_equal(got[k], v)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _tiny_engine(**kwargs):
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOM-INIT")
        return TranscriptionEngine(config=tiny_config(), device="cpu",
                                   speaker_mode="inline", **kwargs)


def test_engine_explicit_decoder_paths_must_load():
    """An explicit path (argument or environment) that does not fit the
    config raises, as in the JAX engine."""
    for kw in ({"translator_path": str(RELEASE / "translator.npz")},
               {"summarizer_path": str(RELEASE / "summarizer.npz")}):
        with pytest.raises((KeyError, ValueError)):
            _tiny_engine(**kw)


def test_engine_decoder_env_paths_load(monkeypatch):
    monkeypatch.setenv("OMNIASR_TRANSLATOR", str(RELEASE / "translator.npz"))
    monkeypatch.setenv("OMNIASR_SUMMARIZER", str(RELEASE / "summarizer.npz"))
    eng = _release_engine()
    assert eng._translator.is_text
    assert eng._summarizer.fact_conditioned
    assert eng._states_consumer


def test_engine_discovered_decoders_are_best_effort(tmp_path, monkeypatch):
    """Release files found by discovery load when they fit the config and
    are skipped when they do not (a tiny config)."""
    for name in ("translator", "summarizer"):
        shutil.copy(RELEASE / f"{name}.npz", tmp_path / f"{name}.npz")
    monkeypatch.setenv("OMNIASR_RELEASE_DIR", str(tmp_path))
    eng = _tiny_engine()
    assert eng._translator is None and eng._summarizer is None
    assert not eng._states_consumer
    eng = _release_engine()
    assert eng._translator is not None and eng._summarizer is not None


def test_engine_enable_translation_without_checkpoint_warns_as_jax():
    import jax as _jax
    from omnilingual_asr_tpu.config import MeshConfig
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    with pytest.warns(UserWarning) as port:
        eng = TranscriptionEngine(config=tiny_config(), device="cpu",
                                  speaker_mode="inline",
                                  enable_translation=True)
    with pytest.warns(UserWarning) as ref:
        jeng.TranscriptionEngine(
            config=jax_tiny_config(), speaker_mode="inline",
            enable_translation=True,
            mesh=build_mesh(MeshConfig(data=1), devices=_jax.devices()[:1]))
    assert eng._translator is None
    msg = [str(w.message) for w in port if "enable_translation" in
           str(w.message)]
    assert msg and msg == [str(w.message) for w in ref
                           if "enable_translation" in str(w.message)]


@pytest.mark.parametrize("translator", [None, "text", "audio"])
@pytest.mark.parametrize("summarizer", [False, True])
def test_states_consumer_truth_table(translator, summarizer):
    """Encoder states go to the host when the summarizer or an
    audio-conditioned translator is loaded, as in the JAX engine."""
    trees = {None: (None, None)}
    for mode in ("text", "audio"):
        pp, jp, cfg, _ = _tiny_trees(SEED, text=mode == "text")
        trees[mode] = (ptr.GreedyDecoder(pp, cfg), jp)
    port = TranscriptionEngine.__new__(TranscriptionEngine)
    ref = jeng.TranscriptionEngine.__new__(jeng.TranscriptionEngine)
    port._translator, ref._translator = trees[translator]
    port._summarizer = ref._summarizer = object() if summarizer else None
    assert port._states_consumer == ref._states_consumer == (
        summarizer or translator == "audio")


def test_audio_translator_segments_equal_jax():
    """``_translate_segments`` with an audio-conditioned translator: the
    non-English segments with encoder spans (longer spans cut to 256
    frames) get the JAX engine's translations, in batches of 8."""
    pp, jp, cfg, jcfg = _tiny_trees(SEED + 6)
    rng = np.random.default_rng(SEED + 6)
    codes = ["ka", "en", "el", None, "ru"] * 2
    meta = [(None, None, None,
             rng.standard_normal((int(n), 128)).astype(np.float32))
            for n in rng.integers(1, 300, len(codes))]
    meta[4] = meta[4][:3] + (None,)

    def segments():
        return [TranscriptSegment(start=0.0, end=1.0, speaker="Speaker 1",
                                  text="x", language_code=c)
                for c in codes]

    port = TranscriptionEngine.__new__(TranscriptionEngine)
    port.config, port._translator = cfg, ptr.GreedyDecoder(pp, cfg)
    ref = jeng.TranscriptionEngine.__new__(jeng.TranscriptionEngine)
    ref.config, ref._translator = jcfg, jp
    got, want = segments(), segments()
    port._translate_segments(got, meta)
    ref._translate_segments(want, meta)
    assert [s.translation for s in got] == [s.translation for s in want]
    assert any(s.translation for s in got)
    assert all(s.translation is None for i, s in enumerate(got)
               if codes[i] in (None, "en") or i == 4)


def _window_outs(eng, path):
    samples = eng._load_audio(path)
    windows = eng._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * eng.window_samples
    return [o for b in eng._forward_batches(windows, n_last) for o in b]


@pytest.fixture(scope="module")
def port_golden_decoders():
    """The port's CPU engine with the release ASR, x-vector, translator
    and summarizer weights on the golden file (run once)."""
    eng = _release_engine(translator_path=str(RELEASE / "translator.npz"),
                          summarizer_path=str(RELEASE / "summarizer.npz"))
    res = eng.transcribe(golden.GOLDEN_WAV)
    return eng, res


def test_port_cpu_engine_matches_golden_decoders(port_golden_decoders):
    """Identical translations and neural summary, and the fixture's
    criterion on everything else, with at least 99.5 % greedy CTC ids."""
    eng, res = port_golden_decoders
    stored = golden.load_golden_decoders()
    got = dataclasses.asdict(res)
    assert golden.result_mismatches(stored["result"], got,
                                    tone_mass=stored["tone_mass"]) == []
    assert got["summary"] == stored["result"]["summary"]
    assert [s["translation"] for s in got["segments"]] == \
        [s["translation"] for s in stored["result"]["segments"]]
    ids = [o["ctc_ids"].astype(int).tolist()
           for o in _window_outs(eng, golden.GOLDEN_WAV)]
    assert golden.ctc_agreement(stored["ctc_ids"], ids) >= \
        golden.MIN_CTC_AGREEMENT
    assert eng.last_trace.stages["assemble.translate"] > 0.0


def test_port_engine_feeds_encoder_states(port_golden_decoders):
    """With the summarizer loaded every window carries its f16-rounded
    encoder states over its valid frames; each segment its span of them."""
    eng, _ = port_golden_decoders
    outs = _window_outs(eng, golden.GOLDEN_WAV)
    decoded, seg_meta, states = eng._extract_windows(outs)
    assert len(states) == len(outs) == 1
    st = states[0]
    assert st.dtype == np.float32 and st.shape == (len(outs[0]["ctc_ids"]),
                                                   256)
    np.testing.assert_array_equal(st, st.astype(np.float16))
    for s, meta in zip(decoded, seg_meta):
        np.testing.assert_array_equal(meta[3],
                                      st[s.frame_start:s.frame_end])
