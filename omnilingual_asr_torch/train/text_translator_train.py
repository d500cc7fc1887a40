"""Text-mode X->English translator training on one GPU.

The PyTorch port of ``omnilingual_asr_tpu/train/text_translator_train.py``
(the ``"src"`` mode of ``models/translation.py``): the byte-level seq2seq
learns the synthetic corpus's bijective word cipher, plus reordering and
morphology clauses (:func:`draw_grammar_pair`) and, where ``humanize`` and
``babel`` are installed, real natural-language pairs
(``train/real_pairs.py``), from pairs drawn on the fly. Sources are
corrupted with CTC-style byte errors (:func:`ctc_noise`) so that the
engine's transcripts still translate. Held-out word accuracy on clean,
noisy, grammar-only and (with the real corpus) real held-out sources is
measured every ``--eval-every`` steps, and the parameters with the best
clean accuracy are saved.

    python -m omnilingual_asr_torch.train.text_translator_train \\
        --out checkpoints/<trunk>/translator.npz --steps 4000

No audio and no encoder pass: the steps are small matmuls. Everything runs
on CUDA unless the caller passes ``device="cpu"`` (``--device cpu``). The
draws follow the reference's generators draw for draw: the eval sets from
``seed + 10000`` (clean, noisy, grammar, real held-out, in that order),
then the batches from ``seed``. The checkpoint is one ``.npz`` in the
release's keystr layout (``models/translation.py::save_translator``):
``--out X.npz`` writes that file, any other ``--out`` writes
``X/translator.npz``, the name the engine finds in a release directory.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig, tiny_config
from ..models.translation import (MAX_SOURCE_LEN, GreedyDecoder,
                                  decoder_forward, encode_source,
                                  save_translator, text_translator_init,
                                  tokens_to_text)
from ..models.zoo import checkpoint_path
from .step import (RunLog, make_translator_optimizer, masked_ce,
                   train_update, trainable, tree_map)

MAX_TGT_BYTES = 128
#: Source rows a greedy decode of the eval sets takes at once.
EVAL_BATCH = 64


# ---------------------------------------------------------------------------
# Pair generation (text only)
# ---------------------------------------------------------------------------


def _lang_tables():
    from .synth import ENGLISH_WORDS, LANGUAGES, lexicon

    non_english = [lg for lg in LANGUAGES if not lg.is_english]
    return ([(lg.name, lexicon(lg)) for lg in non_english],
            list(ENGLISH_WORDS))


# ---------------------------------------------------------------------------
# Grammar pairs: reordering + morphology
#
# The cipher-gloss pairs below exercise only word-for-word substitution; a
# real language pair (reference gemini_pipeline.py:176-179,208) also demands
# REORDERING (SOV/VSO -> English SVO) and MORPHOLOGY (case/number/tense
# suffixes -> English function words and inflection). Each synthetic
# language gets a deterministic typology — word order, adjective position,
# case/plural/past suffixes in its own script, postpositions instead of
# prepositions, no articles — and the translator must parse structure, not
# substitute tokens: "lemma+ACC lemma+PL+NOM verb+PAST" (SOV) must become
# "the Xs verbed the Y".
# ---------------------------------------------------------------------------

_G_NOUNS = ("man woman child house water day night eye head hand side part "
            "place work year word world school road car city tree sea "
            "mother father family friend light horse story paper music "
            "river mountain country farm bird dog sun moon star table").split()
_G_VERBS = ("help follow watch open call turn ask need want play stay "
            "count cover cross walk look learn answer remember start "
            "stop talk listen carry reach pull plan wash miss").split()
_G_ADJS = ("big small old new good long high red white black green warm "
           "cold young short strong clear").split()
_G_PREPS = ("in", "on", "near", "with")


def _inflect_3sg(v: str) -> str:
    if v.endswith(("s", "x", "z", "ch", "sh")):
        return v + "es"
    if v.endswith("y") and v[-2:-1] not in "aeiou":
        return v[:-1] + "ies"
    return v + "s"


def _inflect_past(v: str) -> str:
    if v.endswith("e"):
        return v + "d"
    if v.endswith("y") and v[-2:-1] not in "aeiou":
        return v[:-1] + "ied"
    if v == "stop":
        return "stopped"
    if v == "plan":
        return "planned"
    return v + "ed"


def _inflect_plural(n: str) -> str:
    if n.endswith(("s", "x", "z", "ch", "sh")):
        return n + "es"
    if n.endswith("y") and n[-2:-1] not in "aeiou":
        return n[:-1] + "ies"
    if n == "man":
        return "men"
    if n == "woman":
        return "women"
    if n == "child":
        return "children"
    return n + "s"


def _typology(name: str, lex: List[str]):
    """Deterministic per-language grammar profile, affixes in the
    language's own script (drawn from its lexicon's character set)."""
    import hashlib

    seed = int.from_bytes(hashlib.md5(name.encode()).digest()[:4], "big")
    rng = np.random.default_rng(seed)
    alphabet = sorted({c for w in lex[:200] for c in w})
    def syllable(n):
        return "".join(alphabet[int(rng.integers(len(alphabet)))]
                       for _ in range(n))
    # distinct affix forms (regenerate on collision)
    forms: List[str] = []
    while len(forms) < 8:
        f = syllable(int(rng.integers(1, 3)))
        if f not in forms:
            forms.append(f)
    return {
        "order": ("sov", "vso", "svo")[int(rng.integers(3))],
        "adj_post": bool(rng.integers(2)),
        "acc": forms[0], "obl": forms[1], "pl": forms[2], "past": forms[3],
        # postposition words for in/on/near/with
        "post": dict(zip(_G_PREPS, forms[4:8])),
    }


def _grammar_tables(tables, english):
    """Per-language grammar profiles + the content-word index map.

    Only words present in ENGLISH_WORDS participate (the cipher lexicons
    are index-aligned with it)."""
    idx = {w: i for i, w in enumerate(english)}
    nouns = [w for w in _G_NOUNS if w in idx]
    verbs = [w for w in _G_VERBS if w in idx]
    adjs = [w for w in _G_ADJS if w in idx]
    profiles = [(name, lex, _typology(name, lex))
                for name, lex in tables]
    return {"idx": idx, "nouns": nouns, "verbs": verbs, "adjs": adjs,
            "profiles": profiles}


def draw_grammar_pair(rng: np.random.Generator, g) -> Tuple[str, str]:
    """One (source, english) pair requiring reordering + morphology."""
    name, lex, ty = g["profiles"][int(rng.integers(len(g["profiles"])))]
    idx = g["idx"]

    def lemma(w: str) -> str:
        return lex[idx[w]]

    past = bool(rng.integers(2))
    subj = g["nouns"][int(rng.integers(len(g["nouns"])))]
    verb = g["verbs"][int(rng.integers(len(g["verbs"])))]
    subj_pl = rng.random() < 0.3
    adj = (g["adjs"][int(rng.integers(len(g["adjs"])))]
           if rng.random() < 0.4 else None)
    obj = obj_pl = pp = None
    if rng.random() < 0.75:
        obj = g["nouns"][int(rng.integers(len(g["nouns"])))]
        obj_pl = rng.random() < 0.3
    if rng.random() < 0.4:
        pp = (_G_PREPS[int(rng.integers(len(_G_PREPS)))],
              g["nouns"][int(rng.integers(len(g["nouns"])))])

    # --- source (no articles, affixing morphology, typology order) ---
    def src_np(noun, plural, case):
        w = lemma(noun) + (ty["pl"] if plural else "") + case
        if adj is not None and noun is subj:
            a = lemma(adj)
            return f"{w} {a}" if ty["adj_post"] else f"{a} {w}"
        return w

    s_np = src_np(subj, subj_pl, "")
    v_w = lemma(verb) + (ty["past"] if past else "")
    o_np = src_np(obj, obj_pl, ty["acc"]) if obj else None
    pp_w = (f"{lemma(pp[1])}{ty['obl']} {ty['post'][pp[0]]}"
            if pp else None)
    if ty["order"] == "sov":
        parts = [s_np, o_np, pp_w, v_w]
    elif ty["order"] == "vso":
        parts = [v_w, s_np, o_np, pp_w]
    else:
        parts = [s_np, v_w, o_np, pp_w]
    src = " ".join(p for p in parts if p)

    # --- English target (articles, inflection, SVO, prepositions) ---
    def en_np(noun, plural):
        head = _inflect_plural(noun) if plural else noun
        if adj is not None and noun is subj:
            return f"the {adj} {head}"
        return f"the {head}"

    if past:
        v_en = _inflect_past(verb)
    elif subj_pl:
        v_en = verb
    else:
        v_en = _inflect_3sg(verb)
    out = [en_np(subj, subj_pl), v_en]
    if obj:
        out.append(en_np(obj, obj_pl))
    if pp:
        out.append(f"{pp[0]} the {pp[1]}")
    return src, " ".join(out)


def draw_pair(rng: np.random.Generator, tables, english,
              lexicon_size: int, g=None, real=None) -> Tuple[str, str]:
    """One (source_text, english_gloss) pair.

    Mix mirrors translator_train.py: 1/6 two-language concatenations
    (code-switch segments), 1/2 uniform word draws (full lexicon coverage),
    the rest zipf-ish draws (the engine's natural segment distribution).
    With grammar tables ``g``, 40% of draws are reordering/
    morphology clauses (draw_grammar_pair); with a ``real`` corpus
    (train/real_pairs.py), 20% are genuine natural-language pairs from the
    installed gettext/CLDR resources."""
    if g is not None or real is not None:
        r0 = rng.random()
        if g is not None and r0 < 0.4:
            return draw_grammar_pair(rng, g)
        if real is not None and r0 < 0.6:
            from .real_pairs import draw_real_pair

            return draw_real_pair(rng, real)
    r = rng.random()

    def draw_one(max_words: int) -> Tuple[str, str]:
        _, lex = tables[int(rng.integers(len(tables)))]
        n_words = int(rng.integers(1, max_words + 1))
        if rng.random() < 0.6:
            idx = rng.integers(0, lexicon_size, n_words)
        else:
            idx = np.minimum((rng.pareto(1.2, n_words) * 12).astype(int),
                             lexicon_size - 1)
        src = " ".join(lex[i] for i in idx)
        tgt = " ".join(english[i] for i in idx)
        return src, tgt

    if r < 1 / 6:
        a_src, a_tgt = draw_one(5)
        b_src, b_tgt = draw_one(5)
        return f"{a_src} {b_src}", f"{a_tgt} {b_tgt}"
    return draw_one(10)


def ctc_noise(rng: np.random.Generator, text: str, *, p_sub: float = 0.03,
              p_del: float = 0.02, p_ins: float = 0.02,
              p_merge: float = 0.01) -> str:
    """CTC-style corruption of a transcript: per-char substitution /
    deletion / insertion from the string's own alphabet, plus occasional
    word merges (dropped spaces) — the error modes the byte CTC head
    actually produces."""
    alphabet = sorted({c for c in text if c != " "}) or ["a"]
    out: List[str] = []
    for c in text:
        r = rng.random()
        if c == " " and r < p_merge:
            continue
        if c != " ":
            if r < p_del:
                continue
            if r < p_del + p_sub:
                out.append(alphabet[int(rng.integers(len(alphabet)))])
                continue
        out.append(c)
        if rng.random() < p_ins:
            out.append(alphabet[int(rng.integers(len(alphabet)))])
    return "".join(out)


def encode_pair(src: str, tgt: str, vocab):
    """-> (src_ids, src_mask, dec_inp, dec_tgt, dec_mask)."""
    sb = src.encode("utf-8")[:MAX_SOURCE_LEN]
    src_ids = np.zeros(MAX_SOURCE_LEN, np.int32)
    src_mask = np.zeros(MAX_SOURCE_LEN, bool)
    for i, b in enumerate(sb):
        src_ids[i] = vocab.byte_to_id(b)
        src_mask[i] = True
    tb = tgt.encode("utf-8")[:MAX_TGT_BYTES - 1]
    ids = [vocab.byte_to_id(b) for b in tb]
    inp = np.zeros(MAX_TGT_BYTES, np.int32)
    out = np.zeros(MAX_TGT_BYTES, np.int32)
    msk = np.zeros(MAX_TGT_BYTES, bool)
    inp[1:1 + len(ids)] = ids
    out[:len(ids)] = ids
    msk[:len(ids) + 1] = True  # include EOS position
    return src_ids, src_mask, inp, out, msk


def make_batch(rng: np.random.Generator, tables, english, lexicon_size: int,
               vocab, batch_size: int, *, noise: bool, g=None, real=None):
    """A batch of encoded pairs: five numpy arrays (:func:`encode_pair`)."""
    rows = []
    for _ in range(batch_size):
        src, tgt = draw_pair(rng, tables, english, lexicon_size, g, real)
        if noise and rng.random() < 0.7:  # 30% of batches stay clean
            src = ctc_noise(rng, src)
        rows.append(encode_pair(src, tgt, vocab))
    return tuple(np.stack(c) for c in zip(*rows))


def word_accuracy(hyp: str, ref: str) -> Tuple[int, int]:
    h, r = hyp.split(), ref.split()
    return sum(1 for a, b in zip(h, r) if a == b), len(r)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def real_corpus():
    """The real-pair corpus, or None where ``humanize`` and ``babel`` give
    no pairs (or do not import), as the reference decides."""
    try:
        from .real_pairs import build_real_corpus

        real = build_real_corpus()
        if not real["n_train"]:
            real = None
    except ImportError:  # humanize/babel absent
        real = None
    return real


def eval_sets(tables, english, gtables, real, seed: int, n_eval: int):
    """The held-out sets, drawn from ``seed + 10000`` in the reference's
    order: {"clean", "noisy", "grammar"[, "real"]} -> (source, English)
    pairs. The real set holds pairs of the hash split's held-out side."""
    from .real_pairs import draw_real_pair
    from .synth import LEXICON_SIZE

    ev_rng = np.random.default_rng(seed + 10_000)
    sets = {"clean": [draw_pair(ev_rng, tables, english, LEXICON_SIZE,
                                gtables) for _ in range(n_eval)]}
    sets["noisy"] = [(ctc_noise(ev_rng, s), t) for s, t in sets["clean"]]
    sets["grammar"] = [draw_grammar_pair(ev_rng, gtables)
                       for _ in range(n_eval)]
    if real:
        sets["real"] = [draw_real_pair(ev_rng, real, "heldout")
                        for _ in range(n_eval)]
    return sets


def encode_sources(pairs, vocab):
    """(source ids [N, MAX_SOURCE_LEN], mask) of the pairs' sources."""
    rows = [encode_pair(s, t, vocab) for s, t in pairs]
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def loss_fn(params, src_ids, src_mask, inp, tgt, msk,
            cfg: PipelineConfig) -> torch.Tensor:
    """Source encoder -> teacher-forced decoder -> masked cross-entropy."""
    mem = encode_source(params, src_ids, src_mask, cfg)
    logits = decoder_forward(params, inp, mem, src_mask, cfg)
    return masked_ce(logits, tgt, msk)


def batch_tensors(batch, device):
    """A :func:`make_batch` batch as tensors on ``device``."""
    return tuple(torch.from_numpy(c).to(device) for c in batch)


def eval_acc(decoder: GreedyDecoder, ids_mask, pairs) -> float:
    """Word accuracy of greedy decodes of the sources against the pairs'
    English, in decodes of EVAL_BATCH rows."""
    ids, mask = ids_mask
    vocab = decoder.cfg.vocab
    ok = words = 0
    for b0 in range(0, ids.shape[0], EVAL_BATCH):
        toks = decoder.translate_text(
            torch.from_numpy(ids[b0:b0 + EVAL_BATCH]),
            torch.from_numpy(mask[b0:b0 + EVAL_BATCH]),
            max_len=MAX_TGT_BYTES).cpu().numpy()
        for j in range(toks.shape[0]):
            hyp = tokens_to_text(toks[j], vocab)
            a, b = word_accuracy(hyp, pairs[b0 + j][1])
            ok += a
            words += b
    return ok / max(words, 1)


def train_translator(out_dir: str, *, steps: int = 4000,
                     batch_size: int = 128, lr: float = 1e-3,
                     n_eval: int = 256, seed: int = 0,
                     eval_every: int = 500, log_every: int = 100,
                     cfg: Optional[PipelineConfig] = None,
                     metrics_log: Optional[str] = None,
                     tiny: bool = False, device=None, init_params=None):
    """The reference's ``train_translator`` on ``device`` (CUDA unless
    "cpu"); saves the best-clean-accuracy parameters to
    :func:`checkpoint_path` ``(out_dir, "translator.npz")``.

    ``init_params`` (tests and ``chip_smoke.py``): a parameter tree to
    start from instead of ``text_translator_init(seed)``. Returns
    (best parameters, :class:`RunLog`)."""
    from ..device import resolve_device
    from .synth import LEXICON_SIZE

    dev = resolve_device(device)
    cfg = cfg or (tiny_config() if tiny else PipelineConfig.from_env())
    vocab = cfg.vocab
    run = RunLog(Path(metrics_log) if metrics_log else None)

    tables, english = _lang_tables()
    gtables = _grammar_tables(tables, english)
    real = real_corpus()
    if real is None:
        print("no real corpus (humanize/babel give no pairs): synthetic "
              "pairs only", flush=True)
    rng = np.random.default_rng(seed)
    sets = eval_sets(tables, english, gtables, real, seed, n_eval)
    encoded = {k: encode_sources(v, vocab) for k, v in sets.items()}

    if init_params is None:
        init_params = text_translator_init(
            torch.Generator().manual_seed(seed), cfg, n_layers=4)
    params = trainable(init_params, dev)
    tx = make_translator_optimizer(lr, steps)
    opt_state = tx.init(params)

    best_acc, best_params = -1.0, tree_map(lambda t: t.detach().clone(),
                                           params)
    t0 = time.perf_counter()
    for i in range(steps):
        with run.timed("synth"):
            batch = make_batch(rng, tables, english, LEXICON_SIZE, vocab,
                               batch_size, noise=True, g=gtables, real=real)
        with run.timed("steps"):
            run.losses.append(train_update(tx, opt_state, loss_fn, params,
                                           *batch_tensors(batch, dev), cfg))
        if (i + 1) % log_every == 0 or i + 1 == steps:
            run.emit({"step": i + 1, "ce": round(run.losses[-1], 4),
                      "steps_per_s": round((i + 1) /
                                           (time.perf_counter() - t0), 2)})
        if (i + 1) % eval_every == 0 or i + 1 == steps:
            with run.timed("eval"):
                decoder = GreedyDecoder(
                    tree_map(lambda t: t.detach(), params), cfg)
                acc = {k: eval_acc(decoder, encoded[k], sets[k])
                       for k in sets}
            ev = {"translation_word_acc": round(acc["clean"], 4),
                  "translation_word_acc_noisy": round(acc["noisy"], 4),
                  "translation_word_acc_grammar": round(acc["grammar"], 4),
                  "n_eval": n_eval}
            if "real" in acc:
                ev["translation_word_acc_real_heldout"] = round(
                    acc["real"], 4)
                ev["real_corpus"] = {"n_train": real["n_train"],
                                     "n_heldout": real["n_heldout"],
                                     "n_languages": len(real["languages"])}
            run.evals.append(ev)
            run.emit({"step": i + 1, "eval": ev})
            if acc["clean"] > best_acc:
                best_acc = acc["clean"]
                best_params = tree_map(lambda t: t.detach().clone(), params)

    run.emit({"eval": {"translation_word_acc": round(best_acc, 4),
                       "n_eval": n_eval, "mode": "text"}})
    path = checkpoint_path(out_dir, "translator.npz")
    save_translator(path, best_params)
    print(f"saved text translator -> {path}", flush=True)
    return best_params, run


def main(argv=None) -> None:
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="an .npz file, or a directory for translator.npz")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-eval", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--metrics-log", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (CI mechanics)")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    a = ap.parse_args(argv)
    train_translator(a.out, steps=a.steps, batch_size=a.batch_size,
                     lr=a.lr, n_eval=a.n_eval, seed=a.seed,
                     eval_every=a.eval_every, metrics_log=a.metrics_log,
                     tiny=a.tiny, device=a.device)


if __name__ == "__main__":
    main()
