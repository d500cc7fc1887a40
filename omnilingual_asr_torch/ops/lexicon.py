"""Byte-trie lexicon LM for shallow-fusion CTC beam decoding.

The reference pipeline gets its spelling for free: Gemini is an LLM, so
"fo geur score" can never survive decoding (gemini_pipeline.py:512-530
returns LLM text). A CTC acoustic model has no such prior — on real speech
its held-out errors are dominated by plausible-but-wrong spellings of
in-vocabulary words. This module restores the missing prior the classical
way: a byte-level trie over the known lexicon with unigram word scores,
fused into the prefix beam search (ops/beam.py) as

    total = log P_acoustic + alpha * log P_lm + beta * n_words

The lexicon is SOFT: out-of-lexicon words stay reachable at a per-byte
penalty, so novel words/names are attenuated, not forbidden.

Design notes (host-side by construction): beam decode already runs on the
host over top-K frame scores; the trie walk is O(1) per extension and the
LM state is cached per beam prefix, so fusion adds no device work and no
measurable host latency at beam<=16.

The PyTorch port's own copy of ``omnilingual_asr_tpu/ops/lexicon.py`` (host
Python; the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["TrieLM", "BigramTrieLM", "synth_lexicon", "LMState"]

# Bytes that terminate a word during decoding. Everything else (letters,
# apostrophe/hyphen, and all non-ASCII UTF-8 continuation/lead bytes of the
# cipher scripts) is a word-internal byte.
_BOUNDARY = frozenset(
    b" \t\n\r.,!?;:\"()[]{}<>/\\|@#$%^&*+=~`0123456789"
)


def _norm(b: int) -> int:
    """Case-fold ASCII letters (the trie stores lowercase)."""
    return b + 32 if 65 <= b <= 90 else b


# LM state: (node, depth, n_words). node: trie node index, or -1 while
# inside an out-of-lexicon word. depth: bytes consumed of the current word.
LMState = Tuple[int, int, int]


class TrieLM:
    """Byte-trie unigram lexicon with soft OOV escape.

    words: iterable of (word, logp). Scoring contract:
      - advance() charges 0 while a word prefix stays in the trie;
      - completing an in-lexicon word (boundary byte or end of sequence)
        charges its unigram logp;
      - the byte that derails from the trie retroactively charges
        ``oov_byte_logp`` for every byte of the word so far (a word costs
        the same no matter where it left the lexicon), then each further
        byte costs ``oov_byte_logp``;
      - an in-trie but incomplete word at a boundary is charged like OOV.

    Boundary bytes themselves cost nothing; word counting (for the
    insertion bonus ``beta``) is part of the state.
    """

    def __init__(self, words: Iterable[Tuple[str, float]], *,
                 oov_byte_logp: float = -4.0) -> None:
        self.oov_byte_logp = float(oov_byte_logp)
        # children[node] : {byte: node}; word_logp[node]: logp if a word
        # ends here else None.
        self.children: List[Dict[int, int]] = [{}]
        self.word_logp: List[Optional[float]] = [None]
        for word, logp in words:
            bs = word.lower().encode("utf-8")
            if not bs:
                continue
            node = 0
            for b in bs:
                nxt = self.children[node].get(b)
                if nxt is None:
                    nxt = len(self.children)
                    self.children[node][b] = nxt
                    self.children.append({})
                    self.word_logp.append(None)
                node = nxt
            prev = self.word_logp[node]
            self.word_logp[node] = (float(logp) if prev is None
                                    else max(prev, float(logp)))

    # -- scoring ----------------------------------------------------------

    def start(self) -> LMState:
        return (0, 0, 0)

    def _complete(self, node: int, depth: int) -> float:
        """Cost of ending the current word here (0 if no word in progress)."""
        if depth == 0:
            return 0.0
        if node >= 0:
            lp = self.word_logp[node]
            if lp is not None:
                return lp
            # in-trie but not a word: price it like a full OOV word
            return self.oov_byte_logp * depth
        return 0.0  # OOV: bytes were already charged on the way in

    def advance(self, state: LMState, byte_val: int) -> Tuple[LMState, float]:
        """Consume one emitted byte; returns (new_state, logp_delta)."""
        node, depth, n_words = state
        b = _norm(byte_val)
        if b in _BOUNDARY:
            delta = self._complete(node, depth)
            return (0, 0, n_words + (1 if depth else 0)), delta
        if node >= 0:
            nxt = self.children[node].get(b)
            if nxt is not None:
                return (nxt, depth + 1, n_words), 0.0
            # derail: charge the whole word-so-far plus this byte as OOV
            return (-1, depth + 1, n_words), self.oov_byte_logp * (depth + 1)
        return (-1, depth + 1, n_words), self.oov_byte_logp

    def finalize(self, state: LMState) -> Tuple[int, float]:
        """End of sequence: (final word count, completion logp delta)."""
        node, depth, n_words = state
        return n_words + (1 if depth else 0), self._complete(node, depth)


class BigramTrieLM(TrieLM):
    """TrieLM + word-bigram context from a sentence corpus.

    State grows to (node, depth, n_words, prev_word_id) — index 2 stays
    n_words, so ops/beam.py's word-bonus lookup is unchanged. Completing a
    word charges

        log[ (c(prev, w) + K * p_uni(w)) / (c(prev, ·) + K) ]

    an interpolated bigram whose unseen-context limit (c = 0) degenerates
    EXACTLY to the base unigram trie score, so cipher-language decoding is
    bit-identical to TrieLM and only English words with observed bigram
    context (train/english_text.py sentence bank) are re-ranked.
    """

    def __init__(self, words: Iterable[Tuple[str, float]], *,
                 sentences: Iterable[str],
                 oov_byte_logp: float = -4.0,
                 strength: float = 20.0) -> None:
        super().__init__(words, oov_byte_logp=oov_byte_logp)
        self.strength = float(strength)
        # word-id per trie terminal node (only words seen in sentences
        # get ids — everything else keeps pure unigram behavior)
        self.node_wid: Dict[int, int] = {}
        self._wid = 0
        self.big_counts: Dict[Tuple[int, int], float] = {}
        self.ctx_counts: Dict[int, float] = {}

        def node_of(word: str) -> int:
            node = 0
            for b in word.lower().encode("utf-8"):
                node = self.children[node].get(_norm(b), -1)
                if node < 0:
                    return -1
            return node if self.word_logp[node] is not None else -1

        def wid_of(word: str) -> int:
            n = node_of(word)
            if n < 0:
                return -1
            if n not in self.node_wid:
                self.node_wid[n] = self._wid
                self._wid += 1
            return self.node_wid[n]

        for sent in sentences:
            prev = -1
            for w in sent.split():
                cur = wid_of(w)
                if prev >= 0 and cur >= 0:
                    self.big_counts[(prev, cur)] = (
                        self.big_counts.get((prev, cur), 0.0) + 1.0)
                    self.ctx_counts[prev] = self.ctx_counts.get(prev, 0) + 1.0
                prev = cur

    # -- scoring ------------------------------------------------------------

    def start(self) -> Tuple[int, int, int, int]:
        return (0, 0, 0, -1)

    def _complete_bigram(self, node: int, depth: int,
                         prev: int) -> Tuple[float, int]:
        """(logp delta for ending the word here, next prev_word_id)."""
        if depth == 0:
            return 0.0, prev
        if node >= 0:
            base = self.word_logp[node]
            if base is not None:
                wid = self.node_wid.get(node, -1)
                ctx = self.ctx_counts.get(prev, 0.0) if prev >= 0 else 0.0
                if ctx > 0:
                    c = self.big_counts.get((prev, wid), 0.0) if wid >= 0 \
                        else 0.0
                    k = self.strength
                    p = (c + k * math.exp(base)) / (ctx + k)
                    # Floor the unseen-continuation penalty: the bank's
                    # bigram mass must not starve held-out vocabulary
                    # (every content word after a function word would
                    # otherwise eat log((ctx+k)/k) ≈ 2.5 nats, biasing
                    # decode toward substituting bank words — the exact
                    # failure mode on held-out real English).
                    score = max(math.log(max(p, 1e-12)),
                                base + math.log(0.25))
                    return score, wid
                return base, wid
            return self.oov_byte_logp * depth, -1
        return 0.0, -1   # OOV: bytes charged on the way in

    def advance(self, state, byte_val: int):
        node, depth, n_words, prev = state
        b = _norm(byte_val)
        if b in _BOUNDARY:
            delta, nprev = self._complete_bigram(node, depth, prev)
            return (0, 0, n_words + (1 if depth else 0), nprev), delta
        if node >= 0:
            nxt = self.children[node].get(b)
            if nxt is not None:
                return (nxt, depth + 1, n_words, prev), 0.0
            return ((-1, depth + 1, n_words, prev),
                    self.oov_byte_logp * (depth + 1))
        return (-1, depth + 1, n_words, prev), self.oov_byte_logp

    def finalize(self, state) -> Tuple[int, float]:
        node, depth, n_words, prev = state
        delta, _ = self._complete_bigram(node, depth, prev)
        return n_words + (1 if depth else 0), delta


def _pareto_index_logps(n: int, shape: float = 1.2,
                        scale: float = 12.0) -> List[float]:
    """log P(index = i) for the synthetic corpus's word draw
    idx = min(floor(pareto(shape) * scale), n - 1)  (train/synth.py
    make_example) — P(X in [i/s, (i+1)/s)) = (1+i/s)^-a - (1+(i+1)/s)^-a.
    """
    out = []
    for i in range(n):
        lo = (1.0 + i / scale) ** -shape
        hi = 0.0 if i == n - 1 else (1.0 + (i + 1) / scale) ** -shape
        out.append(math.log(max(lo - hi, 1e-12)))
    return out


def synth_lexicon(*, include_real: bool = True,
                  oov_byte_logp: float = -4.0,
                  bigram: bool = False) -> TrieLM:
    """The decoding lexicon matching the training distribution: every
    synthetic language's cipher lexicon (train/synth.py) scored by the
    corpus's pareto index draw, plus the vocabulary of the bundled real
    recordings (gettysburg EAF words — common English a real deployment's
    dictionary would contain anyway).
    """
    from ..train.synth import LANGUAGES, LEXICON_SIZE
    from ..train.synth import lexicon as lang_lexicon

    idx_logps = _pareto_index_logps(LEXICON_SIZE)
    # each language is drawn uniformly; fold that into the unigram
    lang_lp = -math.log(len(LANGUAGES))
    words: List[Tuple[str, float]] = []
    for lang in LANGUAGES:
        lex = lang_lexicon(lang)
        words.extend((w, idx_logps[i] + lang_lp) for i, w in enumerate(lex))
    if include_real:
        try:
            from ..train.synth import real_recordings

            for _, rec_words, _, _, _ in real_recordings():
                uniq = {w.strip(".,;:!?\"'").lower()
                        for _, _, w in rec_words}
                words.extend((w, math.log(1e-4)) for w in uniq if w)
        except Exception:
            pass  # reference assets absent (bare CI checkout)
    # English sentence-bank vocabulary (train/english_text.py): the
    # grammatical-English training draws use these words, so the
    # decode-time prior must too — and the bigram mode needs them in the
    # trie regardless of include_real (otherwise zero bigram counts are
    # collected and it silently degenerates to the unigram).
    from ..train.english_text import english_bank_words

    words.extend((w, math.log(1e-4)) for w in english_bank_words())
    if bigram:
        from ..train.english_text import SENTENCES

        return BigramTrieLM(words, sentences=SENTENCES,
                            oov_byte_logp=oov_byte_logp)
    return TrieLM(words, oov_byte_logp=oov_byte_logp)
