"""CTC prefix beam search (host-side), with optional lexicon-LM fusion.

Greedy best-path decoding (ops/ctc.py) is the serving default; this module
provides the standard prefix beam search for accuracy-critical offline runs:
it sums probability over all alignments of each prefix (p_blank/p_nonblank
per prefix) instead of committing to the single best path.

Shallow fusion (``lm=`` + ``lm_alpha``/``word_bonus``, see ops/lexicon.py)
ranks prefixes by ``acoustic + alpha*lm + beta*n_words`` — the spelling
prior the reference gets implicitly from decoding with an LLM
(gemini_pipeline.py:512-530). With ``lm=None`` the scoring is bit-identical
to the LM-free search.

Top-K class pruning per frame keeps the host cost linear and small: with
K=8 candidates per frame and beams<=16 a 30 s window decodes in
milliseconds. Engine integration note: timestamps still come from the
greedy alignment (beam rescoring refines text only), so the search operates
per segment span.

The PyTorch port's own copy of ``omnilingual_asr_tpu/ops/beam.py`` (host
numpy; the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

LOG_ZERO = -1e30


def _logsumexp2(a: float, b: float) -> float:
    if a <= LOG_ZERO:
        return b
    if b <= LOG_ZERO:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


@dataclass
class BeamHypothesis:
    prefix: Tuple[int, ...]   # emitted class ids (no blanks)
    score: float              # total log prob (blank + nonblank)


def ctc_prefix_beam_search(logp: np.ndarray, *, beam_size: int = 8,
                           blank_id: int = 0,
                           topk: int = 8,
                           lm=None, lm_alpha: float = 0.0,
                           word_bonus: float = 0.0,
                           byte_offset: int = 1) -> List[BeamHypothesis]:
    """Prefix beam search over per-frame log-probs.

    logp: [T, V] log-softmax scores.
    lm: optional ops/lexicon.py TrieLM (start/advance/finalize protocol);
    class id c maps to byte value ``c - byte_offset`` for the LM walk
    (vocab ids 1..256 are bytes 0..255, config.py VocabConfig).
    Returns beams sorted best-first; ``score`` is the acoustic log prob,
    fused ranking is applied internally.
    """
    T, V = logp.shape
    k = min(topk, V)
    # p_b / p_nb per prefix: log prob of the prefix ending in blank / nonblank.
    beams: Dict[Tuple[int, ...], Tuple[float, float]] = {(): (0.0, LOG_ZERO)}
    use_lm = lm is not None and lm_alpha != 0.0
    # prefix -> (lm_state, lm_logp). States are deterministic per prefix, so
    # the cache persists across frames (prefixes only ever grow).
    lmc: Dict[Tuple[int, ...], Tuple[object, float]] = (
        {(): (lm.start(), 0.0)} if use_lm else {})

    def fused(prefix, pb, pnb) -> float:
        a = _logsumexp2(pb, pnb)
        if not use_lm:
            return a
        st, lp = lmc[prefix]
        n_words = st[2]
        return a + lm_alpha * lp + word_bonus * n_words

    for t in range(T):
        frame = logp[t]
        cand = np.argpartition(-frame, k - 1)[:k]
        if blank_id not in cand:
            cand = np.append(cand, blank_id)
        nxt: Dict[Tuple[int, ...], Tuple[float, float]] = {}

        def acc(prefix, p_b, p_nb, parent=None, c=None):
            ob, onb = nxt.get(prefix, (LOG_ZERO, LOG_ZERO))
            nxt[prefix] = (_logsumexp2(ob, p_b), _logsumexp2(onb, p_nb))
            if use_lm and prefix not in lmc:
                st, lp = lmc[parent]
                st2, d = lm.advance(st, c - byte_offset)
                lmc[prefix] = (st2, lp + d)

        for prefix, (p_b, p_nb) in beams.items():
            p_tot = _logsumexp2(p_b, p_nb)
            for c in cand:
                c = int(c)
                p_c = float(frame[c])
                if c == blank_id:
                    acc(prefix, p_tot + p_c, LOG_ZERO)
                elif prefix and c == prefix[-1]:
                    # repeat char: extends only the blank-ended paths;
                    # the nonblank-ended ones collapse into the same prefix.
                    acc(prefix + (c,), LOG_ZERO, p_b + p_c, prefix, c)
                    acc(prefix, LOG_ZERO, p_nb + p_c)
                else:
                    acc(prefix + (c,), LOG_ZERO, p_tot + p_c, prefix, c)

        # prune (fused ranking when an LM is active)
        scored = sorted(nxt.items(),
                        key=lambda kv: -fused(kv[0], *kv[1]))[:beam_size]
        beams = dict(scored)

    def final_key(prefix, pb, pnb) -> float:
        a = _logsumexp2(pb, pnb)
        if not use_lm:
            return a
        st, lp = lmc[prefix]
        n_words, d = lm.finalize(st)
        return a + lm_alpha * (lp + d) + word_bonus * n_words

    out = [BeamHypothesis(prefix=p, score=_logsumexp2(pb, pnb))
           for p, (pb, pnb) in sorted(
               beams.items(), key=lambda kv: -final_key(kv[0], *kv[1]))]
    return out


def exhaustive_ctc_best(logp: np.ndarray, blank_id: int = 0) -> Tuple[Tuple[int, ...], float]:
    """Brute-force reference: enumerate ALL alignment paths, collapse, and
    sum probabilities per label sequence. Exponential — tiny tests only."""
    T, V = logp.shape
    totals: Dict[Tuple[int, ...], float] = {}

    def walk(t, path_lp, collapsed, prev):
        if t == T:
            key = tuple(collapsed)
            totals[key] = _logsumexp2(totals.get(key, LOG_ZERO), path_lp)
            return
        for c in range(V):
            nc = list(collapsed)
            if c != blank_id and c != prev:
                nc.append(c)
            walk(t + 1, path_lp + float(logp[t, c]), nc,
                 c if c != blank_id else blank_id)

    walk(0, 0.0, [], blank_id)
    best = max(totals.items(), key=lambda kv: kv[1])
    return best[0], best[1]
