"""Quality metrics: WER, CER, and diarization error rate (DER).

BASELINE.json tracks "WER/CER parity on FLEURS" and "diarization DER"; the
reference itself computes no metrics (it trusts Gemini). These are the
framework-native implementations used by the eval harness and tests.

The PyTorch port's own copy of ``omnilingual_asr_tpu/utils/metrics.py``
(pure Python and numpy); keep the two in step.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


def normalize_text(s: str) -> str:
    """Light ASR normalization: NFKC, casefold, strip punctuation (keeping
    intra-word apostrophes/hyphens), collapse whitespace."""
    s = unicodedata.normalize("NFKC", s).casefold()
    s = re.sub(r"[^\w\s'\-]", " ", s, flags=re.UNICODE)
    s = re.sub(r"\s+", " ", s)
    return s.strip()


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance, O(len(ref)*len(hyp)) with two rows."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[m]


def wer(ref: str, hyp: str, normalize: bool = True) -> float:
    """Word error rate; 0.0 for two empty refs, 1.0 for hyp-vs-empty-ref."""
    if normalize:
        ref, hyp = normalize_text(ref), normalize_text(hyp)
    r, h = ref.split(), hyp.split()
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(r, h) / len(r)


def cer(ref: str, hyp: str, normalize: bool = True) -> float:
    """Character error rate (whitespace collapsed, not counted)."""
    if normalize:
        ref, hyp = normalize_text(ref), normalize_text(hyp)
    r = ref.replace(" ", "")
    h = hyp.replace(" ", "")
    if not r:
        return 0.0 if not h else 1.0
    return edit_distance(r, h) / len(r)


# ---------------------------------------------------------------------------
# Diarization error rate
# ---------------------------------------------------------------------------

Turn = Tuple[float, float, str]  # (start, end, speaker)


def _frame_labels(turns: List[Turn], total: float, step: float) -> np.ndarray:
    """Rasterize speaker turns to frame labels (-1 = silence). Overlaps keep
    the later-listed speaker (single-label DER approximation)."""
    n = int(np.ceil(total / step))
    speakers = {s for _, _, s in turns}
    idx = {s: i for i, s in enumerate(sorted(speakers))}
    lab = np.full(n, -1, dtype=np.int64)
    for start, end, spk in turns:
        a, b = int(round(start / step)), int(round(end / step))
        lab[a:min(b, n)] = idx[spk]
    return lab


def der(ref_turns: List[Turn], hyp_turns: List[Turn],
        step: float = 0.01, collar: float = 0.25) -> float:
    """Diarization error rate with optimal speaker mapping and a collar
    around reference turn boundaries (standard NIST-style scoring)."""
    if not ref_turns:
        return 0.0 if not hyp_turns else 1.0
    total = max(max(e for _, e, _ in ref_turns),
                max((e for _, e, _ in hyp_turns), default=0.0))
    ref = _frame_labels(ref_turns, total, step)
    hyp = _frame_labels(hyp_turns, total, step)

    # Collar mask: ignore frames near reference boundaries.
    keep = np.ones(len(ref), dtype=bool)
    c = int(round(collar / step))
    for start, end, _ in ref_turns:
        for t in (start, end):
            a = max(0, int(round(t / step)) - c)
            b = min(len(ref), int(round(t / step)) + c)
            keep[a:b] = False
    ref, hyp = ref[keep], hyp[keep]

    ref_speech = ref >= 0
    hyp_speech = hyp >= 0
    n_ref_speech = int(ref_speech.sum())
    if n_ref_speech == 0:
        return 0.0 if not hyp_speech.any() else 1.0

    missed = int((ref_speech & ~hyp_speech).sum())
    false_alarm = int((~ref_speech & hyp_speech).sum())

    # Optimal mapping between ref/hyp speakers on overlapping speech frames.
    both = ref_speech & hyp_speech
    r, h = ref[both], hyp[both]
    n_r = int(r.max()) + 1 if len(r) else 0
    n_h = int(h.max()) + 1 if len(h) else 0
    matched = 0
    if n_r and n_h:
        conf = np.zeros((n_r, n_h), dtype=np.int64)
        np.add.at(conf, (r, h), 1)
        try:
            from scipy.optimize import linear_sum_assignment

            ri, hi = linear_sum_assignment(-conf)
            matched = int(conf[ri, hi].sum())
        except ImportError:  # greedy fallback
            cf = conf.copy()
            while cf.max() > 0:
                i, j = np.unravel_index(cf.argmax(), cf.shape)
                matched += int(cf[i, j])
                cf[i, :] = 0
                cf[:, j] = 0
    confusion = int(both.sum()) - matched
    return (missed + false_alarm + confusion) / n_ref_speech


def aggregate_wer(pairs: List[Tuple[str, str]]) -> Dict[str, float]:
    """Corpus-level WER/CER over (ref, hyp) pairs (length-weighted)."""
    w_err = w_tot = c_err = c_tot = 0
    for ref, hyp in pairs:
        nr, nh = normalize_text(ref), normalize_text(hyp)
        rw, hw = nr.split(), nh.split()
        w_err += edit_distance(rw, hw)
        w_tot += len(rw)
        rc, hc = nr.replace(" ", ""), nh.replace(" ", "")
        c_err += edit_distance(rc, hc)
        c_tot += len(rc)
    return {
        "wer": w_err / max(w_tot, 1),
        "cer": c_err / max(c_tot, 1),
        "n_ref_words": w_tot,
    }
