"""Helpers that hold a transcription to a stored reference result.

``testdata/golden.wav`` is 8 s of synthetic multi-speaker speech and
``testdata/golden.json`` the JAX engine's result on it (``to_dict`` form)
with its greedy CTC ids. The tests hold the port's CPU result to it, and
``chip_smoke.py`` holds the card's result to it, by one criterion:
identical segment texts, speakers, languages and emotions, identical
summary and detected languages, segment and word times within one
subsampled frame (40 ms), and greedy CTC ids equal on at least 99.5 % of
valid frames.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Sequence

import numpy as np

TESTDATA = Path(__file__).resolve().parent / "testdata"
GOLDEN_WAV = TESTDATA / "golden.wav"
GOLDEN_JSON = TESTDATA / "golden.json"

#: One subsampled encoder frame (4 x 10 ms hop).
TIME_TOL_S = 0.04
MIN_CTC_AGREEMENT = 0.995

_EXACT_SEGMENT_FIELDS = ("text", "speaker", "language", "language_code",
                         "languages", "emotion", "translation")


def load_golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


def result_mismatches(want: dict, got: dict,
                      time_tol: float = TIME_TOL_S) -> List[str]:
    """Differences between two ``TranscriptionResult.to_dict()`` results
    beyond the criterion; empty when they agree."""
    bad = []
    for key in ("summary", "detected_languages"):
        if want.get(key) != got.get(key):
            bad.append(f"{key}: {want.get(key)!r} != {got.get(key)!r}")
    ws, gs = want["segments"], got["segments"]
    if len(ws) != len(gs):
        return bad + [f"{len(gs)} segments, want {len(ws)}"]
    for i, (w, g) in enumerate(zip(ws, gs)):
        for f in _EXACT_SEGMENT_FIELDS:
            if w.get(f) != g.get(f):
                bad.append(f"segment {i} {f}: {g.get(f)!r}, want "
                           f"{w.get(f)!r}")
        for f in ("start", "end"):
            if abs(w[f] - g[f]) > time_tol + 1e-9:
                bad.append(f"segment {i} {f}: {g[f]}, want {w[f]}")
        ww, gw = w.get("words") or [], g.get("words") or []
        if [x["word"] for x in ww] != [x["word"] for x in gw]:
            bad.append(f"segment {i} words differ")
            continue
        for x, y in zip(ww, gw):
            if (abs(x["start"] - y["start"]) > time_tol + 1e-9
                    or abs(x["end"] - y["end"]) > time_tol + 1e-9):
                bad.append(f"segment {i} word {x['word']!r} times "
                           f"{y['start']}-{y['end']}, want "
                           f"{x['start']}-{x['end']}")
    return bad


def ctc_agreement(want: Sequence[Sequence[int]],
                  got: Sequence[Sequence[int]]) -> float:
    """Fraction of valid frames whose greedy CTC ids agree (per-window id
    lists; a length mismatch counts every unmatched frame as a miss)."""
    total = agree = 0
    for w, g in zip(want, got):
        w, g = np.asarray(w), np.asarray(g)
        n = min(len(w), len(g))
        total += max(len(w), len(g))
        agree += int((w[:n] == g[:n]).sum())
    total += sum(len(w) for w in want[len(got):])
    total += sum(len(g) for g in got[len(want):])
    return agree / total if total else 1.0
