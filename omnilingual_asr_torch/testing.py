"""Helpers that hold a transcription to a stored reference result.

``testdata/golden.wav`` is 8 s of synthetic multi-speaker speech and
``testdata/golden.json`` the JAX engine's result on it (``to_dict`` form)
with its greedy CTC ids; ``golden_a8.json`` and ``golden_w8.json`` are the
JAX engine's results with ``quantize="a8"`` and ``"w8"``. The tests hold the
port's CPU results to them, and ``chip_smoke.py`` holds the card's results
to them, by one criterion:
identical segment texts, speakers, languages and emotions, identical
summary and detected languages, segment and word times within one
subsampled frame (40 ms), and greedy CTC ids equal on at least 99.5 % of
valid frames.

The summary's "Overall tone" is the argmax of the segments'
duration-weighted emotion probabilities (``tone_mass``). Each fixture
stores the reference's masses; where its top two are closer than
``TONE_TIE`` of the total, the decision lies inside the numerical noise of
two implementations, and the criterion accepts either of those two tones
(the rest of the summary must still be identical).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .types import EMOTIONS

TESTDATA = Path(__file__).resolve().parent / "testdata"
GOLDEN_WAV = TESTDATA / "golden.wav"
GOLDEN_JSON = TESTDATA / "golden.json"

#: One subsampled encoder frame (4 x 10 ms hop).
TIME_TOL_S = 0.04
MIN_CTC_AGREEMENT = 0.995
#: Share of the total tone mass below which the reference's top two tones
#: count as tied. The port's CPU masses move the top-two margin by up to
#: 0.33 % of the total against the JAX engine's on the golden file (f16
#: emotion logits on the wire, bf16 roundings flipped by summation order);
#: 0.5 % leaves room for the card's other orders.
TONE_TIE = 0.005

_TONE = re.compile(r"Overall tone: (\w+)\.$")

_EXACT_SEGMENT_FIELDS = ("text", "speaker", "language", "language_code",
                         "languages", "emotion", "translation")


def golden_json(quantize=False) -> Path:
    """The fixture of one engine mode: ``False`` (unquantized), ``"a8"`` or
    ``"w8"``."""
    if quantize is False:
        return GOLDEN_JSON
    if quantize not in ("a8", "w8"):
        raise ValueError(f"no golden fixture for quantize={quantize!r}")
    return TESTDATA / f"golden_{quantize}.json"


def load_golden(quantize=False) -> dict:
    return json.loads(golden_json(quantize).read_text())


def tone_mass(engine, path) -> List[float]:
    """The engine's duration-weighted emotion probabilities on ``path``,
    whose argmax is the summary's overall tone (the aggregation of either
    engine's ``_assemble_global``)."""
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    parts = None
    for outs in engine._forward_batches(windows, n_last):
        parts = engine._extract_windows(outs, *(parts or ()))
    mass = np.zeros(len(EMOTIONS))
    for s, meta in zip(parts[0], parts[1]):
        logits = np.asarray(meta[0][:len(EMOTIONS)], np.float64)
        p = np.exp(logits - logits.max())
        mass += max(s.end - s.start, 1e-3) * p / p.sum()
    return mass.tolist()


def _tone_tied(want: str, got: str, mass: Optional[Sequence[float]]) -> bool:
    """True when two summaries differ only in their overall tone, both
    tones are the reference's top two, and those are tied (``TONE_TIE``)."""
    if mass is None or not isinstance(want, str) or not isinstance(got, str):
        return False
    tw, tg = _TONE.search(want), _TONE.search(got)
    if not (tw and tg) or _TONE.sub("", want) != _TONE.sub("", got):
        return False
    order = np.argsort(mass)[::-1]
    first, second = EMOTIONS[order[0]], EMOTIONS[order[1]]
    margin = mass[order[0]] - mass[order[1]]
    return (tw.group(1) == first and tg.group(1) == second
            and margin < TONE_TIE * float(np.sum(mass)))


def result_mismatches(want: dict, got: dict, time_tol: float = TIME_TOL_S,
                      tone_mass: Optional[Sequence[float]] = None
                      ) -> List[str]:
    """Differences between two ``TranscriptionResult.to_dict()`` results
    beyond the criterion; empty when they agree. ``tone_mass`` is the
    reference's (a fixture's ``"tone_mass"``); without it the summary must
    be identical."""
    bad = []
    for key in ("summary", "detected_languages"):
        if want.get(key) != got.get(key) and not (
                key == "summary"
                and _tone_tied(want[key], got.get(key), tone_mass)):
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
