"""Helpers that hold a transcription to a stored reference result.

``testdata/golden.wav`` is 8 s of synthetic multi-speaker speech and
``testdata/golden.json`` the JAX engine's result on it (``to_dict`` form)
with its greedy CTC ids; ``golden_a8.json`` and ``golden_w8.json`` are the
JAX engine's results with ``quantize="a8"`` and ``"w8"``, and
``golden_decoders.json`` its result with the release translator and
summarizer loaded. The tests hold the port's CPU results to them, and
``chip_smoke.py`` holds the card's results to them, by one criterion:
identical segment texts, speakers, languages, emotions and translations,
identical summary and detected languages, segment and word times within one
subsampled frame (40 ms), and greedy CTC ids equal on at least 99.5 % of
valid frames.

The summary's "Overall tone" is the argmax of the segments'
duration-weighted emotion probabilities (``tone_mass``). Each fixture
stores the reference's masses; where its top two are closer than
``TONE_TIE`` of the total, the decision lies inside the numerical noise of
two implementations, and the criterion accepts either of those two tones
(the rest of the summary must still be identical).

The decoders' fixture also stores, for each translated span and for the
summary, the JAX decode's tokens and the smallest gap between its top two
logits where a token was chosen freely; each gap must be at least
``MIN_TOKEN_GAP``, so that an exact check of the decoded bytes is fair.

It also holds the port's copies of the JAX package's test doubles
(``omnilingual_asr_tpu/testing.py``): ``demo_result``, the canned
code-switching transcript that the server's ``/api/demo`` route serves, and
``FakeEngine``, an engine double with the real engine's surface.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .audio.decode import get_audio_duration
from .types import (EMOTIONS, PROGRESS_STEPS, TranscriptSegment,
                    TranscriptionResult, WordTimestamp)

TESTDATA = Path(__file__).resolve().parent / "testdata"
GOLDEN_WAV = TESTDATA / "golden.wav"
GOLDEN_JSON = TESTDATA / "golden.json"
GOLDEN_DECODERS_JSON = TESTDATA / "golden_decoders.json"

#: One subsampled encoder frame (4 x 10 ms hop).
TIME_TOL_S = 0.04
MIN_CTC_AGREEMENT = 0.995
#: Share of the total tone mass below which the reference's top two tones
#: count as tied. The port's CPU masses move the top-two margin by up to
#: 0.33 % of the total against the JAX engine's on the golden file (f16
#: emotion logits on the wire, bf16 roundings flipped by summation order);
#: 0.5 % leaves room for the card's other orders.
TONE_TIE = 0.005
#: Least top-two logit gap of a freely chosen token in the decoders'
#: fixture. On the fixture's translated spans the port's CPU logits differ
#: from the reference's by up to 0.057 a logit, and its top-two gaps by up
#: to 0.046 (bf16 roundings of activations flipped by f32 summation order);
#: a gap moves by at most twice the first, and 0.25 leaves room for the
#: card's summation orders on top of that.
MIN_TOKEN_GAP = 0.25

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


def load_golden_decoders() -> dict:
    return json.loads(GOLDEN_DECODERS_JSON.read_text())


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


# ---------------------------------------------------------------------------
# Test doubles (the JAX package's, kept in step)
# ---------------------------------------------------------------------------

def demo_result() -> TranscriptionResult:
    """Canned code-switching result in the reference's result shape."""
    segs = [
        TranscriptSegment(
            start=0.0, end=3.2, speaker="Speaker 1",
            text="ꓢꓳ ꓟꓬꓰ ꓠꓬ, hello everyone.",
            language="Lisu", language_code="lis",
            languages=[{"name": "Lisu", "code": "lis"},
                       {"name": "English", "code": "en"}],
            emotion="happy", translation="Good morning, hello everyone.",
            words=[WordTimestamp("ꓢꓳ", 0.0, 0.6),
                   WordTimestamp("ꓟꓬꓰ", 0.6, 1.2),
                   WordTimestamp("ꓠꓬ,", 1.2, 1.8),
                   WordTimestamp("hello", 1.8, 2.5),
                   WordTimestamp("everyone.", 2.5, 3.2)]),
        TranscriptSegment(
            start=3.5, end=6.0, speaker="Speaker 2",
            text="Thanks for joining today.",
            language="English", language_code="en",
            languages=[{"name": "English", "code": "en"}],
            emotion="neutral", translation=None,
            words=[WordTimestamp("Thanks", 3.5, 4.0),
                   WordTimestamp("for", 4.0, 4.3),
                   WordTimestamp("joining", 4.3, 5.0),
                   WordTimestamp("today.", 5.0, 6.0)]),
    ]
    return TranscriptionResult(
        summary="Two speakers greet each other in Lisu and English. "
                "Overall tone: happy.",
        segments=segs,
        detected_languages=[{"code": "lis", "language": "Lisu"},
                            {"code": "en", "language": "English"}],
    )


class FakeEngine:
    """Drop-in engine double: same methods, progress contract and retry
    semantics as TranscriptionEngine, no accelerator required.

    fail_times: raise on the first N transcribe calls (fault injection for
    the retry path, reference gemini_pipeline.py:717-737)."""

    def __init__(self, result: Optional[TranscriptionResult] = None,
                 fail_times: int = 0, delay_s: float = 0.0):
        self.result = result or demo_result()
        self.fail_times = fail_times
        self.delay_s = delay_s
        self.calls: List[dict] = []

    def transcribe(self, audio_path, *, progress_callback=None,
                   language=None, speaker_count=None) -> TranscriptionResult:
        self.calls.append({"path": str(audio_path), "language": language,
                           "speaker_count": speaker_count})
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("injected failure")
        for idx, step in enumerate(PROGRESS_STEPS):
            if progress_callback:
                progress_callback(step, idx)
            if self.delay_s:
                time.sleep(self.delay_s / len(PROGRESS_STEPS))
        return self.result

    transcribe_chunked = transcribe

    def transcribe_streaming(self, audio_path, *, language=None,
                             speaker_count=None, orthography=None):
        """Streaming double: one partial per segment, then the final."""
        result = self.result
        for seg in result.segments:
            yield ("partial", [seg])
        yield ("final", result)

    def transcribe_with_retry(self, audio_path, *, max_retries: int = 3,
                              progress_callback=None, language=None,
                              speaker_count=None) -> TranscriptionResult:
        get_audio_duration(Path(audio_path))  # parity: probe like the real one
        last = None
        for attempt in range(max_retries):
            try:
                return self.transcribe(
                    audio_path, progress_callback=progress_callback,
                    language=language, speaker_count=speaker_count)
            except Exception as e:  # noqa: BLE001
                last = e
        raise RuntimeError(
            f"Failed to transcribe after {max_retries} attempts: {last}")
