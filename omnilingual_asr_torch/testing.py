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

``golden_evals.json`` (with ``golden_evals_ids.npz``, each synthetic
file's greedy CTC ids a window) holds the JAX package's evaluation drivers'
results with the release weights: ``eval_synth`` on ``eval_set(96)`` at
10 s windows, ``eval_heads`` on ``eval_set(64)`` with the release
translator and summarizer, ``eval_diar`` on 16 conversations and the
engine on ``make_long_audio(420)`` (with its windows' greedy ids, and
the JAX engine's own distance from that result under 1-LSB perturbations
of the audio). ``synth_mismatches``, ``heads_mismatches``,
``diar_mismatches`` and ``long_mismatches`` hold the port's drivers to it
by the tolerances below.

The tests that regenerate and read the fixtures share the helpers below
the tolerances: ``wav_bytes`` and ``tiled_pcm`` write the golden audio,
``greedy_ids`` and ``sequence_ids`` read an engine's greedy CTC ids (the
JAX engine's or the port's).

It also holds the port's copies of the JAX package's test doubles
(``omnilingual_asr_tpu/testing.py``): ``demo_result``, the canned
code-switching transcript that the server's ``/api/demo`` route serves, and
``FakeEngine``, an engine double with the real engine's surface.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import time
import wave
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
GOLDEN_SEQUENCE_JSON = TESTDATA / "golden_sequence.json"
GOLDEN_F32_JSON = TESTDATA / "golden_f32.json"
GOLDEN_F16_JSON = TESTDATA / "golden_f16.json"
GOLDEN_D512_JSON = TESTDATA / "golden_d512_crop.json"
GOLDEN_D512_FEED = TESTDATA / "golden_d512_crop_topk.npz"
GOLDEN_EVALS_JSON = TESTDATA / "golden_evals.json"
GOLDEN_EVALS_IDS = TESTDATA / "golden_evals_ids.npz"

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
#: The beam texts of ``golden_d512_crop.json`` are held exactly where the
#: JAX engine's decode is stable: its text unchanged in BEAM_NOISE_DRAWS
#: searches over its top-K log-probabilities plus N(0, BEAM_NOISE_SIGMA)
#: noise. The d512 seed's top-K feed from the port on the H100 differs
#: from the JAX engine's by ~0.015 a value on average and by up to ~0.3
#: (bf16 roundings flipped by another summation order, through 12
#: layers), and ~2.5 % of frames swap a class at the top-K boundary
#: (``chip_smoke.py`` phase 4f prints these, and each decode's gap and
#: outcome). Where the search turns on less, a character or two changes:
#: 4 of the fixture's 13 decodes on the card, some of them further ahead
#: of their runner-up than decodes that held, so the top-two gap does not
#: predict it. At sigma 0.03 and 16 draws the decodes marked stable held.
BEAM_NOISE_SIGMA = 0.03
BEAM_NOISE_DRAWS = 16
BEAM_NOISE_SEED = 20_261_017
#: Least number of stable decodes for the fixture to be regenerated.
MIN_STABLE_BEAM_DECODES = 2
#: The beam search's feed against the fixture's (``golden_d512_crop_
#: topk.npz``), per frame and class rank: log-probabilities within
#: FEED_TOL (the measured differences reach 0.3), and the classes equal
#: wherever a value stands more than 2 FEED_TOL from its neighbours. A
#: wrong log-softmax, sort order or class index moves values by nats.
FEED_TOL = 0.5

#: The evals fixture's tolerances. Over its 96 synthetic files the greedy
#: argmax of two implementations' forwards may flip a character where two
#: classes are close: at least SYNTH_MIN_EXACT_SHARE of the texts must be
#: identical, and the greedy ids of the files together must agree on
#: MIN_CTC_AGREEMENT of their frames (a file has ~50-150 valid frames, so
#: one flipped frame is 0.7-2 % of its own: the ids are pooled, as
#: ``d512_mismatches`` pools its two files'); corpus WER and CER within
#: SYNTH_RATE_TOL.
SYNTH_MIN_EXACT_SHARE = 94 / 96
SYNTH_RATE_TOL = 0.005
#: Language-ID and emotion: equal on every file, except an emotion where
#: the file's reference tone mass has its top two within TONE_TIE (at most
#: HEADS_MAX_TIED such files); translation word accuracy within
#: TRANSLATION_ACC_TOL; the summary accuracies equal.
HEADS_MAX_TIED = 1
TRANSLATION_ACC_TOL = 0.01
#: Diarization: the hypothesis speaker count equal on at least
#: DIAR_MIN_COUNT_SHARE of the conversations, each DER within DIAR_DER_TOL
#: and the mean within DIAR_MEAN_TOL.
DIAR_MIN_COUNT_SHARE = 15 / 16
DIAR_DER_TOL = 0.02
DIAR_MEAN_TOL = 0.01
#: The long file (``eval/long.py::make_long_audio``: tones, noise and
#: gates, not speech) leaves the CTC head near a tie on many frames, and
#: its whole result is not stable under noise far below two
#: implementations' differences: raising or lowering one sample in 1 000
#: by one LSB moves the JAX engine's own result from 212 to 214 segments,
#: its joined text by a CER of up to 0.018, a segment boundary or text on
#: up to 10 % of segments (the fixture's "perturbed" rows). It is held by
#: the windows' greedy ids (MIN_CTC_AGREEMENT) and by its structure: DER
#: against the reference's turns at most LONG_MAX_DER (one small speaker
#: cluster merged or split reads ~0.03), joined-text CER at most
#: LONG_MAX_CER, at least LONG_MIN_SEGMENT_MATCH of the reference's
#: segments matched within TIME_TOL_S at both ends, the speaker count
#: within one; and the streamed-WAV path taken (no ``decode`` stage).
LONG_MAX_DER = 0.05
LONG_MAX_CER = 0.05
LONG_MIN_SEGMENT_MATCH = 0.9

#: The trainers (``train/{xvector,text_translator,translator,summary}_
#: train.py``) against the JAX trainers on the CPU, from the same
#: parameters and data (``tests/test_torch_trainers_*.py``). The loss of
#: each step within TRAINER_LOSS_REL (measured: under 2e-5 relative).
#: Parameters after 2 steps, per leaf ||got - want|| / ||want||, within
#: TRAINER_PARAM_REL: the first update has learning rate 0, and from the
#: second Adam moves each element by about lr * sign(g), so an element
#: whose gradient is near 0 and differs in sign between the two packages
#: (f32 sums in another order) moves 2 lr apart; on a leaf that was zero
#: at init (biases, the decoder's position table) that is a share of the
#: whole leaf (measured at most 0.048, the audio translator's ``pos``).
TRAINER_LOSS_REL = 1e-4
TRAINER_PARAM_REL = 0.15
#: x-vector: pooled embeddings (unit vectors) of one mel per element
#: within TRAINER_EMBED_TOL (measured 4.5e-8) and the AAM loss's gradient
#: per leaf within TRAINER_GRAD_REL relative L2 (measured at most 8.3e-3:
#: bf16 convolution inputs and their gradients, rounded from f32 sums
#: taken in another order); the eval's mean cosine distances within
#: TRAINER_DIST_TOL (printed to 4 decimals; measured equal) and its
#: violation rate within TRAINER_VIOL_TOL (measured 1e-4 apart).
TRAINER_EMBED_TOL = 1e-4
TRAINER_GRAD_REL = 5e-2
TRAINER_DIST_TOL = 1e-3
TRAINER_VIOL_TOL = 5e-3
#: The frozen encoders' outputs per element, from the same audio (each
#: package's own log-mel): ``UtteranceEncoder``'s bf16 states within
#: TRAINER_STATE_TOL (measured 0.0156, one bf16 ulp of a state near 3.6:
#: activations' bf16 roundings flipped by f32 sums in another order,
#: through the conformer) and ``WindowEncoder``'s f32 window means within
#: TRAINER_POOL_TOL (measured at most 7.7e-4).
TRAINER_STATE_TOL = 5e-2
TRAINER_POOL_TOL = 5e-3
#: Training over a (data, model) mesh against the same step on one device
#: (``tests/test_torch_mesh_train.py``, tiny_config with 4 heads, batch 8
#: with ragged rows and an unalignable one, the translator, SpecAugment
#: and dropout on): the loss within MESH_LOSS_REL (measured at most 7.2e-8),
#: each leaf's gradient and clipped gradient within MESH_GRAD_REL relative
#: L2 (measured 3.7e-3 at (8, 1), 6.0e-3 at (4, 2), 4.8e-3 at (2, 4)).
#: The gap is bf16: each data row's and model shard's dense call rounds
#: its own partial of a weight's gradient to bf16 (the backward of the
#: operands' rounding) before the partials are summed, where one device
#: rounds the sum once, ~2^-8 of a leaf. With that rounding taken out the
#: mesh's gradients equal one device's within MESH_F32_GRAD_REL (measured
#: 1.4e-5 at (4, 2), 8.8e-6 at (2, 4)), the f32 order of sums.
MESH_LOSS_REL = 1e-4
MESH_GRAD_REL = 1e-2
MESH_F32_GRAD_REL = 1e-4

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


def load_golden_sequence() -> dict:
    """The JAX engine's sequence-mode result on the golden file (one
    device), its greedy ids over the file's frames (one list) and its tone
    mass."""
    return json.loads(GOLDEN_SEQUENCE_JSON.read_text())


def load_golden_f32() -> dict:
    """The JAX engine's result with the release weights and the f32
    encoder (``encoder.dtype="float32"``), window mode: on the golden file
    (result, greedy ids, tone mass) and, under ``"tiled"``, on the golden
    audio tiled to 120 s (the same keys)."""
    return json.loads(GOLDEN_F32_JSON.read_text())


def load_golden_f16() -> dict:
    """The JAX engine's results at f16 (``encoder.dtype="float16"``), with
    the keys of :func:`load_golden_f32`."""
    return json.loads(GOLDEN_F16_JSON.read_text())


def load_golden_d512() -> dict:
    return json.loads(GOLDEN_D512_JSON.read_text())


def load_golden_evals() -> dict:
    """``golden_evals.json`` with each synthetic file's greedy ids (a list
    of windows) under ``data["synth"]["files"][i]["ctc_ids"]``."""
    data = json.loads(GOLDEN_EVALS_JSON.read_text())
    ids = np.load(GOLDEN_EVALS_IDS)
    for i, f in enumerate(data["synth"]["files"]):
        f["ctc_ids"] = [ids[f"synth/{i}/{w}"].tolist()
                        for w in range(f["n_windows"])]
    data["long"]["ctc_ids"] = [ids[f"long/{w}"].tolist()
                               for w in range(data["long"]["n_windows"])]
    return data


@contextlib.contextmanager
def recorded_ctc_ids(engine):
    """Within the block, each call of ``engine._forward_batches`` (either
    engine's) appends the list of its windows' greedy CTC ids (valid
    frames) to the yielded list."""
    calls = []
    inner = engine._forward_batches

    def recording(*args, **kwargs):
        ids = []
        calls.append(ids)
        for outs in inner(*args, **kwargs):
            ids.extend(np.asarray(o["ctc_ids"]).astype(int).tolist()
                       for o in outs)
            yield outs

    engine._forward_batches = recording
    try:
        yield calls
    finally:
        del engine._forward_batches


def tone_mass(engine, path) -> List[float]:
    """The engine's duration-weighted emotion probabilities on ``path``,
    whose argmax is the summary's overall tone (the aggregation of either
    engine's ``_assemble_global``)."""
    samples = engine._load_audio(path)
    if getattr(engine, "long_mode", "window") == "sequence":
        parts = engine._extract_windows(engine._forward_sequence(samples))
    else:
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


def _emotions_tied(want: str, got: str, mass: Sequence[float]) -> bool:
    """True when ``want`` and ``got`` are the reference's top two emotions
    by ``mass`` (in that order) and those are tied (``TONE_TIE``)."""
    order = np.argsort(mass)[::-1]
    first, second = EMOTIONS[order[0]], EMOTIONS[order[1]]
    margin = mass[order[0]] - mass[order[1]]
    return (want == first and got == second
            and margin < TONE_TIE * float(np.sum(mass)))


def _tone_tied(want: str, got: str, mass: Optional[Sequence[float]]) -> bool:
    """True when two summaries differ only in their overall tone, both
    tones are the reference's top two, and those are tied (``TONE_TIE``)."""
    if mass is None or not isinstance(want, str) or not isinstance(got, str):
        return False
    tw, tg = _TONE.search(want), _TONE.search(got)
    if not (tw and tg) or _TONE.sub("", want) != _TONE.sub("", got):
        return False
    return _emotions_tied(tw.group(1), tg.group(1), mass)


def result_mismatches(want: dict, got: dict, time_tol: float = TIME_TOL_S,
                      tone_mass: Optional[Sequence[float]] = None,
                      free_text: Sequence[int] = (),
                      free_words: bool = False) -> List[str]:
    """Differences between two ``TranscriptionResult.to_dict()`` results
    beyond the criterion; empty when they agree. ``tone_mass`` is the
    reference's (a fixture's ``"tone_mass"``); without it the summary must
    be identical. ``free_text``: indices of segments whose text is not
    compared (the d512 fixture's unstable beam decodes); with
    ``free_words`` their words are not either, but for their count (a
    changed character moves a word's times)."""
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
            if f == "text" and i in free_text:
                continue
            if w.get(f) != g.get(f):
                bad.append(f"segment {i} {f}: {g.get(f)!r}, want "
                           f"{w.get(f)!r}")
        for f in ("start", "end"):
            if abs(w[f] - g[f]) > time_tol + 1e-9:
                bad.append(f"segment {i} {f}: {g[f]}, want {w[f]}")
        ww, gw = w.get("words") or [], g.get("words") or []
        if free_words and i in free_text:
            if len(ww) != len(gw):
                bad.append(f"segment {i}: {len(gw)} words, want {len(ww)}")
            continue
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


def d512_mismatches(mode: str, results: dict, ids: dict,
                    near_ties: bool = False) -> List[str]:
    """``results`` ({file: ``to_dict()`` result}) of the d512 crop engine
    in ``mode`` ("greedy" or "beam") and its greedy ids ({file: ids a
    window}) against ``golden_d512_crop.json``: each result by
    ``result_mismatches`` (in beam mode the texts of unstable decodes
    free), and the ids of all the files' windows together on at least
    MIN_CTC_AGREEMENT of their frames (the golden file alone has 191).
    With ``near_ties`` the greedy texts (and words) of the segments
    :func:`d512_greedy_near_ties` names are free as well; everything
    else of them is held."""
    stored = load_golden_d512()["files"]
    bad = []
    for name, got in results.items():
        entry = stored[name][mode]
        free = [i for i, d in enumerate(entry.get("decodes", ()))
                if not d["stable"]]
        if near_ties and mode == "greedy":
            free = d512_greedy_near_ties(name)
        bad += [f"{name} {mode}: {m}" for m in result_mismatches(
            entry["result"], got, tone_mass=entry["tone_mass"],
            free_text=free, free_words=near_ties)]
    agree = ctc_agreement([w for n in ids for w in stored[n][mode]["ctc_ids"]],
                          [w for n in ids for w in ids[n]])
    if agree < MIN_CTC_AGREEMENT:
        bad.append(f"{mode}: greedy ids agree on {agree:.4f} of frames")
    return bad


def d512_greedy_near_ties(name: str, window_s: float = 30.0,
                          frame_s: float = TIME_TOL_S) -> List[int]:
    """Indices of file ``name``'s greedy segments in
    ``golden_d512_crop.json`` whose text turns on a near tie: a frame in
    the segment's span where the JAX engine's top two log-probabilities
    (``golden_d512_crop_topk.npz``, the same forward's) stand within
    2 FEED_TOL, the distance within which two implementations' feeds may
    swap classes (:func:`d512_feed_mismatches`). The d512 seed's greedy
    segments all hold one (least gaps 0.0-0.14)."""
    feed = np.load(GOLDEN_D512_FEED)
    gaps = []
    w = 0
    while f"{name}/{w}/lp" in feed:
        lp = feed[f"{name}/{w}/lp"]
        gaps.append(lp[:, 0] - lp[:, 1])
        w += 1
    out = []
    segs = load_golden_d512()["files"][name]["greedy"]["result"]["segments"]
    for i, seg in enumerate(segs):
        for w, g in enumerate(gaps):
            a = max(seg["start"] - w * window_s, 0.0)
            b = min(seg["end"] - w * window_s, window_s)
            if b <= a:
                continue
            span = g[int(a / frame_s):int(math.ceil(b / frame_s))]
            if len(span) and float(span.min()) <= 2 * FEED_TOL:
                out.append(i)
                break
    return out


def d512_feed_mismatches(feeds: dict) -> List[str]:
    """``feeds`` ({file: [(log-probabilities, classes) a window]}, the beam
    search's top-K feed over each window's valid frames) against the JAX
    engine's in ``golden_d512_crop_topk.npz`` by the FEED_TOL rule."""
    want = np.load(GOLDEN_D512_FEED)
    bad = []
    for name, windows in feeds.items():
        for w, (lp, ids) in enumerate(windows):
            wl, wi = want[f"{name}/{w}/lp"], want[f"{name}/{w}/ids"]
            if lp.shape != wl.shape:
                bad.append(f"{name} window {w}: feed {lp.shape}, want "
                           f"{wl.shape}")
                continue
            err = float(np.abs(lp - wl).max())
            gap = np.abs(np.diff(wl, axis=1)) > 2 * FEED_TOL
            apart = np.ones(wl.shape, bool)
            apart[:, :-1] &= gap
            apart[:, 1:] &= gap
            apart[:, -1] = False      # the next class is not shipped
            n_diff = int((ids[apart] != wi[apart]).sum())
            if err > FEED_TOL or n_diff:
                bad.append(f"{name} window {w}: max |dlogp| {err:.3f}, "
                           f"{n_diff} classes differ where apart")
    return bad


def d512_beam_texts(results: dict) -> dict:
    """How many beam texts of ``results`` ({file: result}) equal the
    fixture's, among its stable and its unstable decodes."""
    stored = load_golden_d512()["files"]
    out = {"stable": [0, 0], "unstable": [0, 0]}
    for name, got in results.items():
        for d, w, g in zip(stored[name]["beam"]["decodes"],
                           stored[name]["beam"]["result"]["segments"],
                           got["segments"]):
            row = out["stable" if d["stable"] else "unstable"]
            row[0] += w["text"] == g["text"]
            row[1] += 1
    return {k: f"{v[0]} of {v[1]}" for k, v in out.items()}


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


def _allowed_misses(n: int, share: float) -> int:
    """How many of ``n`` items may miss when ``share`` of them must hold
    (94 of 96 files: 2; 4 files: none)."""
    return n - math.ceil(n * share - 1e-9)


def synth_mismatches(want: dict, hyps: Sequence[str],
                     ids: Sequence[Sequence[Sequence[int]]],
                     wer: Optional[float] = None,
                     cer: Optional[float] = None) -> List[str]:
    """The first ``len(hyps)`` files' texts and greedy ids (windows a
    file) against ``want`` (``load_golden_evals()["synth"]``), and the
    corpus WER/CER where given (then every file must be there)."""
    files = want["files"][:len(hyps)]
    bad = []
    differ = [f"file {i}: {hyp!r}, want {w['hyp']!r} (its ids agree on "
              f"{ctc_agreement(w['ctc_ids'], got):.4f})"
              for i, (w, hyp, got) in enumerate(zip(files, hyps, ids))
              if hyp != w["hyp"]]
    if len(differ) > _allowed_misses(len(files), SYNTH_MIN_EXACT_SHARE):
        bad.append(f"synth: texts differ on {len(differ)} of {len(files)} "
                   f"files: " + "; ".join(differ))
    agree = ctc_agreement([x for w in files for x in w["ctc_ids"]],
                          [x for got in ids[:len(files)] for x in got])
    if agree < MIN_CTC_AGREEMENT:
        bad.append(f"synth: greedy ids agree on {agree:.4f} of the files' "
                   f"frames; " + "; ".join(differ))
    for key, got in (("wer", wer), ("cer", cer)):
        if got is None:
            continue
        if len(hyps) != len(want["files"]):
            bad.append(f"synth {key} of {len(hyps)} files, the fixture's is "
                       f"of {len(want['files'])}")
        elif abs(got - want[key]) > SYNTH_RATE_TOL:
            bad.append(f"synth {key} {got:.4f}, want {want[key]:.4f} +- "
                       f"{SYNTH_RATE_TOL}")
    return bad


def heads_mismatches(want: dict, report: dict, rows: dict) -> List[str]:
    """``eval/heads.py``'s report and rows against ``want``
    (``load_golden_evals()["heads"]``)."""
    bad, tied = [], []
    if len(rows["files"]) != len(want["files"]):
        return [f"heads: {len(rows['files'])} files, want "
                f"{len(want['files'])}"]
    for i, (w, g) in enumerate(zip(want["files"], rows["files"])):
        if (w is None) != (g is None):
            bad.append(f"heads file {i}: {g}, want {w}")
            continue
        if w is None:
            continue
        if g["language"] != w["language"]:
            bad.append(f"heads file {i} language {g['language']!r}, want "
                       f"{w['language']!r}")
        if g["emotion"] != w["emotion"]:
            if _emotions_tied(w["emotion"], g["emotion"], w["tone_mass"]):
                tied.append(i)
            else:
                bad.append(f"heads file {i} emotion {g['emotion']!r}, want "
                           f"{w['emotion']!r} (tone mass {w['tone_mass']})")
    if len(tied) > HEADS_MAX_TIED:
        bad.append(f"heads: emotions tied on files {tied}")
    wr = want["report"]
    if "translation_word_acc" in wr:
        got = report.get("translation_word_acc", -1.0)
        if abs(got - wr["translation_word_acc"]) > TRANSLATION_ACC_TOL:
            bad.append(f"heads translation_word_acc {got}, want "
                       f"{wr['translation_word_acc']} +- "
                       f"{TRANSLATION_ACC_TOL}")
    for key in ("summary_speaker_count_acc", "summary_tone_acc",
                "summary_n_conversations"):
        if report.get(key) != wr.get(key):
            bad.append(f"heads {key} {report.get(key)}, want {wr.get(key)}")
    return bad


def diar_mismatches(want: dict, details: Sequence[dict],
                    der_mean: Optional[float] = None) -> List[str]:
    """The first ``len(details)`` conversations of ``eval/diar.py``
    against ``want`` (``load_golden_evals()["diar"]``), and the mean DER
    where given (then every conversation must be there)."""
    stored = want["report"]["details"][:len(details)]
    bad, counts = [], []
    for w, g in zip(stored, details):
        if g["n_spk_ref"] != w["n_spk_ref"]:
            bad.append(f"diar conversation {w['conv']}: {g['n_spk_ref']} "
                       f"reference speakers, want {w['n_spk_ref']}")
        if g["n_spk_hyp"] != w["n_spk_hyp"]:
            counts.append(w["conv"])
        if abs(g["der"] - w["der"]) > DIAR_DER_TOL:
            bad.append(f"diar conversation {w['conv']}: DER {g['der']}, "
                       f"want {w['der']} +- {DIAR_DER_TOL}")
    if len(counts) > _allowed_misses(len(stored), DIAR_MIN_COUNT_SHARE):
        bad.append(f"diar: speaker counts differ on conversations {counts}")
    if der_mean is not None:
        if len(details) != len(want["report"]["details"]):
            bad.append(f"diar mean DER of {len(details)} conversations")
        elif abs(der_mean - want["der_mean"]) > DIAR_MEAN_TOL:
            bad.append(f"diar mean DER {der_mean:.4f}, want "
                       f"{want['der_mean']:.4f} +- {DIAR_MEAN_TOL}")
    return bad


def long_agreement(want: dict, got: dict) -> dict:
    """How far result ``got`` (``to_dict()`` form) is from ``want``: DER
    of ``got``'s turns against ``want``'s, CER of the joined texts, the
    share of ``want``'s segments that ``got`` has within TIME_TOL_S at
    both ends, both segment and speaker counts."""
    from .utils.metrics import cer, der

    ws, gs = want["segments"], got["segments"]
    bounds = np.array([[s["start"], s["end"]] for s in gs]).reshape(-1, 2)
    matched = sum(bool(len(bounds)) and float(np.abs(
        bounds - [s["start"], s["end"]]).max(axis=1).min())
        <= TIME_TOL_S + 1e-9 for s in ws)
    return {
        "der": der([(s["start"], s["end"], s["speaker"]) for s in ws],
                   [(s["start"], s["end"], s["speaker"]) for s in gs]),
        "cer": cer(" ".join(s["text"] for s in ws),
                   " ".join(s["text"] for s in gs), normalize=False),
        "segment_match": matched / len(ws) if ws else 1.0,
        "n_segments": [len(ws), len(gs)],
        "n_speakers": [len({s["speaker"] for s in ws}),
                       len({s["speaker"] for s in gs})],
    }


def long_mismatches(want: dict, result: dict, stages: dict,
                    ids: Sequence[Sequence[int]]) -> List[str]:
    """The long file's result and its windows' greedy ids against
    ``want`` (``load_golden_evals()["long"]``) by the LONG_* rule; the
    streamed-WAV path must have been taken (no ``decode`` stage)."""
    bad = []
    agree = ctc_agreement(want["ctc_ids"], ids)
    if agree < MIN_CTC_AGREEMENT:
        bad.append(f"long: greedy ids agree on {agree:.4f} of frames")
    a = long_agreement(want["result"], result)
    if a["der"] > LONG_MAX_DER or a["cer"] > LONG_MAX_CER:
        bad.append(f"long: DER {a['der']:.4f} / CER {a['cer']:.4f} against "
                   f"the reference (at most {LONG_MAX_DER} / "
                   f"{LONG_MAX_CER})")
    if a["segment_match"] < LONG_MIN_SEGMENT_MATCH:
        bad.append(f"long: {a['segment_match']:.3f} of the reference's "
                   f"segments matched (at least {LONG_MIN_SEGMENT_MATCH})")
    if abs(a["n_speakers"][0] - a["n_speakers"][1]) > 1:
        bad.append(f"long: speakers {a['n_speakers'][1]}, want "
                   f"{a['n_speakers'][0]} +- 1")
    if "decode" in stages:
        bad.append(f"long: a decode stage ({stages['decode']} s): the "
                   f"file was not streamed")
    return bad


# ---------------------------------------------------------------------------
# Test doubles (the JAX package's, kept in step)
# ---------------------------------------------------------------------------

def wav_bytes(pcm: np.ndarray, sr: int = 16_000) -> bytes:
    """16-bit mono WAV bytes of int16 ``pcm`` at ``sr``."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def tiled_pcm(pcm: np.ndarray, seconds: float) -> np.ndarray:
    """``pcm`` repeated and cut to ``seconds`` at 16 kHz (the tiled file
    that ``chip_smoke.py`` writes)."""
    return np.resize(pcm, int(seconds * 16_000))


def greedy_ids(engine, path: Path):
    """Per-window greedy CTC ids over valid frames (either engine)."""
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    ids = []
    for outs in engine._forward_batches(windows, n_last):
        ids.extend(np.asarray(o["ctc_ids"]).astype(int).tolist()
                   for o in outs)
    return ids


def sequence_ids(engine, path: Path):
    """Sequence mode's greedy CTC ids over the file's frames, as one list
    in a list (either engine)."""
    outs = engine._forward_sequence(engine._load_audio(path))
    return [np.asarray(outs[0]["ctc_ids"]).astype(int).tolist()]


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
