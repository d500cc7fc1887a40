"""Golden fixture of the PyTorch port: the JAX engine's result on 7.6 s of
synthetic speech, stored in ``omnilingual_asr_torch/testdata``.

The tests regenerate the audio and the JAX result on the CPU and assert that
the committed files are current, then hold the port's CPU result to them by
the criterion of ``omnilingual_asr_torch.testing``. ``chip_smoke.py`` holds
the card's result to the same JSON.

The int8 fixtures (``golden_a8.json``, ``golden_w8.json``) are the JAX
engine's results with ``quantize="a8"`` and ``"w8"``; the port's engines in
those modes, and its facade, are held to them the same way.

``golden_decoders.json`` is the JAX engine's result with the release
translator and summarizer loaded by explicit path, with each decode's
tokens and its smallest top-two logit gap (``tests/test_torch_decoders.py``
holds the port to it).

``golden_d512_crop.json`` holds the JAX engine's results with the repo's
larger model, ``checkpoints/r5_d512x12_seed`` (d_model 512, 12 layers, no
x-vector weights), in crop speaker mode, on the golden file and on the
golden audio tiled to 120 s, greedy and with the beam search (beam 8, the
"synth" lexicon, ``lm_alpha`` 0.3), with the smallest gap between the best
and the runner-up final beam score of each beam decode and the number of
crop re-embeddings each request ran.

Regenerate the files with ``JAX_PLATFORMS=cpu OMNIASR_RELEASE_DIR=
python tests/test_torch_golden.py`` (or name some of ``plain a8 w8
decoders d512_crop`` to regenerate only those).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import sys
import wave
from pathlib import Path
from typing import Optional

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from omnilingual_asr_torch import testing as golden  # noqa: E402

torch.set_num_threads(2)

RELEASE = REPO / "checkpoints" / "release"
D512 = REPO / "checkpoints" / "r5_d512x12_seed" / "asr.npz"
D512_TILED_SECONDS = 120.0
#: The beam decode of the d512 fixture (DecodeConfig fields).
D512_BEAM = {"beam_size": 8, "lexicon": "synth", "lm_alpha": 0.3}
GOLDEN_SEED = 3           # eval_set seed: two speakers, languages, emotions
GOLDEN_CANDIDATES = 5
GOLDEN_MAX_S = 9.3        # keeps golden.wav under 300 KB of int16
GOLDEN_GAP_S = 1.0        # silence between utterances: a turn boundary


def golden_samples() -> np.ndarray:
    """Utterances of ``eval_set(5, seed=3)`` in order, 1 s of silence
    apart, skipping any that would push the total past 9.3 s; int16 at
    16 kHz."""
    from omnilingual_asr_tpu.train.synth import eval_set

    gap = np.zeros(int(GOLDEN_GAP_S * 16_000), np.float32)
    parts, total = [], 0
    for ex in eval_set(GOLDEN_CANDIDATES, seed=GOLDEN_SEED):
        need = len(ex.samples) + (len(gap) if parts else 0)
        if total + need <= GOLDEN_MAX_S * 16_000:
            parts.extend([gap, ex.samples] if parts else [ex.samples])
            total += need
    audio = np.concatenate(parts).astype(np.float32)
    return np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)


def wav_bytes(pcm: np.ndarray, sr: int = 16_000) -> bytes:
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


def jax_engine(quantize=False, **kwargs):
    import jax
    from omnilingual_asr_tpu.config import MeshConfig, PipelineConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    return TranscriptionEngine(
        config=cfg, xvector_path=str(RELEASE / "xvector.npz"),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]),
        batch_windows_per_device=4, quantize=quantize, **kwargs)


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


def jax_golden(path: Path, quantize=False) -> dict:
    eng = jax_engine(quantize)
    res = eng.transcribe(path)
    return {"result": dataclasses.asdict(res),
            "ctc_ids": greedy_ids(eng, path),
            "tone_mass": golden.tone_mass(eng, path)}


def _free_gaps(logits, toks, n_prefix: int):
    """Smallest top-two gap of ``logits`` [T, V] over the freely chosen
    positions of one decoded row (from ``n_prefix`` to its first free EOS),
    which must be the logits' argmax there."""
    free = np.arange(n_prefix, len(toks))
    eos = free[toks[free] == 0]
    free = free[free <= eos[0]] if len(eos) else free
    top2 = np.sort(logits[free], axis=-1)[:, -2:]
    assert (np.argmax(logits[free], axis=-1) == toks[free]).all()
    return float((top2[:, 1] - top2[:, 0]).min())


def jax_golden_decoders(path: Path) -> dict:
    """The JAX engine's result with the release decoders, and each of its
    decodes: the tokens and the smallest top-two gap of the teacher-forced
    logits over the decoded tokens (which must reproduce them)."""
    from unittest import mock

    import jax.numpy as jnp
    from omnilingual_asr_tpu.models import summarizer as jsum
    from omnilingual_asr_tpu.models import translation as jtr

    eng = jax_engine(translator_path=str(RELEASE / "translator.npz"),
                     summarizer_path=str(RELEASE / "summarizer.npz"))
    calls = {"translate": [], "summary": []}
    translate_text = jtr.translate_text
    greedy_translate = jsum.greedy_translate

    def rec_translate(params, tokens, mask, cfg, **kw):
        out = translate_text(params, tokens, mask, cfg, **kw)
        calls["translate"].append((np.asarray(tokens), np.asarray(mask),
                                   np.asarray(out)))
        return out

    def rec_summary(params, enc, mask, cfg, **kw):
        out = greedy_translate(params, enc, mask, cfg, **kw)
        calls["summary"].append((np.asarray(enc), np.asarray(mask),
                                 np.asarray(kw["forced"]), np.asarray(out)))
        return out

    with mock.patch.object(jtr, "translate_text", rec_translate), \
            mock.patch.object(jsum, "greedy_translate", rec_summary):
        res = eng.transcribe(path)
    cfg, vocab = eng.config, eng.config.vocab
    n_real = 1 + vocab.n_bytes

    def gaps(params, mem, mask, toks, n_prefix):
        inp = np.concatenate([np.zeros_like(toks[:, :1]), toks[:, :-1]], 1)
        logits = np.asarray(jtr.decoder_forward(
            params, jnp.asarray(inp), mem, jnp.asarray(mask), cfg))
        return [_free_gaps(lg[:, :n_real], t, n_prefix)
                for lg, t in zip(logits, toks)]

    translations = []
    for ids, mask, toks in calls["translate"]:
        rows = mask.any(axis=1)
        ids, mask, toks = ids[rows], mask[rows], toks[rows]
        mem = jtr.encode_source(eng._translator, jnp.asarray(ids),
                                jnp.asarray(mask), cfg)
        for i, gap in enumerate(gaps(eng._translator, mem, mask, toks, 0)):
            span = bytes(vocab.id_to_byte(int(t))
                         for t in ids[i][mask[i]]).decode("utf-8")
            translations.append({"span": span,
                                 "tokens": toks[i].tolist(),
                                 "min_gap": gap})
    (enc, mask, forced, toks), = calls["summary"]
    n_prefix = int((forced[0] >= 0).sum())
    gap, = gaps(eng._summarizer.params, jnp.asarray(enc), mask, toks,
                n_prefix)
    return {"result": dataclasses.asdict(res),
            "ctc_ids": greedy_ids(eng, path),
            "tone_mass": golden.tone_mass(eng, path),
            "translations": translations,
            "summary": {"tokens": toks[0].tolist(), "n_prefix": n_prefix,
                        "min_gap": gap}}


def _beam_gap(beams, lm, alpha: float, bonus: float) -> Optional[float]:
    """Gap between the best and the runner-up final beam score (the fused
    ranking ``ops/beam.py`` sorts by: acoustic + alpha (lm + completion) +
    bonus n_words); None with a single beam."""
    if len(beams) < 2:
        return None
    keys = []
    for b in beams[:2]:
        st, lp = lm.start(), 0.0
        for c in b.prefix:
            st, d = lm.advance(st, c - 1)
            lp += d
        n_words, d = lm.finalize(st)
        keys.append(b.score + alpha * (lp + d) + bonus * n_words)
    return keys[0] - keys[1]


def _beam_stable(engine, topk, f0: int, f1: int, text) -> bool:
    """True when the JAX engine's beam text of frames [f0, f1) stays
    ``text`` in each of ``testing.BEAM_NOISE_DRAWS`` searches
    (``_beam_text``) over its top-K log-probabilities plus
    N(0, ``testing.BEAM_NOISE_SIGMA``) noise."""
    rng = np.random.default_rng(golden.BEAM_NOISE_SEED + f0)
    lp, ids = topk
    for _ in range(golden.BEAM_NOISE_DRAWS):
        noisy = (lp + rng.normal(0.0, golden.BEAM_NOISE_SIGMA,
                                 lp.shape)).astype(np.float32)
        if engine._beam_text((noisy, ids), f0, f1) != text:
            return False
    return True


def jax_golden_d512(paths: dict):
    """The JAX engine with ``checkpoints/r5_d512x12_seed`` in crop mode on
    ``paths`` ({name: wav}), greedy and with D512_BEAM: each result, its
    greedy ids, tone masses and crop re-embedding calls; for the beam
    mode, every decode (one a segment: its window, frames, text, the gap
    of its best final score over the runner-up, and whether the text is
    stable under ``_beam_stable``'s perturbation). Returns (fixture, the
    beam mode's top-K feed by "<file>/<window>/lp|ids")."""
    import jax
    from unittest import mock

    from omnilingual_asr_tpu.config import MeshConfig, config_for_checkpoint
    from omnilingual_asr_tpu.engine import TranscriptionEngine
    from omnilingual_asr_tpu.ops import beam as jbeam
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    base = config_for_checkpoint(str(D512))
    out = {"checkpoint": str(D512.relative_to(REPO)), "beam": D512_BEAM,
           "speaker_mode": "crop",
           "beam_noise": {"sigma": golden.BEAM_NOISE_SIGMA,
                          "draws": golden.BEAM_NOISE_DRAWS,
                          "seed": golden.BEAM_NOISE_SEED},
           "files": {}}
    feed = {}
    for mode in ("greedy", "beam"):
        cfg = base if mode == "greedy" else base.replace(
            decode=dataclasses.replace(base.decode, **D512_BEAM))
        eng = TranscriptionEngine(
            config=cfg, speaker_mode="crop", batch_windows_per_device=4,
            mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
        search = jbeam.ctc_prefix_beam_search
        beam_text = eng._beam_text
        crop = eng._segment_crop_embeds
        for name, path in paths.items():
            gaps, crops, decodes, windows = [], [], [], []

            def rec_search(*a, **kw):
                beams = search(*a, **kw)
                gaps.append(_beam_gap(beams, kw["lm"], kw["lm_alpha"],
                                      kw["word_bonus"]))
                return beams

            def rec_beam(topk, f0, f1):
                text = beam_text(topk, f0, f1)
                if not windows or windows[-1][0] is not topk[0]:
                    windows.append(topk)
                decodes.append({"window": len(windows) - 1, "f0": int(f0),
                                "f1": int(f1), "text": text})
                return text

            def rec_crop(*a):
                crops.append(1)
                return crop(*a)

            with mock.patch.object(jbeam, "ctc_prefix_beam_search",
                                   rec_search), \
                    mock.patch.object(eng, "_beam_text", rec_beam), \
                    mock.patch.object(eng, "_segment_crop_embeds", rec_crop):
                res = eng.transcribe(path)
            entry = {"result": dataclasses.asdict(res),
                     "ctc_ids": greedy_ids(eng, path),
                     "tone_mass": golden.tone_mass(eng, path),
                     "crop_calls": len(crops)}
            if mode == "beam":
                for d, gap in zip(decodes, gaps):
                    d["gap"] = gap
                    d["stable"] = _beam_stable(
                        eng, windows[d["window"]], d["f0"], d["f1"],
                        d["text"])
                entry["decodes"] = decodes
                for w, (lp, ids) in enumerate(windows):
                    feed[f"{name}/{w}/lp"] = np.asarray(lp, np.float32)
                    feed[f"{name}/{w}/ids"] = np.asarray(ids, np.int16)
            out["files"].setdefault(name, {})[mode] = entry
    return out, feed


#: The release engine's wire modes held in ``golden_d512_crop.json`` beside
#: the d512 results: engine keywords and DecodeConfig fields.
RELEASE_WIRE_MODES = {"mulaw": ({"ingress": "mulaw"}, {}),
                      "i8_stride2": ({}, {"spk_wire": "i8",
                                          "spk_frame_stride": 2})}


def _release_wire_config(cls, decode: dict):
    cfg = cls.from_json((RELEASE / "config.json").read_text(),
                        checkpoint_path=str(RELEASE / "asr.npz"))
    return cfg.replace(decode=dataclasses.replace(cfg.decode, **decode))


def jax_golden_release_wire(path: Path) -> dict:
    """The JAX release engine (x-vector inline) on ``path`` in each of
    RELEASE_WIRE_MODES: result, greedy ids and tone masses."""
    import jax
    from omnilingual_asr_tpu.config import MeshConfig, PipelineConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    out = {}
    for mode, (kwargs, decode) in RELEASE_WIRE_MODES.items():
        eng = TranscriptionEngine(
            config=_release_wire_config(PipelineConfig, decode),
            xvector_path=str(RELEASE / "xvector.npz"),
            mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]),
            batch_windows_per_device=4, **kwargs)
        out[mode] = {"result": dataclasses.asdict(eng.transcribe(path)),
                     "ctc_ids": greedy_ids(eng, path),
                     "tone_mass": golden.tone_mass(eng, path)}
    return out


def check_d512_margins(data: dict) -> None:
    """The d512 fixture is a fair check: one beam decode a segment of each
    beam result; at least ``testing.MIN_STABLE_BEAM_DECODES`` decodes whose
    text survives the perturbation (their texts are held exactly; the
    others are near ties between beams and are held by the rest of the
    criterion); and crop re-embedding ran on the tiled file (the golden
    file alone is one segment at d512, which crop mode does not
    re-embed)."""
    decodes = [d for f in data["files"].values()
               for d in f["beam"]["decodes"]]
    for f in data["files"].values():
        assert len(f["beam"]["decodes"]) == \
            len(f["beam"]["result"]["segments"])
    assert sum(d["stable"] for d in decodes) >= \
        golden.MIN_STABLE_BEAM_DECODES
    for mode in ("greedy", "beam"):
        assert data["files"]["tiled"][mode]["crop_calls"] == 1
        assert len(data["files"]["tiled"][mode]["result"]["segments"]) > 1


def d512_paths(directory: Path) -> dict:
    """The d512 fixture's files under ``directory``: the golden audio and
    the same tiled to D512_TILED_SECONDS."""
    directory.mkdir(parents=True, exist_ok=True)
    tiled = directory / "golden_tiled_120s.wav"
    tiled.write_bytes(wav_bytes(tiled_pcm(golden_samples(),
                                          D512_TILED_SECONDS)))
    return {"golden": golden.GOLDEN_WAV, "tiled": tiled}


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    pcm = golden_samples()
    path = tmp_path_factory.mktemp("golden") / "golden.wav"
    path.write_bytes(wav_bytes(pcm))
    return path, jax_golden(path)


def test_golden_wav_is_current(regenerated):
    path, _ = regenerated
    assert golden.GOLDEN_WAV.read_bytes() == path.read_bytes()
    assert golden.GOLDEN_WAV.stat().st_size <= 300_000


def test_golden_json_is_current(regenerated):
    # The stored JAX result equals a fresh JAX run by the port's own
    # criterion (exact texts/speakers/languages/emotions, 40 ms times,
    # 99.5 % ids): XLA:CPU's summation order may differ across host CPUs.
    _, fresh = regenerated
    _assert_current(golden.load_golden(), fresh)


def _assert_current(stored: dict, fresh: dict) -> None:
    mass = stored["tone_mass"]
    assert golden.result_mismatches(stored["result"], fresh["result"],
                                    tone_mass=mass) == []
    assert golden.ctc_agreement(stored["ctc_ids"], fresh["ctc_ids"]) >= \
        golden.MIN_CTC_AGREEMENT
    np.testing.assert_allclose(fresh["tone_mass"], mass,
                               atol=1e-3 * sum(mass))


def test_golden_decoders_json_is_current(regenerated):
    """golden_decoders.json equals a fresh JAX run with the release
    decoders: the result by the port's criterion (translations and the
    summary exactly), every decode's tokens exactly, its gaps within
    1e-2."""
    path, _ = regenerated
    stored, fresh = golden.load_golden_decoders(), jax_golden_decoders(path)
    _assert_current(stored, fresh)
    assert ([t["span"] for t in fresh["translations"]]
            == [t["span"] for t in stored["translations"]])
    for want, got in zip(stored["translations"] + [stored["summary"]],
                         fresh["translations"] + [fresh["summary"]]):
        assert got["tokens"] == want["tokens"]
        assert abs(got["min_gap"] - want["min_gap"]) <= 1e-2


def test_golden_decoders_have_margin():
    """The decoders' fixture is a fair exact check: every decode's free
    tokens lead their runner-up by MIN_TOKEN_GAP, the tone is not a tie,
    and the result carries translations and a generated summary."""
    stored = golden.load_golden_decoders()
    decodes = stored["translations"] + [stored["summary"]]
    assert len(stored["translations"]) >= 2
    assert all(d["min_gap"] >= golden.MIN_TOKEN_GAP for d in decodes)
    m = sorted(stored["tone_mass"])
    assert m[-1] - m[-2] >= golden.TONE_TIE * sum(m)
    result = stored["result"]
    assert all(s["translation"] for s in result["segments"]
               if s["language_code"] != "en")
    assert not result["summary"].startswith("Audio of ")


def test_golden_has_content():
    stored = golden.load_golden()
    segs = stored["result"]["segments"]
    assert len(segs) >= 2
    assert len({s["speaker"] for s in segs}) >= 2
    assert all(s["text"] for s in segs)


def test_port_cpu_matches_golden():
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    eng = TranscriptionEngine(config=cfg, device="cpu",
                              xvector_path=str(RELEASE / "xvector.npz"))
    res = eng.transcribe(golden.GOLDEN_WAV)
    stored = golden.load_golden()
    assert golden.result_mismatches(stored["result"], res.to_dict(),
                                    tone_mass=stored["tone_mass"]) == []
    agree = golden.ctc_agreement(stored["ctc_ids"],
                                 greedy_ids(eng, golden.GOLDEN_WAV))
    assert agree >= golden.MIN_CTC_AGREEMENT


def test_tone_tie_rule():
    """A summary may name the reference's second tone only where the
    reference's top two masses are within TONE_TIE of the total; anything
    else in the summary must still match."""
    base = "Audio of 7.6 seconds with 2 speakers. Overall tone: {}."
    want = {"summary": base.format("neutral"), "detected_languages": [],
            "segments": []}
    got = dict(want, summary=base.format("angry"))
    tied = [0.1, 0.1, 3.50, 3.51]       # margin 0.14 % of the total
    clear = [0.1, 0.1, 3.40, 3.51]      # margin 1.5 %
    assert golden.result_mismatches(want, got) != []
    assert golden.result_mismatches(want, got, tone_mass=tied) == []
    assert golden.result_mismatches(want, got, tone_mass=clear) != []
    sad = dict(want, summary=base.format("sad"))
    assert golden.result_mismatches(want, sad, tone_mass=tied) != []
    other = dict(want, summary=base.format("angry").replace("2 sp", "3 sp"))
    assert golden.result_mismatches(want, other, tone_mass=tied) != []
    # the stored fixtures carry their masses; only w8's tone is a tie
    ties = {}
    for q in (False, "a8", "w8"):
        stored = golden.load_golden(q)
        m = sorted(stored["tone_mass"])
        ties[q] = m[-1] - m[-2] < golden.TONE_TIE * sum(m)
        top = golden.EMOTIONS[int(np.argmax(stored["tone_mass"]))]
        assert stored["result"]["summary"].endswith(f"Overall tone: {top}.")
    assert ties == {False: False, "a8": False, "w8": True}


# ---------------------------------------------------------------------------
# Int8 serving: the JAX engine's quantize="a8" / "w8" results
# ---------------------------------------------------------------------------

def _release_port_config():
    from omnilingual_asr_torch.config import PipelineConfig

    return PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))


@pytest.mark.parametrize("quantize", ["a8", "w8"])
def test_golden_quant_json_is_current(regenerated, quantize):
    """golden_<mode>.json equals a fresh JAX run in that mode (kernels in
    interpret mode) by the port's criterion."""
    path, _ = regenerated
    _assert_current(golden.load_golden(quantize), jax_golden(path, quantize))


def test_golden_quant_results_are_their_own():
    """The a8 fixture is not the unquantized one: the mode changes the
    greedy ids, so the quantized checks test something."""
    plain, a8 = golden.load_golden(), golden.load_golden("a8")
    assert plain["ctc_ids"] != a8["ctc_ids"]
    assert golden.ctc_agreement(plain["ctc_ids"], a8["ctc_ids"]) > 0.9


@pytest.mark.parametrize("quantize", ["a8", "w8"])
def test_port_cpu_quant_matches_golden(quantize):
    from omnilingual_asr_torch.engine import TranscriptionEngine

    eng = TranscriptionEngine(config=_release_port_config(), device="cpu",
                              xvector_path=str(RELEASE / "xvector.npz"),
                              quantize=quantize)
    res = eng.transcribe(golden.GOLDEN_WAV)
    stored = golden.load_golden(quantize)
    assert golden.result_mismatches(stored["result"], res.to_dict(),
                                    tone_mass=stored["tone_mass"]) == []
    agree = golden.ctc_agreement(stored["ctc_ids"],
                                 greedy_ids(eng, golden.GOLDEN_WAV))
    assert agree >= golden.MIN_CTC_AGREEMENT


def test_port_facade_matches_public_facade():
    """The port's GeminiDiarizedTranscriptionPipeline against
    omnilingual_asr's on the golden file, both with quantize="a8" and word
    timestamps: the same segments by the golden criterion, the same summary
    and languages, and the same progress steps."""
    import jax
    from omnilingual_asr import GeminiDiarizedTranscriptionPipeline as Public
    from omnilingual_asr_tpu.config import MeshConfig
    from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    import omnilingual_asr_torch
    from omnilingual_asr_torch.diarization.pipeline import (
        DiarizedTranscriptSegment, WordTimestamp)

    Port = omnilingual_asr_torch.GeminiDiarizedTranscriptionPipeline
    assert Port.__module__ == "omnilingual_asr_torch.diarization.pipeline"
    jcfg = JaxConfig.from_json((RELEASE / "config.json").read_text(),
                               checkpoint_path=str(RELEASE / "asr.npz"))
    xv = str(RELEASE / "xvector.npz")
    public = Public(api_key="ignored", config=jcfg, xvector_path=xv,
                    quantize="a8", batch_windows_per_device=4,
                    mesh=build_mesh(MeshConfig(data=1),
                                    devices=jax.devices()[:1]))
    port = Port(api_key="ignored", config=_release_port_config(),
                xvector_path=xv, quantize="a8", device="cpu")
    out = {}
    for name, pipe in (("public", public), ("port", port)):
        steps = []
        segs = pipe.transcribe(str(golden.GOLDEN_WAV), word_timestamps=True,
                               progress_callback=lambda s, i: steps.append(
                                   (s, i)))
        out[name] = (segs, steps, pipe.summary, pipe.detected_languages)
    (want, want_steps, want_sum, want_langs) = out["public"]
    (got, got_steps, got_sum, got_langs) = out["port"]
    assert got_steps == want_steps == [("uploading", 0), ("transcribing", 1),
                                       ("processing", 2), ("done", 3)]
    assert all(isinstance(s, DiarizedTranscriptSegment) for s in got)
    assert all(isinstance(w, WordTimestamp) for s in got for w in s.words)
    assert ([f.name for f in dataclasses.fields(got[0])]
            == [f.name for f in dataclasses.fields(want[0])])
    as_result = lambda segs, summary, langs: {  # noqa: E731
        "summary": summary, "detected_languages": langs,
        "segments": [dataclasses.asdict(s) for s in segs]}
    assert golden.result_mismatches(
        as_result(want, want_sum, want_langs),
        as_result(got, got_sum, got_langs)) == []   # a8: no tone tie
    assert len(got) == len(golden.load_golden("a8")["result"]["segments"])


# ---------------------------------------------------------------------------
# The d512 x 12 seed in crop mode, greedy and with the beam search
# ---------------------------------------------------------------------------

def test_config_for_checkpoint_equals_jax(tmp_path):
    """The port's ``config_for_checkpoint`` reads the ``config.json`` beside
    the checkpoint (or in it) as the JAX package's does, and falls back to
    the code-default dims."""
    from omnilingual_asr_torch.config import config_for_checkpoint
    from omnilingual_asr_tpu.config import \
        config_for_checkpoint as jax_config_for_checkpoint

    for ckpt in (D512, D512.parent, tmp_path / "none.npz"):
        got = config_for_checkpoint(str(ckpt))
        want = jax_config_for_checkpoint(str(ckpt))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.checkpoint_path == str(ckpt)
    assert config_for_checkpoint(str(D512)).encoder.d_model == 512


def test_golden_d512_has_margin():
    """``golden_d512_crop.json`` is the d512 seed's crop-mode result with
    enough stable beam decodes and crop re-embedding in use."""
    stored = golden.load_golden_d512()
    assert stored["checkpoint"] == str(D512.relative_to(REPO))
    assert stored["beam"] == D512_BEAM and stored["speaker_mode"] == "crop"
    check_d512_margins(stored)
    tiled = stored["files"]["tiled"]["greedy"]["result"]
    assert len({s["speaker"] for s in tiled["segments"]}) >= 2


@pytest.fixture(scope="module")
def d512_port(tmp_path_factory):
    """The fixture's files and the port's d512 crop engines on the CPU,
    greedy and with the beam search."""
    from omnilingual_asr_torch.config import config_for_checkpoint
    from omnilingual_asr_torch.engine import TranscriptionEngine

    paths = d512_paths(tmp_path_factory.mktemp("d512"))
    base = config_for_checkpoint(str(D512))
    beam = base.replace(decode=dataclasses.replace(base.decode, **D512_BEAM))
    engines = {mode: TranscriptionEngine(config=cfg, device="cpu",
                                         speaker_mode="crop")
               for mode, cfg in (("greedy", base), ("beam", beam))}
    return paths, engines


def test_port_beam_search_on_jax_feed_equals_d512(d512_port):
    """Given the JAX engine's top-K feed (``golden_d512_crop_topk.npz``),
    the port's beam search with the synth lexicon returns the JAX text of
    every decode, stable or not."""
    _, engines = d512_port
    eng = engines["beam"]
    feed = np.load(golden.GOLDEN_D512_FEED)
    n = 0
    for name, f in golden.load_golden_d512()["files"].items():
        for d in f["beam"]["decodes"]:
            topk = (feed[f"{name}/{d['window']}/lp"],
                    feed[f"{name}/{d['window']}/ids"])
            assert eng._beam_text(topk, d["f0"], d["f1"]) == d["text"]
            n += 1
    assert n >= 10


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_port_cpu_matches_golden_d512(d512_port, mode):
    """The port's d512 crop engine on the CPU, on the golden and the tiled
    file, held to the fixture (``testing.d512_mismatches``); the tiled
    request re-embeds its segments; with the beam search, its top-K feed
    is held to the JAX engine's (``testing.d512_feed_mismatches``) and
    the stable decodes' texts are exact."""
    paths, engines = d512_port
    eng = engines[mode]
    results, ids, feeds, crops = {}, {}, {}, []
    crop, extract = eng._segment_crop_embeds, eng._extract_windows

    def rec_extract(outs, *parts):     # the request's own ids and feed
        ids[name].extend(o["ctc_ids"].astype(int).tolist() for o in outs)
        feeds[name].extend(o["ctc_topk"] for o in outs
                           if o["ctc_topk"] is not None)
        return extract(outs, *parts)

    eng._segment_crop_embeds = lambda *a: crops.append(1) or crop(*a)
    eng._extract_windows = rec_extract
    try:
        for name, path in paths.items():
            ids[name], feeds[name] = [], []
            results[name] = eng.transcribe(path).to_dict()
    finally:
        del eng._segment_crop_embeds, eng._extract_windows
    assert crops == [1]
    assert golden.d512_mismatches(mode, results, ids) == []
    if mode == "beam":
        assert golden.d512_feed_mismatches(feeds) == []
        texts = golden.d512_beam_texts(results)
        n_stable = sum(d["stable"] for f in golden.load_golden_d512()[
            "files"].values() for d in f["beam"]["decodes"])
        assert texts["stable"] == f"{n_stable} of {n_stable}"


@pytest.mark.parametrize("mode", sorted(RELEASE_WIRE_MODES))
def test_port_cpu_release_wire_matches_golden(mode):
    """The release engine with μ-law ingress, and with the int8 speaker
    wire at stride 2, on the golden file: held to the JAX engine's result
    in the same mode (``golden_d512_crop.json``'s ``release_wire``)."""
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine

    kwargs, decode = RELEASE_WIRE_MODES[mode]
    eng = TranscriptionEngine(config=_release_wire_config(PipelineConfig,
                                                          decode),
                              xvector_path=str(RELEASE / "xvector.npz"),
                              device="cpu", **kwargs)
    stored = golden.load_golden_d512()["release_wire"][mode]
    res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
    assert golden.result_mismatches(stored["result"], res,
                                    tone_mass=stored["tone_mass"]) == []
    assert golden.ctc_agreement(stored["ctc_ids"],
                                greedy_ids(eng, golden.GOLDEN_WAV)) >= \
        golden.MIN_CTC_AGREEMENT


FIXTURES = ("plain", "a8", "w8", "decoders", "d512_crop")


def main(argv=None) -> None:
    import tempfile
    import time

    os.environ.setdefault("OMNIASR_RELEASE_DIR", "")
    names = list(argv if argv is not None else sys.argv[1:]) or FIXTURES
    unknown = set(names) - set(FIXTURES)
    if unknown:
        raise SystemExit(f"unknown fixtures {sorted(unknown)}; choose from "
                         f"{FIXTURES}")
    pcm = golden_samples()
    golden.TESTDATA.mkdir(parents=True, exist_ok=True)
    golden.GOLDEN_WAV.write_bytes(wav_bytes(pcm))
    print(f"wrote {golden.GOLDEN_WAV} ({len(pcm) / 16000:.2f} s)")
    for name in names:
        t0 = time.perf_counter()
        if name == "decoders":
            data = jax_golden_decoders(golden.GOLDEN_WAV)
            out = golden.GOLDEN_DECODERS_JSON
        elif name == "d512_crop":
            with tempfile.TemporaryDirectory() as d:
                data, feed = jax_golden_d512(d512_paths(Path(d)))
            data["release_wire"] = jax_golden_release_wire(golden.GOLDEN_WAV)
            check_d512_margins(data)
            np.savez_compressed(golden.GOLDEN_D512_FEED, **feed)
            print(f"wrote {golden.GOLDEN_D512_FEED}")
            out = golden.GOLDEN_D512_JSON
        else:
            quantize = False if name == "plain" else name
            data = jax_golden(golden.GOLDEN_WAV, quantize)
            out = golden.golden_json(quantize)
        out.write_text(json.dumps(data, ensure_ascii=False,
                                  separators=(",", ":")) + "\n")
        print(f"wrote {out} in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
