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

``golden_sequence.json`` is the JAX engine's result in sequence mode
(``long_mode="sequence"``, one device) on the golden file, with its greedy
ids over the file's frames and its tone mass; the port's CPU engine in
sequence mode, on one shard and on two, is held to it, and
``chip_smoke.py`` holds the card's to it.

``golden_evals.json`` (with ``golden_evals_ids.npz``) holds the JAX
package's evaluation drivers with the release weights: ``eval_synth``'s 96
files at 10 s windows, ``eval_heads``' 64 files and 8 conversations with
both decoders, ``eval_diar``'s 16 conversations and the engine on
``eval_long``'s 420 s file (``omnilingual_asr_torch/testing.py`` says what
each holds). Tier-1 regenerates its first 4 synthetic files, first
conversation and the long file, and ``tests/test_torch_eval.py`` holds
the port's drivers to that subset.

Regenerate the files with ``JAX_PLATFORMS=cpu OMNIASR_RELEASE_DIR=
python tests/test_torch_golden.py`` (or name some of ``plain a8 w8
decoders sequence d512_crop evals`` to regenerate only those; ``evals`` takes
~21 min on a CPU, almost all of it eval_heads with both decoders).
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


def jax_engine(quantize=False, engine_cls=None, **kwargs):
    import jax
    from omnilingual_asr_tpu.config import MeshConfig, PipelineConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh

    TranscriptionEngine = engine_cls or TranscriptionEngine

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    kwargs.setdefault("batch_windows_per_device", 4)
    return TranscriptionEngine(
        config=cfg, xvector_path=str(RELEASE / "xvector.npz"),
        mesh=build_mesh(MeshConfig(data=1), devices=jax.devices()[:1]),
        quantize=quantize, **kwargs)


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


def sequence_ids(engine, path: Path):
    """Sequence mode's greedy CTC ids over the file's frames, as one list
    in a list (either engine)."""
    outs = engine._forward_sequence(engine._load_audio(path))
    return [np.asarray(outs[0]["ctc_ids"]).astype(int).tolist()]


def jax_golden_sequence(path: Path) -> dict:
    eng = jax_engine(long_mode="sequence", batch_windows_per_device=1)
    res = eng.transcribe(path)
    return {"result": dataclasses.asdict(res),
            "ctc_ids": sequence_ids(eng, path),
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


def test_golden_sequence_json_is_current(regenerated):
    """golden_sequence.json equals a fresh JAX run in sequence mode by the
    port's criterion."""
    path, _ = regenerated
    _assert_current(golden.load_golden_sequence(),
                    jax_golden_sequence(path))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_port_cpu_sequence_matches_golden(n_shards):
    """The port's CPU engine in sequence mode (the x-vector loaded, so the
    speakers come from crop re-embedding) on one shard and on two, against
    the JAX engine's sequence-mode result."""
    from omnilingual_asr_torch.config import MeshConfig, PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.parallel.mesh import build_mesh

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    eng = TranscriptionEngine(
        config=cfg, xvector_path=str(RELEASE / "xvector.npz"),
        long_mode="sequence",
        mesh=build_mesh(MeshConfig(data=n_shards),
                        [torch.device("cpu")] * n_shards))
    res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
    stored = golden.load_golden_sequence()
    assert golden.result_mismatches(stored["result"], res,
                                    tone_mass=stored["tone_mass"]) == []
    assert golden.ctc_agreement(stored["ctc_ids"],
                                sequence_ids(eng, golden.GOLDEN_WAV)) >= \
        golden.MIN_CTC_AGREEMENT


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


# ---------------------------------------------------------------------------
# golden_evals.json: the JAX package's evaluation drivers, release weights
# ---------------------------------------------------------------------------

#: The evals fixture: eval_synth's files at its default 10 s windows,
#: eval_heads' files and conversations, eval_diar's conversations (its
#: default seed) and eval_long's batch on a file past the chunking threshold
#: (360 s), so the streamed-WAV path is taken.
EVALS = {"synth_n": 96, "window_seconds": 10.0, "heads_n": 64,
         "diar_n": 16, "diar_seed": 123, "long_seconds": 420.0,
         "long_batch_windows": 8}
#: The subset that tier-1 regenerates and holds the port to.
EVALS_SUBSET = {"synth_n": 4, "diar_n": 1}


class _Recorded:
    """A JAX engine whose ``transcribe`` keeps (file name, result) of each
    call in ``calls``; everything else is the engine's."""

    def __init__(self, engine, calls: list):
        self._engine = engine
        self._calls = calls

    def transcribe(self, path, **kwargs):
        res = self._engine.transcribe(path, **kwargs)
        self._calls.append((Path(path).name, res))
        return res

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _run_jax_driver(module, argv, calls: list):
    """``module.main()`` (a root ``eval_*.py``) with ``argv``, its engine
    pinned to the release weights by explicit path (the tests turn release
    discovery off, so the driver's own config would be the code default;
    the release config also carries its tuned AHC cut). Returns (its JSON
    line, the engine); each transcribe call lands in ``calls``."""
    import contextlib
    import io
    from unittest import mock

    import omnilingual_asr_tpu.engine as jengine

    engines = []
    cls = jengine.TranscriptionEngine

    def pinned(config=None, **kwargs):
        engines.append(jax_engine(engine_cls=cls, **kwargs))
        return _Recorded(engines[-1], calls)

    out = io.StringIO()
    with mock.patch.object(jengine, "TranscriptionEngine", pinned), \
            mock.patch.object(sys, "argv", [module.__file__, *argv]), \
            contextlib.redirect_stdout(out):
        module.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), engines[-1]


def jax_evals_synth(folder: Path, n: int):
    """eval_synth's per-set run of the synthetic set: each file's text and
    greedy ids, and the corpus WER/CER (the gettysburg set needs the
    reference recording, which the repository does not ship)."""
    import eval_synth
    from omnilingual_asr_tpu.eval.harness import evaluate, load_manifest

    manifest = eval_synth.build_manifest(folder, n, include_real=True)
    items = [i for i in load_manifest(manifest) if i["set"] == "synth"]
    sub = folder / "manifest_synth.jsonl"
    sub.write_text("\n".join(json.dumps(i) for i in items) + "\n")
    eng = jax_engine(window_seconds=EVALS["window_seconds"])
    with golden.recorded_ctc_ids(eng) as calls:
        rep = evaluate(eng, sub)
    assert len(calls) == len(items)
    files = [{"audio": Path(i["audio"]).name, "text": i["text"],
              "hyp": row["hyp"], "n_windows": len(ids)}
             for i, row, ids in zip(items, rep.per_file, calls)]
    ids = {f"synth/{i}/{w}": np.asarray(x, np.int16)
           for i, c in enumerate(calls) for w, x in enumerate(c)}
    return {"n": n, "window_seconds": EVALS["window_seconds"],
            "files": files, "wer": rep.wer, "cer": rep.cer,
            "n_ref_words": rep.n_ref_words}, ids


def jax_evals_heads(folder: Path, n: int) -> dict:
    """eval_heads with the release translator and summarizer: its report,
    each file's majority language and emotion (the port's ``majority`` on
    the JAX segments, checked against the report), tone mass and joined
    translation, and each conversation's facts and summary."""
    import eval_heads
    from omnilingual_asr_tpu.train.synth import eval_set
    from omnilingual_asr_tpu.train.summary_train import (
        build_utterance_pool, make_conversation)

    from omnilingual_asr_torch.eval.heads import (SUMMARY_POOL, SUMMARY_SEED,
                                                  majority, summary_hits)

    calls = []
    report, eng = _run_jax_driver(
        eval_heads, ["--n", str(n), "--out", str(folder),
                     "--translator", str(RELEASE / "translator.npz"),
                     "--summarizer", str(RELEASE / "summarizer.npz")], calls)
    by_name = dict(calls)
    files, n_ok = [], [0, 0]
    for i, ex in enumerate(eval_set(n)):
        segs = by_name[f"ex_{i:04d}.wav"].segments
        if not segs:
            files.append(None)
            continue
        row = {"language": majority(segs, "language"),
               "emotion": majority(segs, "emotion"),
               "tone_mass": golden.tone_mass(eng, folder / f"ex_{i:04d}.wav")}
        if ex.translation:
            row["translation"] = " ".join(" ".join(
                (s.translation or "") for s in segs).split())
        n_ok[0] += row["language"] == ex.language
        n_ok[1] += row["emotion"] == ex.emotion
        files.append(row)
    n_files = sum(f is not None for f in files)
    assert report["lid_acc"] == round(n_ok[0] / max(1, n_files), 4)
    assert report["emotion_acc"] == round(n_ok[1] / max(1, n_files), 4)
    rng = np.random.default_rng(SUMMARY_SEED)
    pool = build_utterance_pool(rng, SUMMARY_POOL)
    conversations = []
    for i in range(report["summary_n_conversations"]):
        _, facts = make_conversation(rng, pool)
        summary = by_name[f"conv_{i:04d}.wav"].summary
        spk, tone = summary_hits(summary, facts)
        conversations.append({"facts": facts, "summary": summary,
                              "speaker_count_ok": spk, "tone_ok": tone})
    return {"n": n, "report": report, "files": files,
            "conversations": conversations}


def jax_evals_diar(n: int) -> dict:
    """eval_diar's battery at its default seed and cut: its report and
    each conversation's segments (start, end, speaker)."""
    import eval_diar

    calls = []
    report, _ = _run_jax_driver(
        eval_diar, ["--n", str(n), "--seed", str(EVALS["diar_seed"])], calls)
    segments = [[[s.start, s.end, s.speaker] for s in res.segments]
                for _, res in calls]
    der_mean = float(np.mean([d["der"] for d in report["details"]]))
    return {"n": n, "seed": EVALS["diar_seed"], "report": report,
            "der_mean": der_mean, "segments": segments}


#: 1-LSB perturbations of the long file (one sample in PERTURB_EVERY,
#: a sign each, from these seeds): the JAX engine's own spread there.
LONG_PERTURB_SEEDS = (0, 1, 2)
LONG_PERTURB_EVERY = 1000


def perturbed_wav(src: Path, dst: Path, seed: int) -> Path:
    """``src`` (16-bit WAV) with one sample in LONG_PERTURB_EVERY raised or
    lowered by one LSB."""
    with wave.open(str(src), "rb") as w:
        params = w.getparams()
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2").copy()
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), len(x) // LONG_PERTURB_EVERY)
    x[idx] += rng.choice([-1, 1], len(idx)).astype(np.int16)
    with wave.open(str(dst), "wb") as w:
        w.setparams(params)
        w.writeframes(x.tobytes())
    return dst


def jax_evals_long(folder: Path, perturb: bool = True):
    """The JAX engine at eval_long's batch on ``make_long_audio(420)``:
    the whole result, its tone mass, its windows' greedy ids (no
    ``decode`` stage: streamed), and with ``perturb`` the result's
    distance (``testing.long_agreement``) from the JAX engine's own
    results on 1-LSB perturbations of the file."""
    import eval_long

    path = eval_long.make_long_audio(EVALS["long_seconds"],
                                     path=str(folder / "long.wav"))
    eng = jax_engine(batch_windows_per_device=EVALS["long_batch_windows"])
    with golden.recorded_ctc_ids(eng) as calls:
        res = eng.transcribe(path)
    stages = dict(eng.last_trace.stages)
    assert "decode" not in stages, stages
    want = dataclasses.asdict(res)
    perturbed = [golden.long_agreement(want, dataclasses.asdict(
        eng.transcribe(perturbed_wav(Path(path), folder / "p.wav", seed))))
        for seed in (LONG_PERTURB_SEEDS if perturb else ())]
    ids = {f"long/{w}": np.asarray(x, np.int16)
           for w, x in enumerate(calls[0])}
    return {"seconds": EVALS["long_seconds"],
            "batch_windows": EVALS["long_batch_windows"],
            "result": want, "tone_mass": golden.tone_mass(eng, path),
            "n_windows": len(calls[0]),
            "n_segments": len(res.segments),
            "n_speakers": len({s.speaker for s in res.segments}),
            "perturbed": perturbed}, ids


def jax_golden_evals(folder: Path, synth_n: int = EVALS["synth_n"],
                     heads_n: Optional[int] = EVALS["heads_n"],
                     diar_n: int = EVALS["diar_n"], perturb: bool = True):
    """(fixture, greedy ids) from the JAX drivers; ``heads_n`` None skips
    the heads run, ``perturb`` False the long file's perturbed runs."""
    synth, ids = jax_evals_synth(folder / "synth", synth_n)
    data = {"synth": synth}
    if heads_n:
        data["heads"] = jax_evals_heads(folder / "heads", heads_n)
    data["diar"] = jax_evals_diar(diar_n)
    (folder / "long").mkdir()
    data["long"], long_ids = jax_evals_long(folder / "long", perturb)
    return data, {**ids, **long_ids}


@pytest.fixture(scope="module")
def evals_regenerated(tmp_path_factory):
    folder = tmp_path_factory.mktemp("evals")
    return jax_golden_evals(folder, heads_n=None, perturb=False,
                            **EVALS_SUBSET)


def test_golden_evals_is_current(evals_regenerated):
    """golden_evals.json on the subset that tier-1 regenerates (the first
    4 synthetic files, the first conversation, the 420 s file) equals a
    fresh JAX run: texts and ids exactly, the conversation's speaker count,
    DER and segments, the long result by the golden criterion and its
    greedy ids exactly."""
    stored = golden.load_golden_evals()
    fresh, ids = evals_regenerated
    got = fresh["synth"]["files"]
    assert [f["hyp"] for f in got] == \
        [f["hyp"] for f in stored["synth"]["files"][:len(got)]]
    for i, f in enumerate(stored["synth"]["files"][:len(got)]):
        assert f["ctc_ids"] == [ids[f"synth/{i}/{w}"].tolist()
                                for w in range(got[i]["n_windows"])]
    assert stored["long"]["ctc_ids"] == [
        ids[f"long/{w}"].tolist() for w in range(fresh["long"]["n_windows"])]
    want_diar = stored["diar"]
    det = fresh["diar"]["report"]["details"]
    assert det == want_diar["report"]["details"][:len(det)]
    for w, g in zip(want_diar["segments"], fresh["diar"]["segments"]):
        assert [x[2] for x in g] == [x[2] for x in w]
        np.testing.assert_allclose([x[:2] for x in g], [x[:2] for x in w],
                                   atol=golden.TIME_TOL_S)
    assert golden.result_mismatches(
        stored["long"]["result"], fresh["long"]["result"],
        tone_mass=stored["long"]["tone_mass"]) == []


def test_golden_evals_have_content():
    """The fixture is the full battery: 96 synthetic files, 64 heads files
    with translations and 8 conversations, 16 conversations, a 420 s file
    of many segments; and its numbers are the drivers' own."""
    stored = golden.load_golden_evals()
    synth = stored["synth"]
    assert len(synth["files"]) == EVALS["synth_n"]
    assert all(f["n_windows"] == 1 and f["ctc_ids"][0] for f in
               synth["files"])
    heads = stored["heads"]
    assert heads["report"]["n_files"] == len(
        [f for f in heads["files"] if f is not None]) == EVALS["heads_n"]
    assert heads["report"]["summary_n_conversations"] == \
        len(heads["conversations"]) == EVALS["heads_n"] // 8
    assert sum("translation" in f for f in heads["files"]) >= 32
    diar = stored["diar"]
    assert len(diar["report"]["details"]) == len(diar["segments"]) == \
        EVALS["diar_n"]
    assert abs(diar["der_mean"] - diar["report"]["value"]) < 1e-4
    long = stored["long"]
    assert long["n_segments"] >= 50 and long["n_windows"] == 14
    assert golden.ctc_agreement(long["ctc_ids"], long["ctc_ids"]) == 1.0


def test_golden_evals_long_criterion_admits_the_reference_under_noise():
    """The long file's rule (``testing.LONG_*``) admits the JAX engine's
    own results on 1-LSB perturbations of the file, and those results are
    not the reference's: the exact criterion would not be a fair check of
    a second implementation there."""
    perturbed = golden.load_golden_evals()["long"]["perturbed"]
    assert len(perturbed) == len(LONG_PERTURB_SEEDS)
    for a in perturbed:
        assert a["der"] <= golden.LONG_MAX_DER
        assert a["cer"] <= golden.LONG_MAX_CER
        assert a["segment_match"] >= golden.LONG_MIN_SEGMENT_MATCH
        assert abs(a["n_speakers"][0] - a["n_speakers"][1]) <= 1
    assert all(a["cer"] > 0 and a["n_segments"][1] != a["n_segments"][0]
               for a in perturbed)


FIXTURES = ("plain", "a8", "w8", "decoders", "sequence", "d512_crop",
            "evals")


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
        elif name == "sequence":
            data = jax_golden_sequence(golden.GOLDEN_WAV)
            out = golden.GOLDEN_SEQUENCE_JSON
        elif name == "evals":
            with tempfile.TemporaryDirectory() as d:
                data, ids = jax_golden_evals(Path(d))
            np.savez_compressed(golden.GOLDEN_EVALS_IDS, **ids)
            print(f"wrote {golden.GOLDEN_EVALS_IDS}")
            out = golden.GOLDEN_EVALS_JSON
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
