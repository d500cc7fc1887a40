"""Golden fixture of the PyTorch port: the JAX engine's result on 7.6 s of
synthetic speech, stored in ``omnilingual_asr_torch/testdata``.

The tests regenerate the audio and the JAX result on the CPU and assert that
the committed files are current, then hold the port's CPU result to them by
the criterion of ``omnilingual_asr_torch.testing``. ``chip_smoke.py`` holds
the card's result to the same JSON.

The int8 fixtures (``golden_a8.json``, ``golden_w8.json``) are the JAX
engine's results with ``quantize="a8"`` and ``"w8"``; the port's engines in
those modes, and its facade, are held to them the same way.

Regenerate the files with ``JAX_PLATFORMS=cpu OMNIASR_RELEASE_DIR=
python tests/test_torch_golden.py``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from omnilingual_asr_torch import testing as golden  # noqa: E402

torch.set_num_threads(2)

RELEASE = REPO / "checkpoints" / "release"
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


def jax_engine(quantize=False):
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
        batch_windows_per_device=4, quantize=quantize)


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


def main() -> None:
    os.environ.setdefault("OMNIASR_RELEASE_DIR", "")
    pcm = golden_samples()
    golden.TESTDATA.mkdir(parents=True, exist_ok=True)
    golden.GOLDEN_WAV.write_bytes(wav_bytes(pcm))
    print(f"wrote {golden.GOLDEN_WAV} ({len(pcm) / 16000:.2f} s)")
    for quantize in (False, "a8", "w8"):
        data = jax_golden(golden.GOLDEN_WAV, quantize)
        out = golden.golden_json(quantize)
        out.write_text(json.dumps(data, ensure_ascii=False,
                                  separators=(",", ":")) + "\n")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
