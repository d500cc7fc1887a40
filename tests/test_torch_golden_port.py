"""PyTorch port: its CPU results held to the golden fixtures
(``omnilingual_asr_torch/testdata``: the JAX engine's results on the
golden file, plain, at "a8", "w8" and f32, with the release decoders, in
sequence mode, and the release's wire modes) by the criterion of
``omnilingual_asr_torch.testing``; the fixtures' own margins; the port's
facade against the public one. ``tests/test_torch_golden.py`` regenerates
the fixtures and checks that they are current."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.testing import greedy_ids, sequence_ids
from test_torch_golden import (D512, F32_TILED_SECONDS, RELEASE,
                               RELEASE_WIRE_MODES, _release_port_config,
                               _release_wire_config, write_tiled)

torch.set_num_threads(2)


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


def test_port_cpu_matches_golden_f32(tmp_path):
    """The port's CPU engine with the f32 encoder against the JAX engine's
    f32 results: on the golden file the result by
    ``testing.result_mismatches`` and the greedy ids on
    MIN_CTC_AGREEMENT; on its 120 s tiling the ids on MIN_CTC_AGREEMENT.
    The tiling's result is not held exactly: one of its 3000 frames is a
    tie at f32 (top two CTC logits 1.1e-5 apart in the port, where the
    bf16 model's are 1.2e-2 apart), whose flip changes one segment's
    text."""
    from omnilingual_asr_torch.engine import TranscriptionEngine

    cfg = _release_port_config()
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  dtype="float32"))
    eng = TranscriptionEngine(config=cfg, device="cpu",
                              xvector_path=str(RELEASE / "xvector.npz"))
    stored = golden.load_golden_f32()
    res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
    assert golden.result_mismatches(stored["result"], res,
                                    tone_mass=stored["tone_mass"]) == []
    tiled = write_tiled(tmp_path / "golden.wav", F32_TILED_SECONDS)
    for want, path in ((stored, golden.GOLDEN_WAV),
                       (stored["tiled"], tiled)):
        assert golden.ctc_agreement(want["ctc_ids"],
                                    greedy_ids(eng, path)) >= \
            golden.MIN_CTC_AGREEMENT


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
