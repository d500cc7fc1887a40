"""PyTorch port: the transcript exporters (EAF, TextGrid, SRT, TXT, JSON)
against the JAX package's, byte for byte.

Each format is rendered by both packages' ``export_transcript`` from the
same history entries: the exporter tests' three-segment entry, the server's
demo entry and an entry built from ``golden_decoders.json`` (the JAX
engine's result with translations and the neural summary). EAF runs with a
fixed DATE, with and without word tiers. The port's output also equals the
frozen ``tests/goldens/demo.*``.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from omnilingual_asr_torch import exporters as port_exporters
from omnilingual_asr_torch import testing as port_testing
from omnilingual_asr_torch import types as port_types
from omnilingual_asr_torch.serving import schema as port_schema
from omnilingual_asr_tpu import exporters as jax_exporters
from omnilingual_asr_tpu import testing as jax_testing
from omnilingual_asr_tpu import types as jax_types
from omnilingual_asr_tpu.serving import schema as jax_schema

GOLDENS = Path(__file__).resolve().parent / "goldens"
DATE = "2026-01-01T00:00:00.000Z"
FORMATS = ("eaf", "textgrid", "srt", "txt", "json")

# The exporter tests' entry (tests/test_exporters.py), which the frozen
# tests/goldens/demo.* files render.
DATA = {
    "file_name": "demo.wav",
    "audio_url": "/api/audio/1",
    "summary": "Two speakers, neutral tone.",
    "detected_languages": [
        {"language": "English", "code": "en"},
        {"language": "Lisu", "code": "lis"},
    ],
    "segments": [
        {"start": 0.352, "end": 2.5, "speaker": "Speaker 1",
         "text": "Hello & <world>", "language": "English",
         "language_code": "en", "languages": [{"name": "English", "code": "en"}],
         "emotion": "neutral", "translation": None, "words": None},
        {"start": 2.6, "end": 4.0, "speaker": "Speaker 2",
         "text": "ꓟꓳ ꓠꓬ", "language": "Lisu", "language_code": "lis",
         "languages": [{"name": "Lisu", "code": "lis"}],
         "emotion": "happy", "translation": "Good morning", "words": None},
        {"start": 4.5, "end": 6.0, "speaker": "Speaker 1",
         "text": "Bye \"friend\"", "language": "English",
         "language_code": "en", "languages": [{"name": "English", "code": "en"}],
         "emotion": "neutral", "translation": "null", "words": None},
    ],
}
GOLDEN_FILES = {"eaf": "demo.eaf", "textgrid": "demo.TextGrid",
                "srt": "demo.srt", "txt": "demo.txt", "json": "demo.json"}


def _result(types, d: dict):
    """A ``TranscriptionResult`` of ``types`` from its ``to_dict`` form."""
    segs = [types.TranscriptSegment(**{
        **s, "words": [types.WordTimestamp(**w) for w in s["words"] or []]})
        for s in d["segments"]]
    return types.TranscriptionResult(
        summary=d["summary"], segments=segs,
        detected_languages=d["detected_languages"])


def _entries():
    """name -> (port entry, JAX entry), each built by its own package."""
    golden = port_testing.load_golden_decoders()["result"]
    out = {"data": (DATA, DATA)}
    out["demo"] = tuple(
        schema.result_to_entry(testing.demo_result(),
                               file_name="demo-codeswitching.wav",
                               audio_url="")
        for schema, testing in ((port_schema, port_testing),
                                (jax_schema, jax_testing)))
    out["golden_decoders"] = tuple(
        schema.result_to_entry(_result(types, golden),
                               file_name="golden.wav",
                               audio_url="/uploads/golden.wav")
        for schema, types in ((port_schema, port_types),
                              (jax_schema, jax_types)))
    return out


ENTRIES = _entries()


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entries_equal_jax(name):
    """The port's schema builds the JAX schema's entry from the same
    result."""
    port, ref = ENTRIES[name]
    assert port == ref
    assert port["segments"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_export_equals_jax(name, fmt):
    port, ref = ENTRIES[name]
    kw = {"date": DATE} if fmt == "eaf" else {}
    got = port_exporters.export_transcript(port, fmt, **kw)
    want = jax_exporters.export_transcript(ref, fmt, **kw)
    assert got.encode("utf-8") == want.encode("utf-8")


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_eaf_word_tiers_equal_jax(name):
    """EAF with the word tiers (the server's ``?words=1``)."""
    port, ref = ENTRIES[name]
    got = port_exporters.export_transcript(port, "eaf", date=DATE,
                                           include_words=True)
    want = jax_exporters.export_transcript(ref, "eaf", date=DATE,
                                           include_words=True)
    assert got == want
    has_words = any(s.get("words") for s in port["segments"])
    assert ("_words" in got) == has_words


@pytest.mark.parametrize("fmt", FORMATS)
def test_export_equals_frozen_goldens(fmt):
    kw = {"date": DATE} if fmt == "eaf" else {}
    got = port_exporters.export_transcript(DATA, fmt, **kw)
    assert got == (GOLDENS / GOLDEN_FILES[fmt]).read_text(encoding="utf-8")


def test_eaf_default_date_is_now_in_both():
    """Without a DATE both stamp the current UTC time in the same format."""
    import re

    pat = r'DATE="(\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d\.\d{3}Z)"'
    got = re.search(pat, port_exporters.build_eaf(DATA))
    want = re.search(pat, jax_exporters.build_eaf(DATA))
    assert got and want


def test_unknown_format_raises_as_jax():
    with pytest.raises(ValueError) as port:
        port_exporters.export_transcript(DATA, "nope")
    with pytest.raises(ValueError) as ref:
        jax_exporters.export_transcript(DATA, "nope")
    assert str(port.value) == str(ref.value)


def test_json_roundtrip():
    assert json.loads(port_exporters.build_json(DATA)) == DATA
    assert port_exporters.EXPORTERS.keys() == jax_exporters.EXPORTERS.keys()
