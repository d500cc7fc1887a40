"""Wire-shape helpers: engine results -> history-entry dicts.

Matches the segment-dict shape the reference server builds via hasattr
probing (reference workflows/wav2elan_web/app.py:231-254): words always
present as a list; language/language_code/languages/emotion/translation only
when truthy.

The PyTorch port's own copy of ``omnilingual_asr_tpu/serving/schema.py``
(the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..types import TranscriptionResult


def segments_to_wire(result: TranscriptionResult) -> List[Dict[str, Any]]:
    out = []
    for seg in result.segments:
        d: Dict[str, Any] = {
            "start": seg.start,
            "end": seg.end,
            "speaker": seg.speaker,
            "text": seg.text,
            "words": [
                {"word": w.word, "start": w.start, "end": w.end}
                for w in (seg.words or [])
            ],
        }
        if seg.language:
            d["language"] = seg.language
        if seg.language_code:
            d["language_code"] = seg.language_code
        if seg.languages:
            d["languages"] = seg.languages
        if seg.emotion:
            d["emotion"] = seg.emotion
        if seg.translation:
            d["translation"] = seg.translation
        out.append(d)
    return out


def result_to_entry(result: TranscriptionResult, *, file_name: str,
                    audio_url: str) -> Dict[str, Any]:
    """Build the history-entry payload (reference app.py:160-171, 256-266).

    Built from the returned result — NOT from shared pipeline properties —
    which fixes the reference's concurrency race where parallel batch files
    overwrite the singleton's summary/detected_languages (SURVEY §5 race row;
    reference app.py:53, 373-376)."""
    entry: Dict[str, Any] = {
        "audio_url": audio_url,
        "file_name": file_name,
        "segments": segments_to_wire(result),
    }
    if result.summary:
        entry["summary"] = result.summary
    if result.detected_languages:
        entry["detected_languages"] = result.detected_languages
    return entry
