"""Core result types for the TPU-native omnilingual ASR engine.

The PyTorch port's own copy of ``omnilingual_asr_tpu/types.py`` (the port imports nothing
of the JAX package); keep the two in step.

These mirror the engine-level result shapes of the reference
(`GeminiTranscriptSegment` / `GeminiTranscriptionResult` / `WordTimestamp`,
reference: src/omnilingual_asr/models/inference/gemini_pipeline.py:39-70) so the
public pipeline facade can stay drop-in compatible, but they are produced by
local TPU inference instead of a remote API call.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class WordTimestamp:
    """Word-level timestamp information (reference gemini_pipeline.py:39-45)."""

    word: str
    start: float
    end: float


@dataclass
class TranscriptSegment:
    """A single transcription segment.

    Field semantics match reference gemini_pipeline.py:48-61:
    - ``languages`` is a primary-first list of ``{"name": ..., "code": ...}``
      dicts used for code-switching; ``language``/``language_code`` mirror the
      primary entry.
    - ``emotion`` is one of {happy, sad, angry, neutral}.
    - ``translation`` is an English translation, or None if the segment is
      entirely English.
    """

    start: float
    end: float
    speaker: str
    text: str
    language: Optional[str] = None
    language_code: Optional[str] = None
    languages: Optional[List[dict]] = None
    emotion: Optional[str] = None
    translation: Optional[str] = None
    words: Optional[List[WordTimestamp]] = None


@dataclass
class TranscriptionResult:
    """Complete transcription result (reference gemini_pipeline.py:64-70)."""

    summary: Optional[str] = None
    segments: List[TranscriptSegment] = field(default_factory=list)
    detected_languages: Optional[List[dict]] = None

    def to_dict(self) -> dict:
        """Plain JSON-ready dict: ``dataclasses.asdict`` of the result."""
        return asdict(self)


EMOTIONS = ("happy", "sad", "angry", "neutral")
