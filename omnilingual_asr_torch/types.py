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

# Progress step contract (reference diarization/pipeline.py:89-90):
# callback(step_name, step_index) with steps uploading(0) / transcribing(1)
# / processing(2) / done(3).
PROGRESS_STEPS = ("uploading", "transcribing", "processing", "done")


def parse_timestamp(timestamp_str: str) -> float:
    """Parse ``MM:SS`` / ``HH:MM:SS`` / raw-seconds timestamps to seconds.

    Behavior-compatible with reference gemini_pipeline.py:73-103: empty or
    unparseable input returns 0.0; two fields are minutes:seconds, three are
    hours:minutes:seconds, otherwise the string is parsed as raw seconds.
    """
    if not timestamp_str:
        return 0.0
    parts = str(timestamp_str).strip().split(":")
    try:
        if len(parts) == 2:
            return int(parts[0]) * 60.0 + float(parts[1])
        if len(parts) == 3:
            return int(parts[0]) * 3600.0 + int(parts[1]) * 60.0 + float(parts[2])
        return float(timestamp_str)
    except ValueError:
        return 0.0


def format_timestamp(seconds: float) -> str:
    """Format seconds as MM:SS (or H:MM:SS past an hour), the inverse of
    :func:`parse_timestamp` for the common cases."""
    seconds = max(0.0, float(seconds))
    total = int(round(seconds))
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}:{m:02d}:{s:02d}"
    return f"{m:02d}:{s:02d}"
