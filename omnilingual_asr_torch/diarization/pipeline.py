"""Diarized transcription pipeline on the PyTorch engine — the public API.

The port's own copy of ``omnilingual_asr/diarization/pipeline.py``: the
same class name, constructor keywords, ``transcribe()`` signature,
progress-step contract (uploading 0 / transcribing 1 / processing 2 /
done 3) and ``DiarizedTranscriptSegment`` field set. The backend is the
port's ``TranscriptionEngine``, which runs on the CUDA card unless
``device="cpu"`` is passed; every other keyword (``config``, ``quantize``,
``xvector_path``, ...) reaches the engine unchanged. An API key is accepted
for compatibility and ignored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass(frozen=True)
class WordTimestamp:
    """Word-level timestamp information."""

    word: str
    start: float
    end: float


@dataclass(frozen=True)
class DiarizedTranscriptSegment:
    """A transcribed segment with speaker and timing information.

    ``languages`` carries the code-switching list ``[{"name": ...,
    "code": ...}, ...]`` with the primary language first.
    """

    start: float
    end: float
    speaker: str
    text: str
    words: list[WordTimestamp] | None = None
    language: str | None = None
    language_code: str | None = None
    languages: list[dict] | None = None
    emotion: str | None = None
    translation: str | None = None


class GeminiDiarizedTranscriptionPipeline:
    """Transcription with diarization, language detection and emotion
    analysis, running locally on one CUDA card.

    The class keeps the public facade's name so that user code runs
    unchanged against the port.
    """

    def __init__(
        self,
        *,
        api_key: Optional[str] = None,
        model: str = "local-gpu",
        **engine_kwargs,
    ) -> None:
        """``api_key`` is accepted for compatibility and ignored; extra
        keyword arguments reach the engine (config, device, quantize, ...).
        """
        from ..engine import TranscriptionEngine

        self.gemini = TranscriptionEngine(api_key=api_key, model=model,
                                          **engine_kwargs)
        self._summary: Optional[str] = None
        self._detected_languages: Optional[List[dict]] = None

    @property
    def summary(self) -> Optional[str]:
        """Summary from the last transcription."""
        return self._summary

    @property
    def detected_languages(self) -> Optional[List[dict]]:
        """Languages detected in the last transcription."""
        return self._detected_languages

    def transcribe(
        self,
        audio_path: str,
        *,
        word_timestamps: bool = False,
        progress_callback: Optional[Callable[[str, int], None]] = None,
        language: Optional[str] = None,
        speaker_count: Optional[str] = None,
        **kwargs,
    ) -> List[DiarizedTranscriptSegment]:
        """Transcribe audio with speaker diarization.

        ``word_timestamps=True`` fills ``segment.words`` from the CTC
        alignment; otherwise it stays None.
        """
        result = self.gemini.transcribe_with_retry(
            audio_path,
            progress_callback=progress_callback,
            language=language,
            speaker_count=speaker_count,
        )

        self._summary = result.summary
        self._detected_languages = result.detected_languages

        segments: List[DiarizedTranscriptSegment] = []
        for seg in result.segments:
            words = None
            if word_timestamps and seg.words:
                words = [WordTimestamp(word=w.word, start=w.start, end=w.end)
                         for w in seg.words]
            segments.append(DiarizedTranscriptSegment(
                start=seg.start,
                end=seg.end,
                speaker=seg.speaker,
                text=seg.text,
                words=words,
                language=seg.language,
                language_code=seg.language_code,
                languages=seg.languages,
                emotion=seg.emotion,
                translation=seg.translation,
            ))
        return segments
