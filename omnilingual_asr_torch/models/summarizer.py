"""Summary text for a transcription.

The PyTorch port's copy of ``template_summary`` from
``omnilingual_asr_tpu/models/summarizer.py``: the deterministic metadata
summary (duration, speaker count, segment count, languages, dominant tone)
that the engine emits when no trained summarizer is loaded. The neural
``SummaryDecoder`` is a later slice of the port.
"""

from __future__ import annotations

from typing import List


def template_summary(*, duration_s: float, n_speakers: int, n_segments: int,
                     language_names: List[str], top_emotion: str) -> str:
    """Deterministic summary with the schema-required facts."""
    langs = ", ".join(language_names[:4])
    return (
        f"Audio of {duration_s:.1f} seconds with {n_speakers} "
        f"speaker{'s' if n_speakers != 1 else ''} across "
        f"{n_segments} segments"
        + (f" in {langs}" if langs else "")
        + f". Overall tone: {top_emotion}."
    )
