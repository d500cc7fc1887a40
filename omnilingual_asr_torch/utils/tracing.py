"""Per-stage wall-time tracing for one transcription.

The PyTorch port's copy of ``StageTrace`` and ``log_event`` from
``omnilingual_asr_tpu/utils/tracing.py``. Stage names are the JAX
engine's: ``decode``, ``forward``, ``extract``, ``assemble`` and
``assemble.<sub-stage>``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator

logger = logging.getLogger("omniasr")


@dataclass
class StageTrace:
    """Per-run stage timings for one transcription."""

    stages: Dict[str, float] = field(default_factory=dict)
    audio_seconds: float = 0.0
    n_chips: int = 1

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    @property
    def total_seconds(self) -> float:
        return sum(self.stages.values())

    @property
    def rtf(self) -> float:
        """Real-time factor (audio seconds per wall second)."""
        t = self.total_seconds
        return self.audio_seconds / t if t > 0 else 0.0

    @property
    def audio_hours_per_min_per_chip(self) -> float:
        t = self.total_seconds
        if t <= 0 or self.n_chips <= 0:
            return 0.0
        return (self.audio_seconds / 3600.0) / (t / 60.0) / self.n_chips

    def to_dict(self) -> dict:
        return {
            "stages": dict(self.stages),
            "audio_seconds": self.audio_seconds,
            "total_seconds": self.total_seconds,
            "rtf": self.rtf,
            "audio_hours_per_min_per_chip": self.audio_hours_per_min_per_chip,
            "n_chips": self.n_chips,
        }

    def log(self, **extra):
        log_event("transcribe_trace", **self.to_dict(), **extra)


def log_event(event: str, **fields):
    """Single-line JSON structured log record."""
    logger.info(json.dumps({"event": event, **fields}, default=str))
