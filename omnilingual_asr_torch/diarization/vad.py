"""Voice activity detection: energy-based VAD over log-mel frames.

The PyTorch port's own copy of ``omnilingual_asr_tpu/diarization/vad.py`` (the port imports nothing
of the JAX package); keep the two in step.

The reference has no VAD — Gemini does segmentation implicitly (prompt
requirement #3, reference gemini_pipeline.py:206). Locally, CTC blank runs
drive segmentation (ops/ctc.py); this VAD supplements it for diarization:
speaker embeddings are pooled over *speech* frames only, and leading/trailing
silence is trimmed from segment boundaries.

Pure NumPy on the already-computed mel (no extra device work).
"""

from __future__ import annotations

import numpy as np


def frame_energy_db(mel: np.ndarray) -> np.ndarray:
    """Per-frame energy proxy from log-mel: logsumexp over mel bins,
    scaled to dB. mel: [T, n_mels] natural-log power."""
    m = mel.max(axis=1)
    e = m + np.log(np.exp(mel - m[:, None]).sum(axis=1))
    return 10.0 * e / np.log(10.0)


def vad_mask(mel: np.ndarray, *, margin_db: float = 12.0,
             floor_percentile: float = 10.0,
             abs_speech_db: float = 0.0,
             min_speech_frames: int = 5,
             min_gap_frames: int = 3) -> np.ndarray:
    """Boolean speech mask [T] from log-mel.

    A frame is speech when its energy exceeds the noise floor (the
    ``floor_percentile`` of frame energies) by ``margin_db``, OR exceeds an
    absolute level (``abs_speech_db``, ~-27 dBFS for a sine) — the absolute
    criterion keeps continuously-voiced audio (no silence anywhere, so the
    relative floor equals speech level) from reading as all-silence. Short
    speech islands are dropped and short gaps bridged.
    """
    if len(mel) == 0:
        return np.zeros((0,), dtype=bool)
    e = frame_energy_db(mel)
    floor = np.percentile(e, floor_percentile)
    speech = (e > floor + margin_db) | (e > abs_speech_db)

    # Bridge short gaps.
    out = speech.copy()
    t = 0
    T = len(out)
    while t < T:
        if not out[t]:
            start = t
            while t < T and not out[t]:
                t += 1
            if t < T and start > 0 and (t - start) <= min_gap_frames:
                out[start:t] = True
        else:
            t += 1
    # Drop short islands.
    t = 0
    while t < T:
        if out[t]:
            start = t
            while t < T and out[t]:
                t += 1
            if (t - start) < min_speech_frames:
                out[start:t] = False
        else:
            t += 1
    return out


def speech_ratio(mel: np.ndarray) -> float:
    m = vad_mask(mel)
    return float(m.mean()) if len(m) else 0.0
