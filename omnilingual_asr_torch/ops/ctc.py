"""CTC host half: greedy collapse and text/segment assembly.

The PyTorch port's own copy of the host functions of
``omnilingual_asr_tpu/ops/ctc.py`` (the CTC loss is training, a later
slice; the greedy argmax runs inside the engine's per-batch program).
Segmentation from blank runs honors the reference's segment-granularity
contract: short phrase-level segments of roughly 2-10 s, split at pauses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..config import DecodeConfig, VocabConfig
from ..types import WordTimestamp


@dataclass
class AlignedUnit:
    """One emitted byte with its frame index."""

    byte_id: int
    frame: int


def collapse_ctc(frame_ids: np.ndarray, blank_id: int = 0) -> List[AlignedUnit]:
    """Greedy CTC collapse: drop repeats then blanks, keeping the first frame
    index of each emitted unit."""
    out: List[AlignedUnit] = []
    prev = -1
    for t, c in enumerate(frame_ids):
        c = int(c)
        if c != prev and c != blank_id:
            out.append(AlignedUnit(byte_id=c, frame=t))
        prev = c
    return out


@dataclass
class DecodedSegment:
    """Host-side decoded segment before enrichment (speaker/LID/emotion)."""

    text: str
    start: float
    end: float
    frame_start: int
    frame_end: int
    words: Optional[List[WordTimestamp]] = None


def _bytes_to_text(byte_vals: List[int]) -> str:
    # Defensive: drop ids that fall in the vocab's alignment-padding range.
    return bytes(b for b in byte_vals if 0 <= b < 256).decode(
        "utf-8", errors="replace")


def segments_from_alignment(
    frame_ids: np.ndarray,
    frame_dur_s: float,
    vocab: VocabConfig,
    decode_cfg: DecodeConfig,
    time_offset_s: float = 0.0,
    n_valid_frames: Optional[int] = None,
) -> List[DecodedSegment]:
    """Split a greedy CTC alignment into phrase segments at blank runs.

    A blank run longer than ``decode_cfg.blank_gap_s`` ends the current
    segment; segments longer than ``segment_max_s`` are force-split at the
    largest internal gap. This reproduces the reference's contract of many
    short 2-10 s segments (gemini_pipeline.py:206) from the acoustics instead
    of a prompt instruction.
    """
    if n_valid_frames is not None:
        frame_ids = frame_ids[:n_valid_frames]
    units = collapse_ctc(frame_ids, vocab.blank_id)
    if not units:
        return []

    gap_frames = max(1, int(round(decode_cfg.blank_gap_s / frame_dur_s)))
    max_frames = max(1, int(round(decode_cfg.segment_max_s / frame_dur_s)))

    # Group units into segments.
    groups: List[List[AlignedUnit]] = [[units[0]]]
    for prev_u, u in zip(units, units[1:]):
        gap = u.frame - prev_u.frame
        seg_len = u.frame - groups[-1][0].frame
        if gap >= gap_frames or seg_len >= max_frames:
            groups.append([u])
        else:
            groups[-1].append(u)

    segs: List[DecodedSegment] = []
    for g in groups:
        byte_vals = [vocab.id_to_byte(u.byte_id) for u in g]
        text = _bytes_to_text(byte_vals).strip()
        if not text:
            continue
        f0, f1 = g[0].frame, g[-1].frame + 1
        start = time_offset_s + f0 * frame_dur_s
        end = time_offset_s + f1 * frame_dur_s
        # Reference fixup: end must be strictly after start
        # (gemini_pipeline.py:396-397).
        if end <= start:
            end = start + 1.0
        words = _words_from_units(g, vocab, frame_dur_s, time_offset_s)
        segs.append(DecodedSegment(text=text, start=start, end=end,
                                   frame_start=f0, frame_end=f1, words=words))
    return segs


def _words_from_units(units: List[AlignedUnit], vocab: VocabConfig,
                      frame_dur_s: float, offset: float) -> List[WordTimestamp]:
    """Word-level timestamps from the byte alignment (split on ASCII space)."""
    words: List[WordTimestamp] = []
    cur: List[AlignedUnit] = []
    SPACE = vocab.byte_to_id(0x20)

    def flush():
        if not cur:
            return
        text = _bytes_to_text([vocab.id_to_byte(u.byte_id) for u in cur]).strip()
        if text:
            words.append(WordTimestamp(
                word=text,
                start=offset + cur[0].frame * frame_dur_s,
                end=offset + (cur[-1].frame + 1) * frame_dur_s,
            ))

    for u in units:
        if u.byte_id == SPACE:
            flush()
            cur = []
        else:
            cur.append(u)
    flush()
    return words
