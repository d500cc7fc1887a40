"""CTC: the training loss, greedy collapse and text/segment assembly.

The PyTorch port of ``omnilingual_asr_tpu/ops/ctc.py``: ``ctc_loss`` and
``text_to_byte_labels`` for training, and the host functions (the greedy
argmax runs inside the engine's per-batch program). Segmentation from blank
runs honors the reference's segment-granularity contract: short
phrase-level segments of roughly 2-10 s, split at pauses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import DecodeConfig, VocabConfig
from ..types import WordTimestamp


#: optax's stand-in for log 0 in the CTC recursion (``log_epsilon``).
LOG_EPSILON = -1e5


def infeasible_rows(n_frames, labels, label_mask) -> np.ndarray:
    """Host-side indices of the rows whose labels cannot be aligned in their
    frames: label count plus adjacent repeats (each needs a blank between)
    above the frame count. numpy in, numpy int64 out; reads no tensor.

    n_frames [B] valid (subsampled) frames; labels [B, L]; label_mask
    [B, L] bool, right-padded.
    """
    labels = np.asarray(labels)
    label_mask = np.asarray(label_mask, bool)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & label_mask[:, 1:]).sum(axis=1)
    need = label_mask.sum(axis=1) + repeats
    return np.flatnonzero(need > np.asarray(n_frames)).astype(np.int64)


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` for same-shape a, b, with JAX's formula and
    JAX's derivative rule (``jax.lax.logaddexp``): da = g exp(a - out),
    db = g exp(b - out). In f32, near optax's -1e5 stand-in for log 0, that
    rule and PyTorch's own (g / (1 + exp(b - a))) round differently, and
    the reference's gradient is the one to match."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss_optax(logp: torch.Tensor, logit_mask: torch.Tensor,
                   labels: torch.Tensor, label_mask: torch.Tensor,
                   blank_id: int = 0) -> torch.Tensor:
    """Per-sequence CTC loss [B] by optax's forward recursion
    (``optax.ctc_loss``): log-space alphas over the frames, with
    ``LOG_EPSILON`` standing for log 0, so that a row whose labels cannot
    be aligned gets a large finite loss and a finite gradient where
    ``F.ctc_loss`` gives +inf. Plain PyTorch, one step per frame;
    differentiable through autograd.

    logp [B, T, V] log-probabilities; masks and labels as :func:`ctc_loss`.
    """
    B, T, _ = logp.shape
    N = labels.shape[1]
    eps = LOG_EPSILON
    labels = labels.to(torch.long)
    f32 = logp.dtype
    repeat = torch.zeros((B, N), dtype=f32, device=logp.device)
    repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).to(f32)
    logp_phi = logp[:, :, blank_id]                                # [B, T]
    logp_emit = torch.gather(logp, 2, labels[:, None, :].expand(B, T, N))
    pad = 1.0 - logit_mask.to(f32)                                 # [B, T]
    phi = torch.full((B, N + 1), eps, dtype=f32, device=logp.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), eps, dtype=f32, device=logp.device)

    def add_to_phi(phi, score):        # phi[:, 1:] += score in log space
        return torch.cat([phi[:, :1], _LogAddExp.apply(phi[:, 1:], score)],
                         dim=1)

    for t in range(T):
        prev_phi = phi
        phi_e = add_to_phi(phi, emit + eps * repeat)
        le, lp = logp_emit[:, t], logp_phi[:, t:t + 1]
        next_emit = _LogAddExp.apply(phi_e[:, :-1] + le, emit + le)
        next_phi = add_to_phi(phi_e + lp, emit + lp + eps * (1.0 - repeat))
        p = pad[:, t:t + 1]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * prev_phi + (1.0 - p) * next_phi
    phi = add_to_phi(phi, emit)
    n_labels = label_mask.sum(dim=1).to(torch.long)
    return -torch.gather(phi, 1, n_labels[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, logit_mask: torch.Tensor,
             labels: torch.Tensor, label_mask: torch.Tensor,
             blank_id: int = 0, infeasible=None) -> torch.Tensor:
    """Summed per-sequence CTC loss over the rows that have labels, as the
    reference's ``optax.ctc_loss`` sum divided by that row count.

    logits [B, T, V] f32; logit_mask [B, T] bool (valid frames are a
    prefix); labels [B, L] int; label_mask [B, L] bool (right-padded).
    Rows whose labels can be aligned go to ``F.ctc_loss`` (with
    ``reduction="none"``, so that nothing divides by target length); the
    others, where it would give +inf, to :func:`ctc_loss_optax`, which
    gives optax's large finite value and gradient.

    ``infeasible``: those rows' indices, from host-side lengths
    (:func:`infeasible_rows`). When None they are found from the tensors,
    which for tensors on a card reads the lengths back to the host; a
    trainer passes them from the batch it built. A batch with no such row
    runs ``F.ctc_loss`` alone.
    """
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if infeasible is None:
        infeasible = infeasible_rows(logit_mask.sum(dim=1).cpu().numpy(),
                                     labels.cpu().numpy(),
                                     label_mask.cpu().numpy())
    infeasible = np.asarray(infeasible, np.int64)
    n_valid = torch.clamp(label_mask.any(dim=-1).sum(), min=1)
    sums = []
    if infeasible.size:
        bad = torch.from_numpy(infeasible).to(logits.device)
        sums.append(ctc_loss_optax(logp[bad], logit_mask[bad], labels[bad],
                                   label_mask[bad], blank_id).sum())
        keep = torch.from_numpy(np.setdiff1d(
            np.arange(logits.shape[0]), infeasible)).to(logits.device)
        logp, logit_mask, labels, label_mask = (
            t[keep] for t in (logp, logit_mask, labels, label_mask))
    if logp.shape[0]:
        sums.append(torch.nn.functional.ctc_loss(
            logp.transpose(0, 1), labels.to(torch.long),
            logit_mask.sum(dim=1).to(torch.long),
            label_mask.sum(dim=1).to(torch.long), blank=blank_id,
            reduction="none").sum())
    return sum(sums[1:], sums[0]) / n_valid


def text_to_byte_labels(text: str, vocab: VocabConfig, max_len: int):
    """Encode text as padded byte-label arrays for CTC training.

    Returns (labels [max_len] int32, mask [max_len] bool).
    """
    raw = text.encode("utf-8")[:max_len]
    ids = np.full((max_len,), 0, dtype=np.int32)
    mask = np.zeros((max_len,), dtype=bool)
    for i, b in enumerate(raw):
        ids[i] = vocab.byte_to_id(b)
        mask[i] = True
    return ids, mask


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
