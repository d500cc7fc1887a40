"""Summary text for a transcription.

The PyTorch port of ``omnilingual_asr_tpu/models/summarizer.py``. Two tiers:

1. ``template_summary``: the deterministic metadata summary (duration,
   speaker count, segment count, languages, dominant tone) that the engine
   emits when no trained summarizer is loaded, and falls back to.
2. ``SummaryDecoder``: the neural summarizer, the translation decoder
   cross-attending to the whole file's encoder states mean-pooled to one
   vector a window (at most ``pool_windows`` slots). A fact-conditioned
   checkpoint (a ``"fact_cond"`` marker leaf) has the engine's own facts
   (speaker count, tone, languages) force-decoded as a prefix. The engine
   keeps a generated summary only where ``summary_consistent`` finds it
   agrees with those facts.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..types import EMOTIONS
from ..utils.tracing import row_steps_useful, span
from .translation import GreedyDecoder, tokens_to_text, translator_init


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


class SummaryDecoder:
    """Neural summary head over pooled encoder states.

    ``params`` is a decoder tree on the device that decodes it (random on
    the CPU from ``seed`` when omitted); ``decoder`` is its
    :class:`~.translation.GreedyDecoder`."""

    def __init__(self, cfg: PipelineConfig, params=None, *,
                 n_layers: int = 2, pool_windows: int = 128,
                 seed: int = 7):
        self.cfg = cfg
        self.pool_windows = pool_windows
        self.params = params if params is not None else translator_init(
            torch.Generator().manual_seed(seed), cfg, n_layers=n_layers)
        self.decoder = GreedyDecoder(self.params, cfg,
                                     n_heads=cfg.encoder.n_heads)

    def pool_states(self, window_states: List[np.ndarray]) -> np.ndarray:
        """Mean-pool each window's encoder frames to one vector and pad to
        ``pool_windows`` slots: [pool_windows, D] memory for the decoder.
        More windows than slots are averaged in groups to fit."""
        D = self.cfg.encoder.d_model
        if not window_states:
            return np.zeros((self.pool_windows, D), np.float32)
        means = np.stack([w.mean(axis=0) for w in window_states])
        n = len(means)
        if n > self.pool_windows:
            groups = np.array_split(means, self.pool_windows)
            means = np.stack([g.mean(axis=0) for g in groups])
            n = self.pool_windows
        out = np.zeros((self.pool_windows, D), np.float32)
        out[:n] = means
        return out

    @property
    def fact_conditioned(self) -> bool:
        """True for a checkpoint trained with a forced fact prefix (its
        ``"fact_cond"`` marker leaf)."""
        return isinstance(self.params, dict) and "fact_cond" in self.params

    def summarize(self, window_states: List[np.ndarray],
                  max_len: int = 192,
                  facts: Optional[dict] = None) -> Optional[str]:
        """Greedy-decode a summary from pooled states; None when the decode
        produces nothing useful (callers fall back to the template).

        For a fact-conditioned checkpoint, ``facts`` (``n_speakers``,
        ``tone``, ``language_names``: the engine's own head outputs) are
        force-decoded as a prefix, which is stripped from the text."""
        pooled = self.pool_states(window_states)
        n_valid = sum(1 for _ in window_states) or 1
        enc = torch.from_numpy(pooled)[None]
        mask = torch.from_numpy(
            np.arange(self.pool_windows) < min(n_valid, self.pool_windows)
        )[None]
        forced = None
        n_prefix = 0
        if facts is not None and self.fact_conditioned:
            prefix_ids = fact_prefix_ids(self.cfg.vocab, **facts)[:max_len]
            n_prefix = len(prefix_ids)
            f = np.full((1, max_len), -1, np.int32)
            f[0, :n_prefix] = prefix_ids
            forced = torch.from_numpy(f)
        with span("decode.summary", rows=1, rows_run=1,
                  steps_run=max_len) as sp:
            toks = self.decoder.decode(enc, mask, max_len=max_len,
                                       forced=forced).cpu().numpy()
            if sp.on:
                sp.counts["row_steps_useful"] = row_steps_useful(toks,
                                                                 n_prefix)
        text = tokens_to_text(toks[0, n_prefix:], self.cfg.vocab).strip()
        if not text or _degenerate(text):
            return None
        return text


def fact_prefix(*, n_speakers: int, tone: str,
                language_names: List[str]) -> str:
    """The engine's facts as the forced decode prefix, in the one format
    the summarizer was trained with."""
    langs = ", ".join(language_names[:4])
    return f"[{n_speakers} | {tone} | {langs}] "


def fact_prefix_ids(vocab, *, n_speakers: int, tone: str,
                    language_names: List[str]) -> List[int]:
    s = fact_prefix(n_speakers=n_speakers, tone=tone,
                    language_names=language_names)
    return [vocab.byte_to_id(b) for b in s.encode("utf-8")]


def _degenerate(text: str) -> bool:
    """True for decode collapse: under 80 % letters and spaces, or one word
    three times in a row."""
    letters = sum(c.isalpha() or c.isspace() for c in text)
    if letters / max(len(text), 1) < 0.8:
        return True
    toks = text.lower().split()
    for a, b, c in zip(toks, toks[1:], toks[2:]):
        if a == b == c:
            return True
    return False


_COUNT_WORDS = {1: ("one", "single", "1"), 2: ("two", "2"),
                3: ("three", "3"), 4: ("four", "4"), 5: ("five", "5")}


def summary_consistent(text: str, *, n_speakers: int, tone: str) -> bool:
    """Does a generated summary agree with the engine's own facts? It must
    name exactly the engine's tone among the emotions, name the speaker
    count (as a word or a digit), and claim no other count in digits."""
    s = text.lower()
    mentioned = {e for e in EMOTIONS if e in s}
    if mentioned != {tone}:
        return False
    if n_speakers > 0:
        words = _COUNT_WORDS.get(n_speakers, (str(n_speakers),))
        if not any(w in s for w in words):
            return False
        for d in re.findall(r"\b(\d+)\b", s):
            if int(d) != n_speakers:
                return False
    return True
