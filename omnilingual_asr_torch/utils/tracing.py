"""Spans on the host's clock, and per-stage wall time for one transcription.

``StageTrace`` and ``log_event`` are the PyTorch port's copies of those in
``omnilingual_asr_tpu/utils/tracing.py``. Stage names are the JAX engine's:
``decode``, ``forward``, ``extract``, ``assemble`` and
``assemble.<sub-stage>``.

**Spans.** ``with span(name, **counts) as s:`` records one :class:`Span`:
its name, ``start`` and ``end`` in ``time.perf_counter()`` seconds, the
thread, its id, the span open around it in the same context (its parent)
and the request it belongs to, both from a ``contextvars`` stack, and the
counts given at its boundaries (``s.counts``). ``span(..., request=True)``
opens a request's root span: its id is the request id of every span
opened inside it.

Spans are recorded only while a ``torch.profiler`` session records, in any
thread of the process; otherwise a span costs one check of the profiler's
flag and records nothing. So a traced run of the benchmark records exactly
its traced slice, and an operator gets the spans by running the server or
a trainer under ``torch.profiler.profile``. They are kept in memory, the
last ``MAX_SPANS``, and :func:`spans` returns a copy. They never enter the
profiler's own events: under CUDA activity the profiler records user
annotations as device events, which would count as the device's busy time.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch.autograd.profiler as _profiler

logger = logging.getLogger("omniasr")

#: Spans kept, the newest: a traced second of serving records ~70.
MAX_SPANS = 1 << 16

_SPANS: "collections.deque[Span]" = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
#: (id of the innermost open span, its request id) in this context.
_OPEN: contextvars.ContextVar[Tuple[Optional[int], Optional[int]]] = \
    contextvars.ContextVar("omniasr_open_span", default=(None, None))


@dataclass(frozen=True)
class Span:
    """One timed block: seconds on the ``time.perf_counter()`` clock."""

    name: str
    start: float
    end: float
    thread: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    counts: Dict[str, object]


def spans() -> List[Span]:
    """A copy of the recorded spans, oldest first."""
    return list(_SPANS)


def clear() -> None:
    """Forgets every recorded span."""
    _SPANS.clear()


class _Off:
    """What :func:`span` gives while nothing records: a block that costs
    one check and records nothing."""

    __slots__ = ()
    on = False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


class _Recording:
    """A span being recorded: appended to the recorder when it ends."""

    __slots__ = ("name", "counts", "_new_request", "_start", "_id",
                 "_parent", "_request", "_token")
    on = True

    def __init__(self, name: str, request: bool, counts: dict):
        self.name, self.counts, self._new_request = name, counts, request

    def __enter__(self) -> "_Recording":
        self._id = next(_IDS)
        self._parent, self._request = _OPEN.get()
        if self._new_request:
            self._request = self._id
        self._token = _OPEN.set((self._id, self._request))
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        _OPEN.reset(self._token)
        _SPANS.append(Span(self.name, self._start, end, threading.get_ident(),
                           self._id, self._parent, self._request,
                           self.counts))


def span(name: str, *, request: bool = False, **counts):
    """``with span(name, **counts) as s:`` times the block as a
    :class:`Span` while the profiler records; ``s.on`` says whether it
    records, and ``s.counts`` (the counts given, and any added inside the
    block while it records) go on the span. The check reads the profiler's
    Python flag, which every thread sees;
    ``torch._C._autograd._profiler_enabled()`` is the starting thread's
    state, false in the serving threads."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, request, counts)


def row_steps_useful(tokens, n_forced: int = 0) -> int:
    """Decoder steps the rows of ``tokens`` ([rows, steps], on the host)
    needed: each row's ``n_forced`` forced steps, then its steps up to and
    including its first free EOS (token 0), or every step where it has
    none."""
    eos = np.asarray(tokens)[:, n_forced:] == 0
    rows, n = eos.shape
    # A last column of EOS finds the rows without one (and rows of none).
    first = np.concatenate([eos, np.ones((rows, 1), bool)], 1).argmax(1)
    return int(rows * n_forced + np.minimum(first + 1, n).sum())


@dataclass
class StageTrace:
    """Per-run stage timings for one transcription: seconds a stage, each
    stage's block also a span (:func:`span`)."""

    stages: Dict[str, float] = field(default_factory=dict)
    audio_seconds: float = 0.0
    n_chips: int = 1

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def to_dict(self) -> dict:
        return {
            "stages": dict(self.stages),
            "audio_seconds": self.audio_seconds,
            "n_chips": self.n_chips,
        }

    def log(self, **extra):
        log_event("transcribe_trace", **self.to_dict(), **extra)


def log_event(event: str, **fields):
    """Single-line JSON structured log record."""
    logger.info(json.dumps({"event": event, **fields}, default=str))
