"""The program's own spans (``omnilingual_asr_torch.utils.tracing``)
against a traced slice, for the per-layer readers that read them.

The port records spans only while a profiler records, so in a traced run
they cover the traced slice, and their ``start``/``end`` are
``time.perf_counter()`` seconds, the clock onto which ``device_profile``
maps the device's operations: a span is placed against ``rec.trace`` with
no offset. A program that records no spans (an untraced run, or a port
without the recorder) gives every reader nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

Intervals = List[Tuple[float, float]]


def recorded(rec) -> Optional[list]:
    """Every span the program recorded, or None: no trace, or none
    recorded."""
    if rec.trace is None:
        return None
    try:
        from omnilingual_asr_torch.utils.tracing import spans
    except ImportError:
        return None
    return spans() or None


def in_slice(rec, spans) -> list:
    """The spans that overlap the traced slice."""
    lo, hi = rec.trace.start_s, rec.trace.end_s
    return [s for s in spans if s.end > lo and s.start < hi]


def per_request_ms(rec, keep: Callable) -> Optional[float]:
    """The mean over requests of the milliseconds of a request's spans
    that ``keep`` keeps. A request is a ``request`` span that ends inside
    the slice, with every span of its request id."""
    spans = recorded(rec)
    if spans is None:
        return None
    lo, hi = rec.trace.start_s, rec.trace.end_s
    roots = [s.id for s in spans
             if s.name == "request" and lo <= s.end <= hi]
    if not roots:
        return None
    ms: Dict[int, float] = dict.fromkeys(roots, 0.0)
    for s in spans:
        if s.request in ms and keep(s):
            ms[s.request] += 1e3 * (s.end - s.start)
    return sum(ms.values()) / len(ms)


def union(intervals: Intervals) -> Intervals:
    """Sorted, disjoint intervals covering the same instants."""
    out: Intervals = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_s(a: Intervals, b: Intervals) -> float:
    """Seconds two sets of sorted, disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> Intervals:
    """The slice's idle intervals: the complement of the device's busy
    intervals within it."""
    starts, ends = trace.busy_intervals()
    edges = [trace.start_s] + [x for ab in zip(starts, ends) for x in ab] \
        + [trace.end_s]
    return [(float(a), float(b)) for a, b in zip(edges[::2], edges[1::2])
            if b > a]


def innermost(spans, names: Sequence[str]) -> Intervals:
    """The instants at which a span named in ``names`` is its thread's
    innermost open span: each such span less its children."""
    kids: Dict[int, Intervals] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start, s.end))
    out: Intervals = []
    for s in spans:
        if s.name not in names:
            continue
        t = s.start
        for a, b in union(kids.get(s.id, [])):
            if a > t:
                out.append((t, min(a, s.end)))
            t = max(t, b)
        if s.end > t:
            out.append((t, s.end))
    return union(out)


def idle_ms_per_step(rec, names: Sequence[str]) -> Optional[float]:
    """The device's idle milliseconds while the innermost open span is one
    of ``names``, per ``train.step`` span in the slice: a gap is charged
    to the host span that had not yet launched the next work."""
    spans = recorded(rec)
    if spans is None:
        return None
    steps = [s for s in in_slice(rec, spans) if s.name == "train.step"]
    if not steps:
        return None
    return 1e3 * overlap_s(idle(rec.trace), innermost(spans, names)) \
        / len(steps)
