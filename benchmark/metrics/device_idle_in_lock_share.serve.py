"""The device idle while a request holds the engine's device lock, as a
share of the traced slice, in %: the slice's idle intervals (the
complement of every kernel's, copy's and set's interval) within the union
of the ``lock.held`` spans. Idle time the lock's holder leaves the card,
which no other client can fill."""

from benchmark.program_spans import idle, in_slice, overlap_s, recorded, \
    union


def read(rec):
    spans = recorded(rec)
    if spans is None:
        return None
    t = rec.trace
    held = union([(max(s.start, t.start_s), min(s.end, t.end_s))
                  for s in in_slice(rec, spans) if s.name == "lock.held"])
    if not held or t.window_s <= 0:
        return None
    return 100.0 * overlap_s(idle(t), held) / t.window_s
