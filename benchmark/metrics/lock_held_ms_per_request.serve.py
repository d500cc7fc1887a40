"""The engine's device lock held, in ms a request: the ``lock.held`` spans
of each request that ends in the traced slice (every site), summed,
averaged over those requests. The lock serializes this time, so the cell
completes at most one 120 s file per this many ms."""

from benchmark.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, lambda s: s.name == "lock.held")
