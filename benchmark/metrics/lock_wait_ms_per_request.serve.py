"""The wait for the engine's device lock, in ms a request: the ``lock.wait``
spans of each request that ends in the traced slice (every site), summed,
averaged over those requests. Four clients share one lock, so this is the
queue in front of the card."""

from benchmark.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, lambda s: s.name == "lock.wait")
