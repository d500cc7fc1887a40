"""The decoders under the device lock, in ms a request: the ``lock.held``
spans with site ``translate`` or ``summary`` of each request that ends in
the traced slice, summed, averaged over those requests. The translator and
the summarizer without the wait for the lock, unrounded."""

from benchmark.program_spans import per_request_ms


def read(rec):
    return per_request_ms(rec, lambda s: s.name == "lock.held" and
                          s.counts.get("site") in ("translate", "summary"))
