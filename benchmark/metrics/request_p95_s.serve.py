"""The 95th percentile of the latency, submission to result, of every
request of the window that finished before the profiler started (failed
requests count with their time to failure). The closed loop holds the
server at its capacity, where a tail swings from run to run, so it stands
here beside the completed rate rather than as an end-to-end metric."""

from benchmark.harness import percentile


def read(rec):
    lat = rec.facts.get("latencies_s")
    return percentile(lat, 95.0) if lat else None
