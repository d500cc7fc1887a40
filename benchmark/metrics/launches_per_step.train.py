"""Device kernels a training step launches: the kernel events of the
traced steps over their number (copies and sets not counted)."""

from benchmark.harness import is_kernel


def read(rec):
    steps = rec.facts.get("trace_steps")
    if rec.trace is None or not steps:
        return None
    return rec.trace.count(is_kernel) / steps
