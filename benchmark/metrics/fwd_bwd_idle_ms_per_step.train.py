"""The device idle while the gather, the forward with its loss, or the
backward runs on the host, in ms a step: the traced slice's idle intervals
within the ``step.gather``, ``step.forward`` and ``step.backward`` spans
(less any child span), over the ``train.step`` spans in the slice."""

from benchmark.program_spans import idle_ms_per_step


def read(rec):
    return idle_ms_per_step(rec, ("step.gather", "step.forward",
                                  "step.backward"))
