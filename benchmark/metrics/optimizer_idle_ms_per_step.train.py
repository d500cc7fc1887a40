"""The device idle while the optimizer's host code runs, in ms a step: the
traced slice's idle intervals within the ``step.optimizer`` spans (less
any child span), over the ``train.step`` spans in the slice. The card
idles once its queue is empty, so a gap is charged to the host span that
had not yet launched the next work."""

from benchmark.program_spans import idle_ms_per_step


def read(rec):
    return idle_ms_per_step(rec, ("step.optimizer",))
