"""Model FLOPs of the steps the window completed (forward and backward,
three times the forward, over the valid frames), over the window's
seconds, over the bf16 peak of one H100 SXM (989 TFLOP/s), in %."""

from benchmark.harness import mfu as read  # noqa: F401
