"""Model FLOPs of the useful work the window completed (the windows that
hold audio through the conformer, its heads and the x-vector, and the
decoder steps up to each row's EOS), over the window's seconds, over the
bf16 peak of one H100 SXM (989 TFLOP/s), in %."""

from benchmark.harness import mfu as read  # noqa: F401
