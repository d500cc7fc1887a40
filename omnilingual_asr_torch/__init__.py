"""omnilingual_asr_torch: the PyTorch/CUDA port of ``omnilingual_asr_tpu``.

This slice serves window-mode transcription (``TranscriptionEngine``) on one
NVIDIA Hopper card, with hand-written CUDA kernels for the log-mel frontend
(``ops/mel.py``), flash-attention forward (``ops/attention.py``) and the
fused conformer conv module (``ops/conv_module.py``). Every kernel has a
plain PyTorch version beside it, which runs for tensors on the CPU.
"""

__version__ = "0.1.0"

from .config import PipelineConfig, tiny_config  # noqa: F401
from .types import (  # noqa: F401
    TranscriptSegment,
    TranscriptionResult,
    WordTimestamp,
)

__all__ = [
    "__version__",
    "PipelineConfig",
    "tiny_config",
    "TranscriptSegment",
    "TranscriptionResult",
    "WordTimestamp",
    "TranscriptionEngine",
]


def __getattr__(name):
    # Lazy, so that a bare import stays light.
    if name == "TranscriptionEngine":
        from .engine import TranscriptionEngine

        return TranscriptionEngine
    raise AttributeError(name)
