"""omnilingual_asr_torch: the PyTorch/CUDA port of ``omnilingual_asr_tpu``.

The port serves window-mode transcription (``TranscriptionEngine`` and the
``GeminiDiarizedTranscriptionPipeline`` facade) on one NVIDIA Hopper card,
unquantized or in the int8 modes (``quantize=True``, ``"w8"``, ``"a8"``),
with hand-written CUDA kernels for the log-mel frontend (``ops/mel.py``),
flash-attention forward (``ops/attention.py``), the fused conformer conv
module (``ops/conv_module.py``) and the int8 matmuls (``ops/quant.py``).
Every kernel has a plain PyTorch version beside it, which runs for tensors
on the CPU.
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
    "GeminiDiarizedTranscriptionPipeline",
    "DiarizedTranscriptSegment",
]


def __getattr__(name):
    # Lazy, so that a bare import stays light.
    if name == "TranscriptionEngine":
        from .engine import TranscriptionEngine

        return TranscriptionEngine
    if name in ("GeminiDiarizedTranscriptionPipeline",
                "DiarizedTranscriptSegment"):
        from .diarization import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)
