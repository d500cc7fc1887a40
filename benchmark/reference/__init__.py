"""The plain reference: the model's equations in plain PyTorch, in f32 with
TF32 off, written from the architecture's description (the log-mel
frontend, the conformer with its heads, the x-vector embedder, the byte
decoders and the multi-task training loss with AdamW). It imports nothing
of the program under test and takes nothing the program has made: weights
come from the committed files or from the benchmark's own seeded draws.
"""

import torch


def exact_f32() -> None:
    """f32 products stay f32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
