"""Where the port computes: the card unless the caller asks for the CPU.

Every public compute entry point of the port (the engine, the training
steps, the log-mel frontend, the trainers' frozen encoders) takes
``device=None`` to mean the current CUDA device, and raises without one
unless the caller passes ``device="cpu"``, so that no run falls back to
the CPU unasked. The JAX counterparts run on the default accelerator.
"""

from __future__ import annotations

from typing import Iterable

import torch


def resolve_device(device) -> torch.device:
    """The device a ``device=`` argument names: CUDA (the current device)
    for None, which raises without a card; else ``"cpu"`` or
    ``"cuda[:N]"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on CUDA unless "
                "it is given device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"device must be 'cuda[:N]' or 'cpu', got "
                         f"{device!r}") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               f"device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda[:N]' or 'cpu', got {device!r}")
    return dev


def exact_f32(devices: Iterable[torch.device]) -> None:
    """TF32 off for matmuls and cuDNN, for the process, when any of
    ``devices`` is a card: the reference's f32 products are exact f32
    products (an f32 encoder's every dense layer; the mel and the
    quantizer's similarities at either dtype), and TF32 keeps 10 mantissa
    bits."""
    if any(torch.device(d).type == "cuda" for d in devices):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
