"""Local-receptive-field speaker embedder (x-vector style).

The PyTorch port of ``xvector_frames`` from
``omnilingual_asr_tpu/models/xvector.py``: five 1-D convolutions over the
log-mel with (kernel, stride, dilation) = (5,2,1) (5,2,1) (3,1,2) (3,1,4)
(3,1,8), each followed by a bias, a LayerNorm and a ReLU, then a dense
projection to 256-d frame embeddings at 1/4 of the mel frame rate.

The reference runs these as XLA convolutions in bf16 (bf16 inputs and
output, f32 accumulation); the port rounds inputs to bf16, convolves in f32
and rounds the result to bf16, which is the same arithmetic. On a card the
f32 convolution goes through cuDNN, so the engine sets
``torch.backends.cudnn.allow_tf32 = False``: TF32 would drop the f32
accumulation the reference has.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..config import PipelineConfig
from . import layers as L
from .conformer import N_SPEAKER_CLASSES, SPK_DIM

# (kernel, stride, dilation, out_channels) per conv layer.
_LAYERS = ((5, 2, 1, 128), (5, 2, 1, 256), (3, 1, 2, 256), (3, 1, 4, 256),
           (3, 1, 8, 256))


def xvector_param_shapes(cfg: PipelineConfig) -> Dict:
    """Shape tree of the x-vector parameters (counterpart of
    ``jax.eval_shape(xvector_init)``)."""
    convs, lns = [], []
    c_in = cfg.frontend.n_mels
    for k, _, _, c_out in _LAYERS:
        convs.append({"w": (k, c_in, c_out), "b": (c_out,)})
        lns.append({"scale": (c_out,), "bias": (c_out,)})
        c_in = c_out
    return {
        "convs": convs,
        "lns": lns,
        "out": {"w": (c_in, SPK_DIM), "b": (SPK_DIM,)},
        "spk_proj": {"w": (2 * SPK_DIM, SPK_DIM), "b": (SPK_DIM,)},
        "aam": (SPK_DIM, N_SPEAKER_CLASSES),
    }


def same_padding(T: int, k: int, stride: int, dilation: int):
    """(left, right) padding of XLA's "SAME" for a strided, dilated conv."""
    out = math.ceil(T / stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - T, 0)
    return total // 2, total - total // 2


def xvector_frames(params, mel: torch.Tensor, mask: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """[B, T, n_mels] log-mel -> [B, T // 4, 256] f32 frame embeddings.

    mask: [B, T] bool over mel frames; invalid frames are zeroed on input.
    """
    x = mel * mask[..., None]
    for conv, ln, (k, stride, dil, _) in zip(
            params["convs"], params["lns"], _LAYERS):
        xc = L.round_to(x, dtype).transpose(1, 2)           # [B, C, T]
        left, right = same_padding(xc.shape[-1], k, stride, dil)
        xc = F.pad(xc, (left, right))
        w = L.round_to(conv["w"], dtype).permute(2, 1, 0)   # [Cout, Cin, K]
        y = F.conv1d(xc, w, stride=stride, dilation=dil).transpose(1, 2)
        y = L.round_to(y, dtype) + L.round_to(conv["b"], dtype)
        x = L.layernorm_apply(ln, L.round_to(y, dtype))
        x = torch.relu(x)
    return L.dense_apply(params["out"], x, dtype)
