"""Local-receptive-field speaker embedder (x-vector style).

The PyTorch port of ``xvector_frames`` from
``omnilingual_asr_tpu/models/xvector.py``: five 1-D convolutions over the
log-mel with (kernel, stride, dilation) = (5,2,1) (5,2,1) (3,1,2) (3,1,4)
(3,1,8), each followed by a bias, a LayerNorm and a ReLU, then a dense
projection to 256-d frame embeddings at 1/4 of the mel frame rate.

The training half (``xvector_init``, ``xvector_pooled``, ``save_xvector``)
is what ``train/xvector_train.py`` needs: stats pooling over the valid
frames, the ``spk_proj`` projection and L2 normalisation, differentiable
through ``xvector_frames``.

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
from .conformer import N_SPEAKER_CLASSES, SPK_DIM, _unit_columns

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


def xvector_init(gen: torch.Generator, cfg: PipelineConfig) -> Dict:
    """Random parameters (CPU f32) with the tree of
    :func:`xvector_param_shapes`, drawn as the reference draws them: conv
    weights [K, Cin, Cout] N(0, 1 / (K Cin)), zero biases, identity
    LayerNorms, the reference's dense init for ``out`` and ``spk_proj``,
    unit columns for the AAM classes."""
    params: Dict = {"convs": [], "lns": []}
    c_in = cfg.frontend.n_mels
    for k, _, _, c_out in _LAYERS:
        w = torch.randn((k, c_in, c_out), generator=gen) / math.sqrt(k * c_in)
        params["convs"].append({"w": w, "b": torch.zeros(c_out)})
        params["lns"].append(L.layernorm_init(c_out))
        c_in = c_out
    params["out"] = L.dense_init(gen, c_in, SPK_DIM)
    params["spk_proj"] = L.dense_init(gen, 2 * SPK_DIM, SPK_DIM)
    params["aam"] = _unit_columns(gen, (SPK_DIM, N_SPEAKER_CLASSES))
    return params


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


def xvector_pooled(params, mel: torch.Tensor, mask: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Utterance-level L2-normalised embedding [B, 256] (the training
    path): mean and standard deviation over the valid subsampled frames,
    then ``spk_proj`` in f32."""
    frames = xvector_frames(params, mel, mask, dtype)
    sub = mask.shape[1] // frames.shape[1]
    w = mask.reshape(mask.shape[0], -1, sub).any(dim=-1).to(torch.float32)
    n = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    mean = (frames * w[..., None]).sum(dim=1) / n
    var = ((frames - mean[:, None]) ** 2 * w[..., None]).sum(dim=1) / n
    pooled = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)
    e = L.dense_apply(params["spk_proj"], pooled, torch.float32)
    return e * torch.rsqrt((e * e).sum(dim=-1, keepdim=True) + 1e-8)


def save_xvector(path, params) -> None:
    """Write the parameters as a release ``.npz`` (float16,
    ``models/zoo.py::save_release``)."""
    from .zoo import save_release

    save_release(path, params)

