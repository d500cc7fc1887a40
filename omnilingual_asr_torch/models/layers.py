"""Layer functions on parameter dicts.

The PyTorch port of the apply functions of
``omnilingual_asr_tpu/models/layers.py``. Parameters are nested dicts of
f32 tensors with the JAX package's leaf names (``{"w", "b"}`` for a dense
layer, ``{"scale", "bias"}`` for a LayerNorm), so the two packages compute
on the same trees.

Numerics follow the reference: a dense layer rounds its input and weight to
the compute dtype (bf16) and accumulates in f32 with an f32 bias. The port
holds the rounded values in f32 and multiplies in f32, which is what a bf16
matmul with f32 accumulation computes; on a card this needs TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops.attention import flash_attention
from ..ops.quant import dense_quant_matmul, kernel_shapes_ok


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round to ``dtype`` and hold the result in f32."""
    return x.to(dtype).to(torch.float32)


def dense_apply(p, x: torch.Tensor, dtype=torch.bfloat16,
                quant: Optional[str] = None) -> torch.Tensor:
    """x @ w (+ b): inputs rounded to ``dtype``, f32 accumulation.

    A quantized leaf (``{"w_q", "w_scale"}``, ``ops/quant.py``) goes through
    kernel K5 (``quant="a8"``) or K4 (``quant="w8"``) where the kernels take
    its shape (``kernel_shapes_ok``). Otherwise, and with ``quant=None``,
    its weight is dequantized as the reference's XLA path computes it,
    ``dtype(w_q) * dtype(w_scale)`` rounded once to ``dtype``, and the usual
    product follows. The mode is an argument, never module state: the
    reference records a bug that a process-wide flag caused.
    """
    if "w_q" in p:
        if quant is not None and kernel_shapes_ok(*p["w_q"].shape):
            return dense_quant_matmul(x, p["w_q"], p["w_scale"], quant,
                                      bias=p.get("b"), w_t=p.get("w_t"))
        w = round_to(p["w_q"].to(torch.float32) * round_to(p["w_scale"],
                                                           dtype), dtype)
    else:
        w = round_to(p["w"], dtype)
    y = round_to(x, dtype) @ w
    if "b" in p:
        y = y + p["b"].to(torch.float32)
    return y


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * p["scale"] + p["bias"]


def rope_angles(seq_len: int, head_dim: int, base: float = 10_000.0,
                device="cpu"):
    """(cos, sin), each [seq_len, head_dim // 2] f32."""
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (np.arange(0, half, dtype=np.float64) / half))
    ang = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., T, n_heads, head_dim]; cos/sin [T, head_dim // 2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def mhsa_apply(p, x: torch.Tensor, n_heads: int, mask: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, dtype=torch.bfloat16,
               use_flash: bool = False,
               quant: Optional[str] = None) -> torch.Tensor:
    """Pre-LN RoPE self-attention with a residual. x [B, T, D]; mask [B, T]
    bool (True = valid key).

    The two paths differ on a fully-masked query row, as in the reference:
    the plain path gives it a uniform softmax, the flash path zeros.
    """
    B, T, D = x.shape
    hd = D // n_heads
    h = layernorm_apply(p["ln"], x)
    q = dense_apply(p["wq"], h, dtype, quant).reshape(B, T, n_heads, hd)
    k = dense_apply(p["wk"], h, dtype, quant).reshape(B, T, n_heads, hd)
    v = dense_apply(p["wv"], h, dtype, quant).reshape(B, T, n_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if use_flash:
        out, _ = flash_attention(q.to(dtype).contiguous(),
                                 k.to(dtype).contiguous(),
                                 v.to(dtype).contiguous(), mask)
        out = out.to(torch.float32).reshape(B, T, D)
        return x + dense_apply(p["wo"], out, dtype, quant)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bthd,bshd->bhts", round_to(q, dtype),
                          round_to(k, dtype)) * scale
    neg = torch.finfo(torch.float32).min
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, neg))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", round_to(attn, dtype),
                       round_to(v, dtype))
    return x + dense_apply(p["wo"], out.reshape(B, T, D), dtype,
                           quant)


def ffn_apply(p, x: torch.Tensor, dtype=torch.bfloat16,
              half_step: bool = True,
              quant: Optional[str] = None) -> torch.Tensor:
    h = layernorm_apply(p["ln"], x)
    h = dense_apply(p["w1"], h, dtype, quant)
    h = torch.nn.functional.silu(h)
    h = dense_apply(p["w2"], h, dtype, quant)
    return x + (0.5 * h if half_step else h)


def convmod_apply(p, x: torch.Tensor, mask: torch.Tensor,
                  dtype=torch.bfloat16,
                  quant: Optional[str] = None) -> torch.Tensor:
    """Pointwise GLU -> depthwise conv over time -> LN -> SiLU -> pointwise,
    the plain (unfused) path of the reference."""
    B, T, D = x.shape
    h = layernorm_apply(p["ln"], x)
    h = dense_apply(p["pw1"], h, dtype, quant)
    a, g = h[..., :D], h[..., D:]
    h = a * torch.sigmoid(g)
    h = torch.where(mask[:, :, None], h, torch.zeros_like(h))
    kernel = p["dw"].to(torch.float32)            # [K, D]
    K = kernel.shape[0]
    pad_l = (K - 1) // 2
    hp = torch.nn.functional.pad(h.transpose(1, 2), (pad_l, K - 1 - pad_l))
    out = torch.nn.functional.conv1d(
        hp, kernel.t().unsqueeze(1), groups=D).transpose(1, 2)
    out = layernorm_apply(p["dw_ln"], out)
    out = torch.nn.functional.silu(out)
    out = dense_apply(p["pw2"], out, dtype, quant)
    return x + out
