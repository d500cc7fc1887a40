"""X->English translation decoder, its training half.

The PyTorch port of the teacher-forced half of
``omnilingual_asr_tpu/models/translation.py``: a byte-level transformer
decoder (causal self-attention, cross-attention into the shared conformer
encoder states, FFN) that the synthetic-corpus trainer trains jointly with
the encoder, and its ``.npz`` save/load in the release's keystr layout.
Greedy decoding and the text-mode translator are serving features and are
not ported yet (A6 in ROADMAP.md).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from . import layers as L

MAX_TARGET_LEN = 256  # bytes per segment translation
N_LAYERS = 4


def decoder_block_init(gen: torch.Generator, d_model: int):
    return {
        "ln1": L.layernorm_init(d_model),
        "self_qkv": L.dense_init(gen, d_model, 3 * d_model, use_bias=False),
        "self_o": L.dense_init(gen, d_model, d_model, use_bias=False),
        "ln2": L.layernorm_init(d_model),
        "cross_q": L.dense_init(gen, d_model, d_model, use_bias=False),
        "cross_kv": L.dense_init(gen, d_model, 2 * d_model, use_bias=False),
        "cross_o": L.dense_init(gen, d_model, d_model, use_bias=False),
        "ffn": L.ffn_init(gen, d_model, 4),
    }


def translator_init(gen: torch.Generator, cfg: PipelineConfig,
                    n_layers: int = N_LAYERS):
    """Random decoder parameters (CPU f32): embeddings N(0, 0.02^2), a
    zero learned position table, and the reference's dense init."""
    d = cfg.encoder.d_model
    v = cfg.vocab.vocab_size
    return {
        "embed": torch.randn((v, d), generator=gen) * 0.02,
        "pos": torch.zeros((MAX_TARGET_LEN, d)),
        "blocks": [decoder_block_init(gen, d) for _ in range(n_layers)],
        "ln_out": L.layernorm_init(d),
        "out": L.dense_init(gen, d, v),
    }


def translator_param_shapes(cfg: PipelineConfig, n_layers: int = N_LAYERS):
    """Shape tree of :func:`translator_init`."""
    d, v = cfg.encoder.d_model, cfg.vocab.vocab_size
    ln = {"scale": (d,), "bias": (d,)}
    block = {
        "ln1": ln, "self_qkv": {"w": (d, 3 * d)}, "self_o": {"w": (d, d)},
        "ln2": ln, "cross_q": {"w": (d, d)}, "cross_kv": {"w": (d, 2 * d)},
        "cross_o": {"w": (d, d)},
        "ffn": {"ln": ln, "w1": {"w": (d, 4 * d), "b": (4 * d,)},
                "w2": {"w": (4 * d, d), "b": (d,)}},
    }
    return {"embed": (v, d), "pos": (MAX_TARGET_LEN, d),
            "blocks": [block for _ in range(n_layers)], "ln_out": ln,
            "out": {"w": (d, v), "b": (v,)}}


def _attend(q, k, v, mask, n_heads: int):
    """q [B, Tq, D], k/v [B, Tk, D], mask [B, Tq, Tk] bool; f32 softmax."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    hd = D // n_heads
    qh = q.reshape(B, Tq, n_heads, hd)
    kh = k.reshape(B, Tk, n_heads, hd)
    vh = v.reshape(B, Tk, n_heads, hd)
    logits = torch.einsum("bthd,bshd->bhts", qh, kh) / math.sqrt(hd)
    logits = torch.where(mask[:, None, :, :], logits,
                         torch.full_like(logits, -1e30))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", attn, vh)
    return out.reshape(B, Tq, D)


def decoder_forward(params, tokens: torch.Tensor, enc: torch.Tensor,
                    enc_mask: torch.Tensor, cfg: PipelineConfig,
                    n_heads: Optional[int] = None) -> torch.Tensor:
    """Teacher-forced forward: tokens [B, Tt] -> logits [B, Tt, V] f32."""
    if n_heads is None:
        n_heads = cfg.encoder.n_heads
    B, Tt = tokens.shape
    x = params["embed"][tokens.to(torch.long)]
    if "pos" in params:
        x = x + params["pos"][:Tt][None, :, :]
    pos = torch.arange(Tt, device=tokens.device)
    causal = (pos[None, :, None] >= pos[None, None, :]).expand(B, Tt, Tt)
    cross_mask = enc_mask[:, None, :].expand(B, Tt, enc_mask.shape[1])
    for blk in params["blocks"]:
        h = L.layernorm_apply(blk["ln1"], x)
        q, k, v = L.dense_apply(blk["self_qkv"], h).chunk(3, dim=-1)
        x = x + L.dense_apply(blk["self_o"], _attend(q, k, v, causal,
                                                     n_heads))
        h = L.layernorm_apply(blk["ln2"], x)
        cq = L.dense_apply(blk["cross_q"], h)
        ck, cv = L.dense_apply(blk["cross_kv"], enc).chunk(2, dim=-1)
        x = x + L.dense_apply(blk["cross_o"],
                              _attend(cq, ck, cv, cross_mask, n_heads))
        x = L.ffn_apply(blk["ffn"], x, half_step=False)
    x = L.layernorm_apply(params["ln_out"], x)
    return L.dense_apply(params["out"], x)


def save_translator(path, params) -> None:
    """Write decoder parameters as one f32 ``.npz`` in the release's keystr
    layout (``models/zoo.py::save_checkpoint``)."""
    from .zoo import save_checkpoint

    save_checkpoint(path, params)


def load_translator(path, cfg: PipelineConfig, n_layers: int = N_LAYERS,
                    device="cpu"):
    """Load decoder parameters saved by :func:`save_translator` (or a JAX
    release ``.npz`` of the audio-conditioned decoder). A checkpoint from
    before the learned position table gets a zero table, which reproduces
    its forward exactly, as the reference's loader does."""
    from .zoo import load_release

    path = Path(path)
    if path.suffix != ".npz":
        raise NotImplementedError(
            f"{path}: only .npz translator checkpoints load in the port "
            f"(Orbax checkpoints need JAX)")
    with np.load(path) as z:
        files = set(z.files)
    if any(k.startswith("['src']") for k in files):
        raise NotImplementedError(
            f"{path} holds the text-mode translator, which is not ported "
            f"yet (A6 in ROADMAP.md)")
    shapes = translator_param_shapes(cfg, n_layers)
    has_pos = "['pos']" in files
    if not has_pos:
        shapes.pop("pos")
    params = load_release(path, shapes, device)
    if not has_pos:
        params["pos"] = torch.zeros((MAX_TARGET_LEN, cfg.encoder.d_model),
                                    device=device)
    return params
