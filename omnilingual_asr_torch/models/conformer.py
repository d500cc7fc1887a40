"""Conformer encoder and multi-task heads.

The PyTorch port of the inference half of
``omnilingual_asr_tpu/models/conformer.py``:

    log-mel [B, T, n_mels]
      -> frame-stacking subsampler (x4)
      -> N conformer blocks (FFN half-step / MHSA+RoPE / conv module / FFN)
      -> heads: ctc [B, T', vocab], lid [B, T', 2048], emotion [B, T', 4],
         speaker frames [B, T', 256]

``encoder.use_flash_attention`` routes attention through kernel K2 and
``encoder.use_fused_conv`` the conv module through kernel K3, as the JAX
engine's inference config does. Mixture-of-experts FFNs, remat and dropout
are training or multi-chip features of the JAX package and are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import EncoderConfig, PipelineConfig
from ..ops.conv_module import convmod_apply_fused
from . import layers as L

# Head dimensions (as the JAX package's).
N_LANGS = 2048
N_EMOTIONS = 4
SPK_DIM = 256
N_SPEAKER_CLASSES = 1024


def compute_dtype(enc: EncoderConfig) -> torch.dtype:
    if enc.dtype != "bfloat16":
        raise NotImplementedError(
            f"encoder dtype {enc.dtype!r} is not ported (bfloat16 only)")
    return torch.bfloat16


def _dense_shapes(i: int, o: int, bias: bool = True):
    return {"w": (i, o), "b": (o,)} if bias else {"w": (i, o)}


def _ln_shapes(d: int):
    return {"scale": (d,), "bias": (d,)}


def asr_param_shapes(cfg: PipelineConfig):
    """Shape tree of the ASR parameters (the port's counterpart of
    ``jax.eval_shape(asr_init)``)."""
    enc = cfg.encoder
    if enc.n_experts > 0:
        raise NotImplementedError("mixture-of-experts FFNs are not ported "
                                  "(ROADMAP Queue A item 10)")
    d, f = enc.d_model, enc.d_model * enc.ffn_mult

    def ffn():
        return {"ln": _ln_shapes(d), "w1": _dense_shapes(d, f),
                "w2": _dense_shapes(f, d)}

    block = {
        "ffn1": ffn(),
        "mhsa": {"ln": _ln_shapes(d),
                 **{n: _dense_shapes(d, d, False)
                    for n in ("wq", "wk", "wv", "wo")}},
        "conv": {"ln": _ln_shapes(d), "pw1": _dense_shapes(d, 2 * d, False),
                 "dw": (enc.conv_kernel, d), "dw_ln": _ln_shapes(d),
                 "pw2": _dense_shapes(d, d, False)},
        "ffn2": ffn(),
        "ln_out": _ln_shapes(d),
    }
    return {
        "subsample": _dense_shapes(enc.subsample_factor * cfg.frontend.n_mels,
                                   d),
        "in_ln": _ln_shapes(d),
        "blocks": [block for _ in range(enc.n_layers)],
        "ctc_head": _dense_shapes(d, cfg.vocab.vocab_size),
        "lid_head": _dense_shapes(d, N_LANGS),
        "emotion_head": _dense_shapes(d, N_EMOTIONS),
        "speaker_head": _dense_shapes(d, SPK_DIM),
        "spk_head2": _dense_shapes(SPK_DIM, SPK_DIM),
        "spk_proj": _dense_shapes(2 * SPK_DIM, SPK_DIM),
        "spk_aam": (SPK_DIM, N_SPEAKER_CLASSES),
    }


def subsample_frames(mel: torch.Tensor, sub: int) -> torch.Tensor:
    """[B, T, F] -> [B, T // sub, sub * F] by frame stacking."""
    B, T, F = mel.shape
    return mel.reshape(B, T // sub, sub * F)


def subsampled_mask(mask: torch.Tensor, sub: int) -> torch.Tensor:
    """[B, T] -> [B, T // sub]: a stacked frame is valid iff its first
    source frame is valid."""
    B, T = mask.shape
    return mask.reshape(B, T // sub, sub)[:, :, 0]


def conformer_block_apply(p, x, mask, cos, sin, enc: EncoderConfig, dtype,
                          quant: Optional[str] = None):
    """One conformer block. ``quant`` is the quantized-kernel mode of
    ``layers.dense_apply``."""
    x = L.ffn_apply(p["ffn1"], x, dtype, quant=quant)
    x = L.mhsa_apply(p["mhsa"], x, enc.n_heads, mask, cos, sin, dtype,
                     use_flash=enc.use_flash_attention, quant=quant)
    if enc.use_fused_conv:
        x = convmod_apply_fused(p["conv"], x, mask)
    else:
        x = L.convmod_apply(p["conv"], x, mask, dtype, quant=quant)
    x = L.ffn_apply(p["ffn2"], x, dtype, quant=quant)
    return L.layernorm_apply(p["ln_out"], x)


def asr_forward(params, mel: torch.Tensor, mask: torch.Tensor,
                cfg: PipelineConfig, quant: Optional[str] = None):
    """Inference forward pass.

    mel [B, T, n_mels] f32 (T a multiple of the subsample factor); mask
    [B, T] bool. Returns the JAX package's output dict: ctc/lid/emotion
    logits, speaker frames and L2-normalised embeddings, encoder states and
    the subsampled mask. ``params`` may hold quantized dense leaves
    (``ops/quant.py::quantize_param_tree``); ``quant`` (None, "w8" or "a8")
    routes those the kernels take through K4 or K5, as the JAX engine's
    ``set_quant_kernel`` mode does.
    """
    enc = cfg.encoder
    if enc.n_experts > 0:
        raise NotImplementedError("mixture-of-experts FFNs are not ported "
                                  "(ROADMAP Queue A item 10)")
    dtype = compute_dtype(enc)
    sub = enc.subsample_factor
    x = subsample_frames(mel, sub)
    m = subsampled_mask(mask, sub)
    x = L.dense_apply(params["subsample"], x, dtype, quant)
    x = L.layernorm_apply(params["in_ln"], x)
    cos, sin = L.rope_angles(x.shape[1], enc.head_dim, device=x.device)
    for blk in params["blocks"]:
        x = conformer_block_apply(blk, x, m, cos, sin, enc, dtype, quant)
    ctc = L.dense_apply(params["ctc_head"], x, dtype, quant)
    lid = L.dense_apply(params["lid_head"], x, dtype, quant)
    emo = L.dense_apply(params["emotion_head"], x, dtype, quant)
    h = torch.relu(L.dense_apply(params["speaker_head"], x, dtype, quant))
    spk_frames = L.dense_apply(params["spk_head2"], h, dtype, quant)
    spk = spk_frames * torch.rsqrt(
        (spk_frames * spk_frames).sum(dim=-1, keepdim=True) + 1e-8)
    return {
        "ctc_logits": ctc,
        "lid_logits": lid,
        "emotion_logits": emo,
        "speaker_frames": spk_frames,
        "speaker_embed": spk,
        "encoder_states": x,
        "mask": m,
    }


def pooled_speaker_embed_np(params, frames: np.ndarray,
                            weights: np.ndarray) -> np.ndarray:
    """Host-side statistics-pooled speaker embedding (numpy), L2-normalised.

    params holds ``spk_proj`` as numpy arrays ``{"w", "b"}``."""
    w = np.asarray(weights, np.float32)[..., None]
    f = np.asarray(frames, np.float32)
    denom = np.maximum(w.sum(axis=-2), 1e-6)
    mean = (f * w).sum(axis=-2) / denom
    var = (w * (f - mean[..., None, :]) ** 2).sum(axis=-2) / denom
    std = np.sqrt(var + 1e-6)
    pooled = np.concatenate([mean, std], axis=-1)
    proj = params["spk_proj"]
    e = pooled @ np.asarray(proj["w"], np.float32) + np.asarray(
        proj["b"], np.float32)
    return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-8)
