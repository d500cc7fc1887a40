"""Conformer encoder and multi-task heads.

The PyTorch port of ``omnilingual_asr_tpu/models/conformer.py``:

    log-mel [B, T, n_mels]
      -> frame-stacking subsampler (x4)
      -> N conformer blocks (FFN half-step / MHSA+RoPE / conv module / FFN)
      -> heads: ctc [B, T', vocab], lid [B, T', 2048], emotion [B, T', 4],
         speaker frames [B, T', 256]

``encoder.use_flash_attention`` routes attention through kernels K2 (and
K6/K7 in the backward) and ``encoder.use_fused_conv`` the conv module
through kernel K3, as the JAX engine's inference config and the trainer's
kernel mode do. Training adds residual-stream dropout and per-block
rematerialisation (``encoder.remat``). With ``encoder.n_experts > 0`` each
block's second FFN is a mixture of experts (``models/moe.py``): dense
dispatch, or with ``encoder.moe_dispatch="alltoall"`` and a mesh whose
``model`` axis is above 1, the all-to-all dispatch of
``parallel/expert_dispatch.py``.

Tensor parallelism (serving): :func:`asr_param_specs` places the tree on
a (data, model) mesh as the reference's does, :func:`shard_for_tp` cuts
it into one tree per model shard, and :func:`tp_asr_forward` runs the
forward over those trees (``parallel/tensor.py``'s column- and
row-parallel layers, K2 on each shard's heads, K3 split over channels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..config import EncoderConfig, PipelineConfig
from ..ops.conv_module import convmod_apply_fused, tp_convmod_apply_fused
from ..parallel import tensor as tp
from ..parallel.mesh import AXIS_MODEL, Split, all_gather, gather, replicate
from . import layers as L
from .moe import moe_ffn_apply, moe_ffn_init, moe_ffn_shapes, moe_ffn_spec

# Head dimensions (as the JAX package's).
N_LANGS = 2048
N_EMOTIONS = 4
SPK_DIM = 256
N_SPEAKER_CLASSES = 1024


def compute_dtype(enc: EncoderConfig) -> torch.dtype:
    if enc.dtype != "bfloat16":
        raise NotImplementedError(
            f"encoder dtype {enc.dtype!r} is not ported (bfloat16 only; "
            f"A14 in ROADMAP.md, Queue A)")
    return torch.bfloat16


def _dense_shapes(i: int, o: int, bias: bool = True):
    return {"w": (i, o), "b": (o,)} if bias else {"w": (i, o)}


def _ln_shapes(d: int):
    return {"scale": (d,), "bias": (d,)}


def asr_param_shapes(cfg: PipelineConfig):
    """Shape tree of the ASR parameters (the port's counterpart of
    ``jax.eval_shape(asr_init)``)."""
    enc = cfg.encoder
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
        "ffn2": (moe_ffn_shapes(d, enc.n_experts, enc.ffn_mult)
                 if enc.n_experts > 0 else ffn()),
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


def conformer_block_init(gen: torch.Generator, enc: EncoderConfig):
    return {
        "ffn1": L.ffn_init(gen, enc.d_model, enc.ffn_mult),
        "mhsa": L.mhsa_init(gen, enc.d_model),
        "conv": L.convmod_init(gen, enc.d_model, enc.conv_kernel),
        "ffn2": (moe_ffn_init(gen, enc.d_model, enc.n_experts, enc.ffn_mult)
                 if enc.n_experts > 0
                 else L.ffn_init(gen, enc.d_model, enc.ffn_mult)),
        "ln_out": L.layernorm_init(enc.d_model),
    }


def _unit_columns(gen: torch.Generator, shape) -> torch.Tensor:
    w = torch.randn(shape, generator=gen)
    return w / w.norm(dim=0, keepdim=True)


def asr_init(gen: torch.Generator, cfg: PipelineConfig):
    """Random ASR parameters (CPU f32) with the tree of
    :func:`asr_param_shapes`, drawn from ``gen`` as the reference's
    ``asr_init`` draws them (speaker AAM classes: unit columns)."""
    enc = cfg.encoder
    d, sub = enc.d_model, enc.subsample_factor
    return {
        "subsample": L.dense_init(gen, sub * cfg.frontend.n_mels, d),
        "in_ln": L.layernorm_init(d),
        "blocks": [conformer_block_init(gen, enc)
                   for _ in range(enc.n_layers)],
        "ctc_head": L.dense_init(gen, d, cfg.vocab.vocab_size),
        "lid_head": L.dense_init(gen, d, N_LANGS),
        "emotion_head": L.dense_init(gen, d, N_EMOTIONS),
        "speaker_head": L.dense_init(gen, d, SPK_DIM),
        "spk_head2": L.dense_init(gen, SPK_DIM, SPK_DIM),
        "spk_proj": L.dense_init(gen, 2 * SPK_DIM, SPK_DIM),
        "spk_aam": _unit_columns(gen, (SPK_DIM, N_SPEAKER_CLASSES)),
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
                          quant: Optional[str] = None, mesh=None):
    """One conformer block -> (x, moe_aux). ``quant`` is the
    quantized-kernel mode of ``layers.dense_apply``. moe_aux is the block's
    Switch load-balance loss: 0 without experts and under all-to-all
    dispatch, as in the reference. The experts compute in f32 whatever
    ``dtype`` is (the reference's default)."""
    aux = torch.zeros((), device=x.device)
    x = L.ffn_apply(p["ffn1"], x, dtype, quant=quant)
    x = L.mhsa_apply(p["mhsa"], x, enc.n_heads, mask, cos, sin, dtype,
                     use_flash=enc.use_flash_attention, quant=quant)
    if enc.use_fused_conv:
        x = convmod_apply_fused(p["conv"], x, mask)
    else:
        x = L.convmod_apply(p["conv"], x, mask, dtype, quant=quant)
    if enc.n_experts > 0:
        if (enc.moe_dispatch == "alltoall" and mesh is not None
                and mesh.shape.get("model", 1) > 1):
            from ..parallel.expert_dispatch import ep_moe_apply

            B, T, D = x.shape
            data_axis = "data" if mesh.shape.get("data", 1) > 1 else None
            x = ep_moe_apply(p["ffn2"], x.reshape(B * T, D), mesh,
                             capacity_factor=enc.moe_capacity_factor,
                             data_axis=data_axis).reshape(B, T, D)
        else:
            x, aux = moe_ffn_apply(p["ffn2"], x)
    else:
        x = L.ffn_apply(p["ffn2"], x, dtype, quant=quant)
    return L.layernorm_apply(p["ln_out"], x), aux


def dropout(x: torch.Tensor, rate: float, seed: int,
            salt: int) -> torch.Tensor:
    """Inverted element-wise dropout with a generator of its own per
    (seed, salt), as the reference folds a salt into its step key: each
    element is kept with probability 1 - rate and scaled by 1/(1 - rate).
    The bits differ from ``jax.random``'s."""
    gen = torch.Generator(device=x.device).manual_seed(
        (seed * 1_000_003 + salt) % (2 ** 63))
    keep = 1.0 - rate
    hit = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(hit, x / keep, torch.zeros_like(x))


def asr_forward(params, mel: torch.Tensor, mask: torch.Tensor,
                cfg: PipelineConfig, quant: Optional[str] = None,
                dropout_seed: Optional[int] = None, mesh=None):
    """Forward pass, for serving and for training.

    mel [B, T, n_mels] f32 (T a multiple of the subsample factor); mask
    [B, T] bool. Returns the JAX package's output dict: ctc/lid/emotion
    logits, speaker frames and L2-normalised embeddings, encoder states,
    the subsampled mask and ``moe_aux`` (the blocks' summed load-balance
    loss; 0 without experts). ``mesh`` serves the all-to-all expert
    dispatch (``encoder.moe_dispatch="alltoall"``). ``params`` may
    hold quantized dense leaves (``ops/quant.py::quantize_param_tree``);
    ``quant`` (None, "w8" or "a8") routes those the kernels take through K4
    or K5, as the JAX engine's ``set_quant_kernel`` mode does.

    ``dropout_seed`` (training only): with ``encoder.dropout > 0``, dropout
    on the residual stream after the input LayerNorm (salt 0) and after
    each block (salt ``i + 1``), as the reference's ``dropout_rng`` hook.
    ``encoder.remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``) when gradients are being taken.
    """
    enc = cfg.encoder
    dtype = compute_dtype(enc)
    sub = enc.subsample_factor
    rate = enc.dropout if dropout_seed is not None else 0.0

    def drop(x, salt):
        return dropout(x, rate, dropout_seed, salt) if rate > 0.0 else x

    x = subsample_frames(mel, sub)
    m = subsampled_mask(mask, sub)
    x = L.dense_apply(params["subsample"], x, dtype, quant)
    x = L.layernorm_apply(params["in_ln"], x)
    x = drop(x, 0)
    cos, sin = L.rope_angles(x.shape[1], enc.head_dim, device=x.device)
    remat = enc.remat and torch.is_grad_enabled()
    moe_aux = torch.zeros((), device=x.device)
    for bi, blk in enumerate(params["blocks"]):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                conformer_block_apply, blk, x, m, cos, sin, enc, dtype,
                quant, mesh, use_reentrant=False)
        else:
            x, aux = conformer_block_apply(blk, x, m, cos, sin, enc, dtype,
                                           quant, mesh)
        x = drop(x, bi + 1)
        moe_aux = moe_aux + aux
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
        "moe_aux": moe_aux,
    }


# ---------------------------------------------------------------------------
# Tensor parallelism (serving)
# ---------------------------------------------------------------------------

def conformer_block_spec(enc: EncoderConfig):
    return {"ffn1": L.ffn_spec(), "mhsa": L.mhsa_spec(),
            "conv": L.convmod_spec(),
            "ffn2": moe_ffn_spec() if enc.n_experts > 0 else L.ffn_spec(),
            "ln_out": L.layernorm_spec()}


def asr_param_specs(cfg: PipelineConfig):
    """The placement of :func:`asr_init`'s tree on a (data, model) mesh
    (the reference's ``asr_param_specs``; replicated over ``data``). Two
    leaves differ from the reference's: pw1's value and gate halves are
    each split (``layers.convmod_spec``), and the CTC head is replicated:
    its 1 + 256 columns split evenly over no model axis above 1, where the
    reference's GSPMD pads them; the result is the same."""
    enc = cfg.encoder
    rep = L.dense_spec(None, None)
    return {
        "subsample": L.dense_spec(None, AXIS_MODEL),
        "in_ln": L.layernorm_spec(),
        "blocks": [conformer_block_spec(enc) for _ in range(enc.n_layers)],
        "ctc_head": rep,
        "lid_head": L.dense_spec(None, AXIS_MODEL),
        "emotion_head": rep, "speaker_head": rep, "spk_head2": rep,
        "spk_proj": rep, "spk_aam": None,
    }


def asr_output_specs():
    """How :func:`tp_asr_forward` makes each head's logits (the
    reference's ``activation_specs()["out"]`` within one data row): split
    by columns over the model axis, each shard its block, then gathered
    (as its head is placed by :func:`asr_param_specs`), or computed once,
    on model shard 0, from a replicated head. The speaker frames and
    embedding, the encoder states and the mask come from shard 0."""
    return {"ctc_logits": None, "lid_logits": Split(AXIS_MODEL, 2),
            "emotion_logits": None}


def check_tp_dims(cfg: PipelineConfig, n: int) -> None:
    """ValueError unless a model axis of ``n`` splits every dimension that
    tensor parallelism splits."""
    enc = cfg.encoder
    dims = {"n_heads": enc.n_heads, "d_model": enc.d_model,
            "FFN width": enc.d_model * enc.ffn_mult, "LID classes": N_LANGS}
    if enc.n_experts > 0:
        dims["n_experts"] = enc.n_experts
    bad = {k: v for k, v in dims.items() if v % n}
    if bad:
        raise ValueError(f"a model axis of {n} does not divide {bad}")


def shard_for_tp(params, cfg: PipelineConfig, devices, specs=None):
    """One parameter tree per model shard on ``devices`` (one data row)
    under :func:`asr_param_specs` (or ``specs``: a quantized tree takes
    ``ops.quant.quantize_spec_tree`` of them). ``params`` is the full tree,
    the port's or the JAX package's as numpy arrays."""
    check_tp_dims(cfg, len(devices))
    return tp.shard_trees(params, specs or asr_param_specs(cfg), devices)


def tp_conformer_block_apply(ps, xs, masks, cos, sin, enc: EncoderConfig,
                             dtype):
    """One conformer block over the model shards' trees ``ps`` and
    replicated activations ``xs`` -> (xs, moe_aux)."""
    aux = torch.zeros((), device=xs[0].device)
    xs = tp.tp_ffn_apply([p["ffn1"] for p in ps], xs, dtype)
    xs = tp.tp_mhsa_apply([p["mhsa"] for p in ps], xs, enc.n_heads, masks,
                          cos, sin, dtype, use_flash=enc.use_flash_attention)
    convs = [p["conv"] for p in ps]
    xs = (tp_convmod_apply_fused(convs, xs, masks) if enc.use_fused_conv
          else tp.tp_convmod_apply(convs, xs, masks, dtype))
    ffn2 = [p["ffn2"] for p in ps]
    if enc.n_experts > 0:
        if enc.moe_dispatch == "alltoall" and len(ps) > 1:
            xs = tp.tp_moe_alltoall(ffn2, xs, enc.moe_capacity_factor)
        else:
            xs, aux = tp.tp_moe_dense(ffn2, xs)
    else:
        xs = tp.tp_ffn_apply(ffn2, xs, dtype)
    xs = tp.per_copy(lambda x, p: L.layernorm_apply(p["ln_out"], x), xs, ps)
    return xs, aux


def tp_asr_forward(shards, mel: torch.Tensor, mask: torch.Tensor,
                   cfg: PipelineConfig):
    """:func:`asr_forward` (serving) over the model shards of one data
    row: ``shards`` from :func:`shard_for_tp`, shard m's tree on its
    device; mel and mask on shard 0's device. The mel goes to every
    shard's device; the subsampler and the LID head are column-parallel
    and gathered, the blocks run on ``parallel/tensor.py``'s layers (K2 on
    each shard's heads, K3 split over channels under the encoder's flags),
    and the replicated heads run once, on shard 0. Returns
    :func:`asr_forward`'s dict on shard 0's device. Under tensor
    parallelism the int8 kernel modes do not run (the reference's rule):
    a quantized tree dequantizes into the bf16 products."""
    enc = cfg.encoder
    n = len(shards)
    check_tp_dims(cfg, n)
    dtype = compute_dtype(enc)
    sub = enc.subsample_factor
    devices = [_tree_device(s) for s in shards]
    frames = tp.per_copy(lambda m: subsample_frames(m, sub),
                         replicate(mel, devices))
    m_sub = subsampled_mask(mask, sub)
    masks = replicate(m_sub, devices)
    xs = all_gather(tp.column_dense([s["subsample"] for s in shards],
                                    frames, dtype), dim=-1)
    xs = tp.per_copy(lambda x, s: L.layernorm_apply(s["in_ln"], x), xs,
                     shards)
    rope = tp.per_copy(lambda x: L.rope_angles(x.shape[1], enc.head_dim,
                                               device=x.device), xs)
    cos = [r[0] for r in rope]
    sin = [r[1] for r in rope]
    moe_aux = torch.zeros((), device=mel.device)
    for bi in range(enc.n_layers):
        xs, aux = tp_conformer_block_apply(
            [s["blocks"][bi] for s in shards], xs, masks, cos, sin, enc,
            dtype)
        moe_aux = moe_aux + aux.to(mel.device)
    x, p0 = xs[0], shards[0]
    out = {}
    for key, spec in asr_output_specs().items():
        head = key.split("_")[0] + "_head"
        out[key] = (L.dense_apply(p0[head], x, dtype) if spec is None
                    else gather(tp.column_dense([s[head] for s in shards],
                                                xs, dtype),
                                dim=spec.dim, device=x.device))
    h = torch.relu(L.dense_apply(p0["speaker_head"], x, dtype))
    spk_frames = L.dense_apply(p0["spk_head2"], h, dtype)
    spk = spk_frames * torch.rsqrt(
        (spk_frames * spk_frames).sum(dim=-1, keepdim=True) + 1e-8)
    return {**out, "speaker_frames": spk_frames, "speaker_embed": spk,
            "encoder_states": x, "mask": m_sub, "moe_aux": moe_aux}


def _tree_device(tree) -> torch.device:
    """The device of a shard's tree (that of its subsampler weight)."""
    sub = tree["subsample"]
    return (sub.get("w", sub.get("w_q"))).device


def pooled_speaker_embed(params, frames: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Statistics-pooled speaker embedding (differentiable), L2-normalised.

    frames [..., T, SPK_DIM] (``speaker_frames``); weights [..., T]
    nonnegative pooling weights. Returns [..., SPK_DIM]."""
    w = weights[..., None].to(torch.float32)
    denom = torch.clamp(w.sum(dim=-2), min=1e-6)
    mean = (frames * w).sum(dim=-2) / denom
    var = (w * (frames - mean[..., None, :]) ** 2).sum(dim=-2) / denom
    std = torch.sqrt(var + 1e-6)
    e = L.dense_apply(params["spk_proj"], torch.cat([mean, std], dim=-1))
    return e * torch.rsqrt((e * e).sum(dim=-1, keepdim=True) + 1e-8)


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
