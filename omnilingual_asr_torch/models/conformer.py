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

Tensor parallelism: :func:`asr_param_specs` places the tree on a (data,
model) mesh as the reference's does, :func:`shard_for_tp` cuts it into
one tree per model shard, and :func:`tp_asr_forward` runs the forward
over those trees (``parallel/tensor.py``'s column- and row-parallel
layers, K2 on each shard's heads, K3 split over channels), for serving
and, differentiable and with dropout, for training;
:func:`mesh_asr_forward` runs it over every data row of a mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..config import EncoderConfig, PipelineConfig
from ..ops.conv_module import convmod_apply_fused, tp_convmod_apply_fused
from ..parallel import tensor as tp
from ..parallel.mesh import (AXIS_MODEL, Split, all_gather, block_of,
                             gather, process_all_reduce, replicate, scatter,
                             to_device)
from . import layers as L
from .moe import (load_balance_from_sums, moe_ffn_apply, moe_ffn_init,
                  moe_ffn_shapes, moe_ffn_spec)

# Head dimensions (as the JAX package's).
N_LANGS = 2048
N_EMOTIONS = 4
SPK_DIM = 256
N_SPEAKER_CLASSES = 1024


#: The encoder's compute dtypes that the port runs, by config name.
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                  "float16": torch.float16}


def compute_dtype(enc: EncoderConfig) -> torch.dtype:
    """The dtype the encoder's products round their operands to (the
    reference's ``jnp.dtype(enc.dtype)``): bf16; f32, where every dense
    product is an exact f32 product and attention takes the f32 flash
    kernels; or f16, where attention takes the f16 flash kernels. Kernel
    K3 computes its products in bf16 at every dtype, as the reference's
    does. Another name raises ValueError."""
    if enc.dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"encoder dtype {enc.dtype!r} is not a compute dtype (one of "
            f"{sorted(COMPUTE_DTYPES)})")
    return COMPUTE_DTYPES[enc.dtype]


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
    return apply_dropout(x, dropout_mask(x.shape, rate, seed, salt,
                                         x.device), rate)


def dropout_mask(shape, rate: float, seed: int, salt: int,
                 device) -> torch.Tensor:
    """The kept elements of :func:`dropout` over ``shape`` (bool), drawn
    on ``device``. A mesh draws it over the global batch's shape on one
    device and hands each data row its rows, so that the mesh keeps the
    elements one device keeps."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + salt) % (2 ** 63))
    return torch.rand(tuple(shape), generator=gen, device=device) \
        < 1.0 - rate


def apply_dropout(x: torch.Tensor, hit: torch.Tensor,
                  rate: float) -> torch.Tensor:
    keep = 1.0 - rate
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
# Tensor parallelism
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
                             dtype, dense_experts: bool = False):
    """One conformer block over the model shards' trees ``ps`` and
    replicated activations ``xs`` -> (xs, routing): with experts under
    dense dispatch, ``routing`` is the block's ``models.moe.routing_sums``
    over these rows, else None. ``dense_experts`` dispatches densely
    whatever ``encoder.moe_dispatch`` says (training: the reference's
    loss runs ``asr_forward`` with no mesh, so the all-to-all path only
    serves)."""
    routing = None
    xs = tp.tp_ffn_apply([p["ffn1"] for p in ps], xs, dtype)
    xs = tp.tp_mhsa_apply([p["mhsa"] for p in ps], xs, enc.n_heads, masks,
                          cos, sin, dtype, use_flash=enc.use_flash_attention)
    convs = [p["conv"] for p in ps]
    xs = (tp_convmod_apply_fused(convs, xs, masks) if enc.use_fused_conv
          else tp.tp_convmod_apply(convs, xs, masks, dtype))
    ffn2 = [p["ffn2"] for p in ps]
    if enc.n_experts > 0:
        if (enc.moe_dispatch == "alltoall" and len(ps) > 1
                and not dense_experts):
            xs = tp.tp_moe_alltoall(ffn2, xs, enc.moe_capacity_factor)
        else:
            xs, routing = tp.tp_moe_dense(ffn2, xs)
    else:
        xs = tp.tp_ffn_apply(ffn2, xs, dtype)
    xs = tp.per_copy(lambda x, p: L.layernorm_apply(p["ln_out"], x), xs, ps)
    return xs, routing


def tp_asr_forward(shards, mel: torch.Tensor, mask: torch.Tensor,
                   cfg: PipelineConfig, dropout_keep=None,
                   dense_experts: bool = False):
    """:func:`asr_forward` over the model shards of one data row:
    ``shards`` from :func:`shard_for_tp` (or a training
    ``parallel.tensor.MeshParams`` row), shard m's tree on its device; mel
    and mask on shard 0's device. The mel goes to every shard's device;
    the subsampler and the LID head are column-parallel and gathered, the
    blocks run on ``parallel/tensor.py``'s layers (K2 on each shard's
    heads, K3 split over channels under the encoder's flags), and the
    replicated heads run once, on shard 0. Returns :func:`asr_forward`'s
    dict on shard 0's device. Under tensor parallelism the int8 kernel
    modes do not run (the reference's rule): a quantized tree dequantizes
    into the bf16 products.

    Training: the layers are differentiable (K3's split through
    ``ops.conv_module.FusedConvModuleSplit``, K2 with K6/K7 through
    ``FlashAttention``), ``encoder.remat`` recomputes each block in the
    backward pass, and ``dropout_keep`` (the row's kept elements of salts
    0 .. n_layers, :func:`dropout_mask`'s) applies :func:`asr_forward`'s
    residual dropout at the same places. With experts the blocks dispatch
    densely under ``dense_experts`` (training) whatever
    ``encoder.moe_dispatch`` says; under dense dispatch the dict also
    holds ``moe_routing``, each block's ``models.moe.routing_sums`` over
    this row on shard 0's device, and ``moe_aux`` is this row's
    load-balance term (:func:`mesh_asr_forward`'s caller combines the rows'
    sums into the whole batch's)."""
    enc = cfg.encoder
    n = len(shards)
    check_tp_dims(cfg, n)
    dtype = compute_dtype(enc)
    sub = enc.subsample_factor
    devices = [_tree_device(s) for s in shards]

    def drop(xs, salt):
        if dropout_keep is None:
            return xs
        hits = replicate(dropout_keep[salt], devices)
        return tp.per_copy(lambda x, h: apply_dropout(x, h, enc.dropout),
                           xs, hits)

    frames = tp.per_copy(lambda m: subsample_frames(m, sub),
                         replicate(mel, devices))
    m_sub = subsampled_mask(mask, sub)
    masks = replicate(m_sub, devices)
    xs = all_gather(tp.column_dense([s["subsample"] for s in shards],
                                    frames, dtype), dim=-1)
    xs = tp.per_copy(lambda x, s: L.layernorm_apply(s["in_ln"], x), xs,
                     shards)
    xs = drop(xs, 0)
    rope = tp.per_copy(lambda x: L.rope_angles(x.shape[1], enc.head_dim,
                                               device=x.device), xs)
    cos = [r[0] for r in rope]
    sin = [r[1] for r in rope]
    remat = enc.remat and torch.is_grad_enabled()
    moe_aux = torch.zeros((), device=mel.device)
    moe_routing = []
    for bi in range(enc.n_layers):
        blocks = [s["blocks"][bi] for s in shards]
        if remat:
            xs, routing = torch.utils.checkpoint.checkpoint(
                tp_conformer_block_apply, blocks, xs, masks, cos, sin, enc,
                dtype, dense_experts, use_reentrant=False)
        else:
            xs, routing = tp_conformer_block_apply(
                blocks, xs, masks, cos, sin, enc, dtype, dense_experts)
        xs = drop(xs, bi + 1)
        if routing is not None:
            prob_sum, counts, frames = routing
            routing = (prob_sum.to(mel.device), counts.to(mel.device),
                       frames)
            moe_routing.append(routing)
            moe_aux = moe_aux + load_balance_from_sums(*routing)
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
    out = {**out, "speaker_frames": spk_frames, "speaker_embed": spk,
           "encoder_states": x, "mask": m_sub, "moe_aux": moe_aux}
    if moe_routing:
        out["moe_routing"] = moe_routing
    return out


def mesh_asr_forward(rows, mel: torch.Tensor, mask: torch.Tensor,
                     cfg: PipelineConfig, dropout_seed: Optional[int] = None,
                     part=(0, 1)):
    """:func:`asr_forward` (training) over data rows x model shards.

    ``rows[r]`` is data row r's model shards' trees (``parallel.tensor.
    MeshParams.grid``); mel [B, T, n_mels] and mask [B, T], the global
    batch, on shard (0, 0)'s device. The batch is scattered over the rows
    (``P("data", ...)``); each row runs :func:`tp_asr_forward` on its
    model shards, experts (split over the shards by expert) under dense
    dispatch whatever ``encoder.moe_dispatch`` says, as the reference's
    loss runs them. ``dropout_seed``: the dropout masks are drawn over the
    global batch's shape on shard (0, 0)'s device, as one device draws
    them, and each row takes its rows. ``part`` (index, count): the rows
    are this process's, and it takes block ``index`` of ``count`` of the
    batch and of the masks (``Mesh.process_block``). Returns the rows'
    output dicts, each on its row's first device; with experts, each row's
    ``moe_routing`` sums make the whole batch's load-balance term
    (:func:`mesh_moe_aux`)."""
    enc = cfg.encoder
    data = len(rows)
    index, count = part
    firsts = [_tree_device(r[0]) for r in rows]
    mels = scatter(block_of(mel, index, count), firsts)
    masks = scatter(block_of(mask, index, count), firsts)
    keeps = [None] * data
    if dropout_seed is not None and enc.dropout > 0.0:
        B, T = mask.shape
        every = row_dropout_masks((B, T // enc.subsample_factor,
                                   enc.d_model), enc, dropout_seed,
                                  mel.device, [mel.device] * (data * count))
        keeps = [[to_device(k, d) for k in ks] for ks, d in
                 zip(every[index * data:(index + 1) * data], firsts)]
    return [tp_asr_forward(rows[r], mels[r], masks[r], cfg, keeps[r],
                           dense_experts=True)
            for r in range(data)]


def mesh_moe_aux(rows, device, processes: int = 1) -> torch.Tensor:
    """The blocks' summed load-balance term over the whole batch from the
    data rows' outputs of :func:`mesh_asr_forward`, on ``device``: each
    block's router probabilities and routed frames summed over the rows
    (and over the ``processes`` whose rows hold equal blocks of the
    batch), then ``E * sum_e f_e * p_e`` with f and p means over every
    frame of the batch, as one device computes it (0 without experts)."""
    aux = torch.zeros((), device=device)
    if "moe_routing" not in rows[0]:
        return aux
    for blocks in zip(*(o["moe_routing"] for o in rows)):
        prob_sum = sum(b[0].to(device) for b in blocks)
        counts = sum(b[1].to(device) for b in blocks)
        frames = sum(b[2] for b in blocks)
        if processes > 1:
            prob_sum = process_all_reduce(prob_sum)
            counts = process_all_reduce(counts)
            frames *= processes
        aux = aux + load_balance_from_sums(prob_sum, counts, frames)
    return aux


def row_dropout_masks(shape, enc: EncoderConfig, seed: int, device,
                      firsts):
    """Each data row's kept elements of salts 0 .. n_layers: each salt's
    mask drawn over the global batch's ``shape`` on ``device`` (as one
    device draws it), scattered over the rows (on their ``firsts``)."""
    draws = [scatter(dropout_mask(shape, enc.dropout, seed, salt, device),
                     firsts) for salt in range(enc.n_layers + 1)]
    return [[d[r] for d in draws] for r in range(len(firsts))]


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
