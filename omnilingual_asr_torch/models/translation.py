"""X->English translation decoder: training forward, greedy decode and the
text-mode translator.

The PyTorch port of ``omnilingual_asr_tpu/models/translation.py``: a
byte-level transformer decoder (causal self-attention, cross-attention into
a memory, FFN) with

- the teacher-forced forward that the synthetic-corpus trainer trains
  jointly with the encoder;
- greedy decoding with a preallocated KV cache and an optional forced
  prefix (:class:`GreedyDecoder`, :func:`greedy_translate`), which the
  engine's translator and the summarizer (``models/summarizer.py``) run;
- the text-mode translator: a checkpoint with a ``"src"`` byte-encoder
  subtree reads a segment's transcript bytes (:func:`encode_source`,
  :func:`translate_text`) instead of encoder states;
- ``.npz`` save/load in the release's keystr layout.

Numerics follow the reference: dense layers round their inputs and weights
to bf16 and accumulate in f32, attention runs f32 einsums with a -1e30
mask, and the embeddings and the KV cache are f32. On a card this needs
TF32 off, which the engine sets.

The reference decodes in one compiled ``lax.scan`` of ``max_len`` steps. The
port writes the step with static shapes (cache, position and forced token
are device tensors) and, on a CUDA device, captures one step in a
``torch.cuda.CUDAGraph`` per (B, max_len, Te) and replays it ``max_len``
times; on the CPU it runs the same step eagerly. Like the scan it runs all
``max_len`` steps: a finished row emits 0.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from . import layers as L

MAX_TARGET_LEN = 256  # bytes per segment translation
MAX_SOURCE_LEN = 256  # source bytes per translated span
N_LAYERS = 4
N_SRC_LAYERS = 2


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


def source_block_init(gen: torch.Generator, d_model: int):
    return {
        "ln1": L.layernorm_init(d_model),
        "qkv": L.dense_init(gen, d_model, 3 * d_model, use_bias=False),
        "o": L.dense_init(gen, d_model, d_model, use_bias=False),
        "ffn": L.ffn_init(gen, d_model, 4),
    }


def text_translator_init(gen: torch.Generator, cfg: PipelineConfig,
                         n_layers: int = N_LAYERS,
                         n_src_layers: int = N_SRC_LAYERS):
    """Decoder parameters plus a ``"src"`` byte-encoder subtree (text
    mode): embeddings and positions N(0, 0.02^2)."""
    d = cfg.encoder.d_model
    v = cfg.vocab.vocab_size
    p = translator_init(gen, cfg, n_layers)
    p["src"] = {
        "embed": torch.randn((v, d), generator=gen) * 0.02,
        "pos": torch.randn((MAX_SOURCE_LEN, d), generator=gen) * 0.02,
        "blocks": [source_block_init(gen, d) for _ in range(n_src_layers)],
        "ln_out": L.layernorm_init(d),
    }
    return p


def _ln_shape(d: int):
    return {"scale": (d,), "bias": (d,)}


def _ffn_shape(d: int):
    return {"ln": _ln_shape(d), "w1": {"w": (d, 4 * d), "b": (4 * d,)},
            "w2": {"w": (4 * d, d), "b": (d,)}}


def translator_param_shapes(cfg: PipelineConfig, n_layers: int = N_LAYERS):
    """Shape tree of :func:`translator_init`."""
    d, v = cfg.encoder.d_model, cfg.vocab.vocab_size
    block = {
        "ln1": _ln_shape(d), "self_qkv": {"w": (d, 3 * d)},
        "self_o": {"w": (d, d)}, "ln2": _ln_shape(d),
        "cross_q": {"w": (d, d)}, "cross_kv": {"w": (d, 2 * d)},
        "cross_o": {"w": (d, d)}, "ffn": _ffn_shape(d),
    }
    return {"embed": (v, d), "pos": (MAX_TARGET_LEN, d),
            "blocks": [block for _ in range(n_layers)], "ln_out": _ln_shape(d),
            "out": {"w": (d, v), "b": (v,)}}


def text_translator_param_shapes(cfg: PipelineConfig,
                                 n_layers: int = N_LAYERS,
                                 n_src_layers: int = N_SRC_LAYERS):
    """Shape tree of :func:`text_translator_init`."""
    d, v = cfg.encoder.d_model, cfg.vocab.vocab_size
    shapes = translator_param_shapes(cfg, n_layers)
    block = {"ln1": _ln_shape(d), "qkv": {"w": (d, 3 * d)},
             "o": {"w": (d, d)}, "ffn": _ffn_shape(d)}
    shapes["src"] = {"embed": (v, d), "pos": (MAX_SOURCE_LEN, d),
                     "blocks": [block for _ in range(n_src_layers)],
                     "ln_out": _ln_shape(d)}
    return shapes


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


# ---------------------------------------------------------------------------
# Tensor parallelism (training over a (data, model) mesh)
# ---------------------------------------------------------------------------

def decoder_block_spec():
    """The reference's ``decoder_block_spec`` but for the fused
    projections: ``self_qkv`` [d, 3d] is split within each of q, k and v
    and ``cross_kv`` [d, 2d] within each of k and v (``Split(..., halves)``),
    so that shard m holds heads [m H / n, (m + 1) H / n) of each; the
    reference's contiguous split of the fused columns hands a shard q and
    half of k at model 2, which GSPMD repairs by moving activations and a
    shard-local layer cannot."""
    from ..parallel.mesh import AXIS_MODEL, Split

    return {
        "ln1": L.layernorm_spec(),
        "self_qkv": {"w": Split(AXIS_MODEL, 1, halves=3)},
        "self_o": L.dense_spec(AXIS_MODEL, None, use_bias=False),
        "ln2": L.layernorm_spec(),
        "cross_q": L.dense_spec(None, AXIS_MODEL, use_bias=False),
        "cross_kv": {"w": Split(AXIS_MODEL, 1, halves=2)},
        "cross_o": L.dense_spec(AXIS_MODEL, None, use_bias=False),
        "ffn": L.ffn_spec(),
    }


def translator_specs(n_layers: int = N_LAYERS):
    """The joint translator's placement (the reference's
    ``translator_specs``): the embeddings and positions split by columns,
    the blocks by :func:`decoder_block_spec`. The output head is
    replicated: its vocabulary's 1 + 256 columns split evenly over no
    model axis above 1 (the reference's GSPMD pads them; as the encoder's
    CTC head)."""
    from ..parallel.mesh import AXIS_MODEL

    return {
        "embed": (None, AXIS_MODEL),
        "pos": (None, AXIS_MODEL),
        "blocks": [decoder_block_spec() for _ in range(n_layers)],
        "ln_out": L.layernorm_spec(),
        "out": L.dense_spec(None, None),
    }


def tp_decoder_forward(shards, tokens: torch.Tensor, enc: torch.Tensor,
                       enc_mask: torch.Tensor, cfg: PipelineConfig,
                       n_heads: Optional[int] = None) -> torch.Tensor:
    """:func:`decoder_forward` over the model shards of one data row:
    ``shards`` the row's translator trees under :func:`translator_specs`;
    tokens, the encoder states and their mask on shard 0's device. Each
    shard embeds its columns (gathered), runs self- and cross-attention
    on its heads (q/k/v column-parallel, the output projections
    row-parallel) and its FFN columns; the replicated head runs once, on
    shard 0. Returns the logits [B, Tt, V] f32 on shard 0's device."""
    from ..parallel import tensor as tp
    from ..parallel.mesh import all_gather, replicate

    n = len(shards)
    if n_heads is None:
        n_heads = cfg.encoder.n_heads
    if n_heads % n:
        raise ValueError(f"a model axis of {n} does not divide the "
                         f"translator's {n_heads} heads")
    heads = n_heads // n
    devices = [s["embed"].device for s in shards]
    B, Tt = tokens.shape
    toks = replicate(tokens.to(torch.long), devices)
    cols = [s["embed"][t] + s["pos"][:Tt][None, :, :]
            for s, t in zip(shards, toks)]
    xs = all_gather(cols, dim=-1)
    pos = torch.arange(Tt, device=tokens.device)
    causal = (pos[None, :, None] >= pos[None, None, :]).expand(B, Tt, Tt)
    causals = replicate(causal, devices)
    crosses = replicate(enc_mask[:, None, :].expand(B, Tt, enc_mask.shape[1]),
                        devices)
    encs = replicate(enc, devices)
    for bi in range(len(shards[0]["blocks"])):
        ps = [s["blocks"][bi] for s in shards]
        hs = tp.per_copy(lambda x, p: L.layernorm_apply(p["ln1"], x), xs, ps)
        att = []
        for p, h, c in zip(ps, hs, causals):
            q, k, v = L.dense_apply(p["self_qkv"], h).chunk(3, dim=-1)
            att.append(_attend(q, k, v, c, heads))
        # bf16 products, the reference decoder's default whatever the
        # encoder's dtype.
        ys = tp.row_dense([p["self_o"] for p in ps], att, torch.bfloat16)
        xs = tp.per_copy(lambda x, y: x + y, xs, ys)
        hs = tp.per_copy(lambda x, p: L.layernorm_apply(p["ln2"], x), xs, ps)
        att = []
        for p, h, e, c in zip(ps, hs, encs, crosses):
            cq = L.dense_apply(p["cross_q"], h)
            ck, cv = L.dense_apply(p["cross_kv"], e).chunk(2, dim=-1)
            att.append(_attend(cq, ck, cv, c, heads))
        ys = tp.row_dense([p["cross_o"] for p in ps], att, torch.bfloat16)
        xs = tp.per_copy(lambda x, y: x + y, xs, ys)
        xs = tp.tp_ffn_apply([p["ffn"] for p in ps], xs, torch.bfloat16,
                             half_step=False)
    x = L.layernorm_apply(shards[0]["ln_out"], xs[0])
    return L.dense_apply(shards[0]["out"], x)


# ---------------------------------------------------------------------------
# Greedy decoding
# ---------------------------------------------------------------------------

def decode_weights(params):
    """The tree with every dense weight rounded to bf16 once (held in f32),
    so that a decode step rounds only its activations. Rounding is
    idempotent: the products equal ``layers.dense_apply``'s."""
    if isinstance(params, dict):
        return {k: (L.round_to(v, torch.bfloat16) if k == "w"
                    else decode_weights(v)) for k, v in params.items()}
    if isinstance(params, list):
        return [decode_weights(v) for v in params]
    return params


def _dense(p, x: torch.Tensor) -> torch.Tensor:
    """A dense layer over a :func:`decode_weights` leaf: bf16-rounded input,
    f32 product and bias."""
    y = L.round_to(x, torch.bfloat16) @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, D] -> [B, n_heads, T, D // n_heads] (a view)."""
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def _attend_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """:func:`_attend` for one query over head-major keys: q [B, 1, D],
    k/v [B, H, Tk, hd], mask [B, 1, Tk] bool -> [B, 1, D]."""
    B, H, _, hd = k.shape
    logits = (_heads(q, H) @ k.transpose(-1, -2)) / math.sqrt(hd)
    logits = torch.where(mask[:, None], logits, -1e30)
    out = torch.softmax(logits, dim=-1) @ v                 # [B, H, 1, hd]
    return out.transpose(1, 2).reshape(B, 1, H * hd)


def _ffn(p, x: torch.Tensor) -> torch.Tensor:
    h = L.layernorm_apply(p["ln"], x)
    h = torch.nn.functional.silu(_dense(p["w1"], h))
    return x + _dense(p["w2"], h)


class _DecodeState:
    """Static buffers of one decode shape (B, max_len, Te): the step reads
    and writes only these, so a CUDA graph of it can be replayed. The
    self-attention cache and the cross K/V are held head-major ([layer, B,
    head, position, head dim]), so a step attends without a copy."""

    def __init__(self, n_layers: int, B: int, max_len: int, Te: int, D: int,
                 n_heads: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        hd = D // n_heads
        self.kc = torch.zeros((n_layers, B, n_heads, max_len, hd), **f32)
        self.vc = torch.zeros((n_layers, B, n_heads, max_len, hd), **f32)
        self.ck = torch.zeros((n_layers, B, n_heads, Te, hd), **f32)
        self.cv = torch.zeros((n_layers, B, n_heads, Te, hd), **f32)
        self.cross_mask = torch.zeros((B, 1, Te), dtype=torch.bool,
                                      device=device)
        self.tok = torch.zeros((B,), dtype=torch.long, device=device)
        self.done = torch.zeros((B,), dtype=torch.bool, device=device)
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        self.positions = torch.arange(max_len, device=device)
        self.forced = torch.full((max_len, B), -1, dtype=torch.long,
                                 device=device)
        self.toks = torch.zeros((max_len, B), dtype=torch.long, device=device)
        self.graph: Optional["torch.cuda.CUDAGraph"] = None


class GreedyDecoder:
    """Greedy KV-cache decoding with one decoder parameter tree.

    The weights are rounded to bf16 once here (:func:`decode_weights`). On
    a CUDA device with ``use_graph`` (the default there) one decode step is
    captured in a CUDA graph per (B, max_len, Te) on first use and replayed
    ``max_len`` times; a failed capture raises. Otherwise the step runs
    eagerly. ``params`` may hold a text-mode ``"src"`` subtree
    (:meth:`translate_text`) and summarizer marker leaves.

    A decoder is not re-entrant: decodes of one shape share their static
    buffers. Callers that decode from several threads hold one lock around
    each decode, as ``TranscriptionEngine`` does.
    """

    def __init__(self, params, cfg: PipelineConfig,
                 n_heads: Optional[int] = None,
                 use_graph: Optional[bool] = None):
        self.cfg = cfg
        self.n_heads = n_heads if n_heads is not None else cfg.encoder.n_heads
        self.params = decode_weights(params)
        self.device = self.params["embed"].device
        self.use_graph = (self.device.type == "cuda" if use_graph is None
                          else use_graph)
        self._states: Dict[Tuple[int, int, int], _DecodeState] = {}

    @property
    def is_text(self) -> bool:
        return is_text_translator(self.params)

    def _step(self, s: _DecodeState) -> None:
        """One decode position: reads ``s.tok`` at position ``s.t``, writes
        the next token into ``s.toks[t]`` and ``s.tok``, advances ``s.t``."""
        w = self.params
        B = s.tok.shape[0]
        x = w["embed"].index_select(0, s.tok)[:, None, :]      # [B, 1, D]
        if "pos" in w:        # keep decode == teacher-forced positions
            x = x + w["pos"].index_select(0, s.t)[None]
        hist = (s.positions <= s.t)[None, None, :].expand(
            B, 1, s.positions.shape[0])
        for li, blk in enumerate(w["blocks"]):
            h = L.layernorm_apply(blk["ln1"], x)
            q, k, v = _dense(blk["self_qkv"], h).chunk(3, dim=-1)
            s.kc[li].index_copy_(2, s.t, _heads(k, self.n_heads))
            s.vc[li].index_copy_(2, s.t, _heads(v, self.n_heads))
            x = x + _dense(blk["self_o"],
                           _attend_step(q, s.kc[li], s.vc[li], hist))
            h = L.layernorm_apply(blk["ln2"], x)
            cq = _dense(blk["cross_q"], h)
            x = x + _dense(blk["cross_o"], _attend_step(
                cq, s.ck[li], s.cv[li], s.cross_mask))
            x = _ffn(blk["ffn"], x)
        x = L.layernorm_apply(w["ln_out"], x)
        logits = _dense(w["out"], x)[:, 0, :1 + self.cfg.vocab.n_bytes]
        nxt = torch.argmax(logits, dim=-1)      # ties: the first index
        nxt = torch.where(s.done, 0, nxt)
        forced_t = s.forced.index_select(0, s.t)[0]
        nxt = torch.where(forced_t >= 0, forced_t, nxt)
        s.done |= (nxt == 0) & (forced_t < 0)
        s.toks.index_copy_(0, s.t, nxt[None])
        s.tok.copy_(nxt)
        s.t += 1

    def _capture(self, s: _DecodeState) -> "torch.cuda.CUDAGraph":
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(2):      # warm-up, as CUDA-graph capture needs
                self._step(s)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # The engine captures under its device lock, while other threads may
        # still wait on their own batches' events or free pinned buffers:
        # the default global mode would refuse those calls (and break the
        # capture), so this capture restricts only its own thread.
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._step(s)
        return graph

    @torch.no_grad()
    def decode(self, enc: torch.Tensor, enc_mask: torch.Tensor,
               max_len: int = MAX_TARGET_LEN, bos_id: int = 0,
               forced: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy decode: enc [B, Te, D], enc_mask [B, Te] bool -> token ids
        [B, max_len] int32 on the decoder's device.

        0 (blank) is BOS and EOS: a row that emitted a free 0 emits 0 from
        then on; the host strips from the first EOS. ``forced`` ([B,
        max_len], -1 = free) substitutes the given token at each
        non-negative position for the argmax; a forced token never ends a
        row. The summarizer forces the engine's own facts as a prefix."""
        w = self.params
        enc = enc.to(self.device, torch.float32)
        B, Te, D = enc.shape
        n_layers = len(w["blocks"])
        key = (B, max_len, Te)
        s = self._states.get(key) if self.use_graph else None
        if s is None:
            s = _DecodeState(n_layers, B, max_len, Te, D, self.n_heads,
                             self.device)
        for li, blk in enumerate(w["blocks"]):   # cross K/V once per layer
            ck, cv = _dense(blk["cross_kv"], enc).chunk(2, dim=-1)
            s.ck[li].copy_(_heads(ck, self.n_heads))
            s.cv[li].copy_(_heads(cv, self.n_heads))
        s.cross_mask.copy_(enc_mask.to(self.device, torch.bool)[:, None, :])
        if self.use_graph and s.graph is None:
            s.graph = self._capture(s)
            self._states[key] = s

        s.kc.zero_()
        s.vc.zero_()
        s.tok.fill_(bos_id)
        s.done.zero_()
        s.t.zero_()
        s.toks.zero_()
        if forced is None:
            s.forced.fill_(-1)
        else:
            s.forced.copy_(forced.to(self.device, torch.long).t())
        for _ in range(max_len):
            if s.graph is not None:
                s.graph.replay()
            else:
                self._step(s)
        return s.toks.t().to(torch.int32)

    @torch.no_grad()
    def translate_text(self, tokens: torch.Tensor, mask: torch.Tensor,
                       max_len: int = MAX_TARGET_LEN) -> torch.Tensor:
        """Text mode: encode the source bytes, then greedy-decode over that
        memory (:func:`translate_text`)."""
        tokens = tokens.to(self.device)
        mask = mask.to(self.device, torch.bool)
        mem = _encode_source(self.params, tokens, mask, self.n_heads)
        return self.decode(mem, mask, max_len=max_len)


def greedy_translate(params, enc: torch.Tensor, enc_mask: torch.Tensor,
                     cfg: PipelineConfig, max_len: int = MAX_TARGET_LEN,
                     bos_id: int = 0, n_heads: Optional[int] = None,
                     forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decode with a fixed KV cache: enc [B, Te, D], enc_mask
    [B, Te] -> token ids [B, max_len] int32 (:meth:`GreedyDecoder.decode`)."""
    return GreedyDecoder(params, cfg, n_heads).decode(
        enc, enc_mask, max_len=max_len, bos_id=bos_id, forced=forced)


# ---------------------------------------------------------------------------
# Text-conditioned translation ("src" mode)
# ---------------------------------------------------------------------------

def _encode_source(w, tokens: torch.Tensor, mask: torch.Tensor,
                   n_heads: int) -> torch.Tensor:
    src = w["src"]
    B, Ts = tokens.shape
    x = (src["embed"].index_select(0, tokens.reshape(-1).to(torch.long))
         .reshape(B, Ts, -1) + src["pos"][:Ts][None, :, :])
    am = mask[:, None, :].expand(B, Ts, Ts)
    for blk in src["blocks"]:
        h = L.layernorm_apply(blk["ln1"], x)
        q, k, v = _dense(blk["qkv"], h).chunk(3, dim=-1)
        x = x + _dense(blk["o"], _attend(q, k, v, am, n_heads))
        x = _ffn(blk["ffn"], x)
    x = L.layernorm_apply(src["ln_out"], x)
    return x * mask[:, :, None]


def encode_source(params, tokens: torch.Tensor, mask: torch.Tensor,
                  cfg: PipelineConfig,
                  n_heads: Optional[int] = None) -> torch.Tensor:
    """Byte tokens [B, Ts] + mask [B, Ts] -> [B, Ts, D] decoder memory;
    differentiable in ``params`` (the text translator trainer's loss)."""
    if n_heads is None:
        n_heads = cfg.encoder.n_heads
    return _encode_source(decode_weights(params), tokens, mask.to(torch.bool),
                          n_heads)


def translate_text(params, tokens: torch.Tensor, mask: torch.Tensor,
                   cfg: PipelineConfig, max_len: int = MAX_TARGET_LEN,
                   n_heads: Optional[int] = None) -> torch.Tensor:
    """Text-mode greedy decode: encode the source bytes, then the KV-cache
    decode of :func:`greedy_translate` over that memory."""
    return GreedyDecoder(params, cfg, n_heads).translate_text(
        tokens, mask, max_len=max_len)


def source_to_tokens(text: str, vocab, max_len: int = MAX_SOURCE_LEN):
    """UTF-8 bytes -> (ids [max_len] int32, mask [max_len] bool)."""
    bs = text.encode("utf-8")[:max_len]
    ids = np.zeros(max_len, np.int32)
    mask = np.zeros(max_len, bool)
    for i, b in enumerate(bs):
        ids[i] = vocab.byte_to_id(b)
        mask[i] = True
    return ids, mask


def is_text_translator(params) -> bool:
    return isinstance(params, dict) and "src" in params


def tokens_to_text(tokens, vocab) -> str:
    """Strip at the first EOS (0) and decode UTF-8."""
    out = []
    for t in tokens:
        t = int(t)
        if t == 0:
            break
        b = vocab.id_to_byte(t)
        if 0 <= b < 256:
            out.append(b)
    return bytes(out).decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def save_translator(path, params) -> None:
    """Write decoder parameters as one f32 ``.npz`` in the release's keystr
    layout (``models/zoo.py::save_checkpoint``)."""
    from .zoo import save_checkpoint

    save_checkpoint(path, params)


def load_translator(path, cfg: PipelineConfig, n_layers: int = N_LAYERS,
                    device="cpu"):
    """Load decoder parameters saved by :func:`save_translator` or a JAX
    release ``.npz``, validated against the shape tree of the init, as
    host tensors unless ``device`` says otherwise (the callers place
    them).

    A text-mode checkpoint (a ``"src"`` subtree) loads against
    :func:`text_translator_param_shapes`; a fact-conditioned summarizer's
    scalar ``"fact_cond"`` marker is kept. A checkpoint from before the
    learned position table gets a zero table, which reproduces its forward
    exactly, as the reference's loader does."""
    from .zoo import load_release

    path = Path(path)
    if path.suffix != ".npz":
        raise NotImplementedError(
            f"{path}: only .npz translator checkpoints load in the port "
            f"(Orbax checkpoints need JAX)")
    with np.load(path) as z:
        files = set(z.files)
    has_pos = "['pos']" in files
    has_src = any(k.startswith("['src']") for k in files)
    has_fact = "['fact_cond']" in files
    if has_src:
        shapes = text_translator_param_shapes(cfg, n_layers)
    else:
        shapes = translator_param_shapes(cfg, n_layers)
        if not has_pos:
            shapes.pop("pos")
    if has_fact:
        shapes["fact_cond"] = ()
    params = load_release(path, shapes, device)
    if not has_src and not has_pos:
        params["pos"] = torch.zeros((MAX_TARGET_LEN, cfg.encoder.d_model),
                                    device=device)
    return params
