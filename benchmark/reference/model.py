"""The model's equations in plain f32 PyTorch.

- Frontend: pre-emphasis (0.97), frames of n_fft samples every hop under a
  periodic Hann window of win_length, the power spectrum as a dense real
  DFT, an HTK mel filterbank, log with a floor.
- Conformer: frame stacking (x4) and a dense projection, LayerNorm, then
  blocks of FFN half-step, pre-LN multi-head self-attention with rotary
  positions over the valid keys, the conv module (pointwise GLU, depthwise
  taps with SAME padding over the masked frames, LayerNorm, SiLU,
  pointwise), FFN half-step and a LayerNorm; heads for CTC, language,
  emotion and speaker frames.
- X-vector: five 1-D convolutions with SAME padding, each with bias,
  LayerNorm and ReLU, then a projection.
- Decoders: a pre-LN transformer decoder (causal self-attention,
  cross-attention into a memory, FFN x4 with SiLU) over byte tokens, and
  the text translator's byte encoder, teacher-forced.
Every product is f32; no operand is rounded to a lower precision unless
``lowp`` names one (the control).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, held in f32: the control's precision."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def dense(p, x, lowp: Round = None):
    w = p["w"]
    if lowp is not None:
        x, w = lowp(x), lowp(w)
    y = x @ w
    return y + p["b"] if "b" in p else y


def layernorm(p, x, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

def mel_constants(fe: dict, device):
    n_fft, n_mels, sr = fe["n_fft"], fe["n_mels"], fe["sample_rate"]
    n_bins = n_fft // 2 + 1
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * f / n_fft
    win = np.zeros(n_fft)
    n = np.arange(fe["win_length"], dtype=np.float64)
    win[:fe["win_length"]] = 0.5 - 0.5 * np.cos(2.0 * np.pi * n
                                               / fe["win_length"])
    cw = (win[:, None] * np.cos(ang)).astype(np.float32)
    sw = (win[:, None] * -np.sin(ang)).astype(np.float32)
    mel = lambda hz: 2595.0 * np.log10(1.0 + hz / 700.0)       # noqa: E731
    hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)        # noqa: E731
    pts = hz(np.linspace(mel(0.0), mel(sr / 2.0), n_mels + 2))
    freqs = np.linspace(0.0, sr / 2.0, n_bins)
    fb = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / max(c - lo, 1e-8),
                                              (hi - freqs) / max(hi - c, 1e-8)))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (cw, sw, fb))


def frames_for_samples(fe: dict, n: int) -> int:
    return 0 if n < fe["win_length"] else \
        1 + (n - fe["win_length"]) // fe["hop_length"]


def log_mel(x: torch.Tensor, fe: dict, consts, n_out: int) -> torch.Tensor:
    """x [B, n] f32 samples -> log-mel [B, n_out, n_mels]; frames past the
    signal's end are zero frames (their log is the floor)."""
    cw, sw, fb = consts
    n_fft, hop = fe["n_fft"], fe["hop_length"]
    x = torch.cat([x[:, :1], x[:, 1:] - fe["preemphasis"] * x[:, :-1]], dim=1)
    n_frames = frames_for_samples(fe, x.shape[1])
    need = (n_frames - 1) * hop + n_fft
    if need > x.shape[1]:
        x = F.pad(x, (0, need - x.shape[1]))
    fr = x.unfold(1, n_fft, hop)[:, :n_frames]
    out = torch.full((x.shape[0], n_out, fb.shape[1]),
                     math.log(fe["log_floor"]), device=x.device)
    k = min(n_frames, n_out)
    re, im = fr[:, :k] @ cw, fr[:, :k] @ sw
    out[:, :k] = torch.log(torch.clamp((re * re + im * im) @ fb,
                                       min=fe["log_floor"]))
    return out


# ---------------------------------------------------------------------------
# Conformer
# ---------------------------------------------------------------------------

def _rope(T: int, hd: int, device):
    half = hd // 2
    inv = 1.0 / (10_000.0 ** (np.arange(half, dtype=np.float64) / half))
    ang = np.outer(np.arange(T, dtype=np.float64), inv)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([a * c - b * s, a * s + b * c], dim=-1)


def _ffn(p, x, lowp, half=True):
    h = dense(p["w2"], F.silu(dense(p["w1"], layernorm(p["ln"], x), lowp)),
              lowp)
    return x + (0.5 * h if half else h)


def _mhsa(p, x, mask, n_heads, rope, lowp):
    B, T, D = x.shape
    hd = D // n_heads
    h = layernorm(p["ln"], x)
    q, k, v = (dense(p[n], h, lowp).reshape(B, T, n_heads, hd)
               for n in ("wq", "wk", "wv"))
    q, k = _rotate(q, *rope), _rotate(k, *rope)
    if lowp is not None:
        q, k, v = lowp(q), lowp(k), lowp(v)
    s = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    a = torch.softmax(s, dim=-1)
    if lowp is not None:
        a = lowp(a)
    o = torch.einsum("bhts,bshd->bthd", a, v).reshape(B, T, D)
    return x + dense(p["wo"], o, lowp)


def _conv(p, x, mask, lowp):
    D = x.shape[-1]
    h = dense(p["pw1"], layernorm(p["ln"], x), lowp)
    h = h[..., :D] * torch.sigmoid(h[..., D:])
    h = h * mask[:, :, None]
    K = p["dw"].shape[0]
    left = (K - 1) // 2
    h = F.pad(h.transpose(1, 2), (left, K - 1 - left))
    h = F.conv1d(h, p["dw"].t().unsqueeze(1), groups=D).transpose(1, 2)
    h = F.silu(layernorm(p["dw_ln"], h))
    return x + dense(p["pw2"], h, lowp)


def conformer(params, mel, mask, cfg: dict, lowp: Round = None):
    """mel [B, T, n_mels], mask [B, T] -> dict of the heads' outputs, the
    encoder states and the subsampled mask."""
    sub = cfg["subsample_factor"]
    B, T, M = mel.shape
    x = dense(params["subsample"], mel.reshape(B, T // sub, sub * M), lowp)
    m = mask.reshape(B, T // sub, sub)[:, :, 0]
    x = layernorm(params["in_ln"], x)
    rope = _rope(x.shape[1], cfg["d_model"] // cfg["n_heads"], x.device)
    for blk in params["blocks"]:
        x = _ffn(blk["ffn1"], x, lowp)
        x = _mhsa(blk["mhsa"], x, m, cfg["n_heads"], rope, lowp)
        x = _conv(blk["conv"], x, m, lowp)
        x = _ffn(blk["ffn2"], x, lowp)
        x = layernorm(blk["ln_out"], x)
    spk = dense(params["spk_head2"],
                torch.relu(dense(params["speaker_head"], x, lowp)), lowp)
    return {"ctc": dense(params["ctc_head"], x, lowp),
            "lid": dense(params["lid_head"], x, lowp),
            "emotion": dense(params["emotion_head"], x, lowp),
            "speaker": spk, "states": x, "mask": m}


# ---------------------------------------------------------------------------
# X-vector
# ---------------------------------------------------------------------------

XVECTOR_LAYERS = ((5, 2, 1), (5, 2, 1), (3, 1, 2), (3, 1, 4), (3, 1, 8))


def xvector(params, mel, mask, lowp: Round = None):
    """[B, T, n_mels] -> [B, T // 4, 256] frame embeddings."""
    x = mel * mask[..., None]
    for conv, ln, (k, stride, dil) in zip(params["convs"], params["lns"],
                                          XVECTOR_LAYERS):
        xc = x.transpose(1, 2)
        T = xc.shape[-1]
        out = math.ceil(T / stride)
        total = max((out - 1) * stride + (k - 1) * dil + 1 - T, 0)
        xc = F.pad(xc, (total // 2, total - total // 2))
        w = conv["w"].permute(2, 1, 0)
        if lowp is not None:
            xc, w = lowp(xc), lowp(w)
        y = F.conv1d(xc, w, stride=stride, dilation=dil).transpose(1, 2)
        x = torch.relu(layernorm(ln, y + conv["b"]))
    return dense(params["out"], x, lowp)


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask, n_heads):
    B, Tq, D = q.shape
    hd = D // n_heads
    qh, kh, vh = (t.reshape(B, t.shape[1], n_heads, hd) for t in (q, k, v))
    s = torch.einsum("bthd,bshd->bhts", qh, kh) / math.sqrt(hd)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", a, vh).reshape(B, Tq, D)


def source_encoder(params, tokens, mask, n_heads, lowp: Round = None):
    """The text translator's byte encoder: [B, Ts] -> memory [B, Ts, D]."""
    src = params["src"]
    Ts = tokens.shape[1]
    x = src["embed"][tokens.long()] + src["pos"][:Ts][None]
    am = mask[:, None, :].expand(-1, Ts, -1)
    for blk in src["blocks"]:
        q, k, v = dense(blk["qkv"], layernorm(blk["ln1"], x),
                        lowp).chunk(3, dim=-1)
        x = x + dense(blk["o"], _attend(q, k, v, am, n_heads), lowp)
        x = _ffn(blk["ffn"], x, lowp, half=False)
    return layernorm(src["ln_out"], x) * mask[:, :, None]


def decoder_logits(params, tokens, memory, mem_mask, n_heads,
                   lowp: Round = None):
    """Teacher-forced decoder: input tokens [B, Tt] (BOS first) -> logits
    [B, Tt, V]."""
    B, Tt = tokens.shape
    x = params["embed"][tokens.long()]
    if "pos" in params:
        x = x + params["pos"][:Tt][None]
    pos = torch.arange(Tt, device=tokens.device)
    causal = (pos[:, None] >= pos[None, :])[None].expand(B, Tt, Tt)
    cross = mem_mask[:, None, :].expand(B, Tt, mem_mask.shape[1])
    for blk in params["blocks"]:
        q, k, v = dense(blk["self_qkv"], layernorm(blk["ln1"], x),
                        lowp).chunk(3, dim=-1)
        x = x + dense(blk["self_o"], _attend(q, k, v, causal, n_heads), lowp)
        cq = dense(blk["cross_q"], layernorm(blk["ln2"], x), lowp)
        ck, cv = dense(blk["cross_kv"], memory, lowp).chunk(2, dim=-1)
        x = x + dense(blk["cross_o"], _attend(cq, ck, cv, cross, n_heads),
                      lowp)
        x = _ffn(blk["ffn"], x, lowp, half=False)
    return dense(params["out"], layernorm(params["ln_out"], x), lowp)


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def train_loss(params, batch, cfg: dict, fe: dict, consts,
               lowp: Round = None) -> torch.Tensor:
    """The multi-task loss of one batch: CTC per label token, plus 0.1 x
    (pooled language CE + pooled emotion CE), plus 0.3 x the additive
    angular margin softmax (margin 0.2, scale 30) of the statistics-pooled
    speaker embedding. ``batch['samples']``: f32 samples after
    augmentation."""
    T = batch["mask"].shape[1]
    with torch.no_grad():
        mel = log_mel(batch["samples"], fe, consts, T)
    out = conformer(params, mel, batch["mask"], cfg, lowp)
    m = out["mask"]
    logp = torch.log_softmax(out["ctc"], dim=-1)
    lm = batch["label_mask"]
    ctc = F.ctc_loss(logp.transpose(0, 1), batch["labels"].long(),
                     m.sum(dim=1), lm.sum(dim=1), blank=0,
                     reduction="none").sum() / lm.sum()
    w = m.to(torch.float32)[:, :, None]
    denom = w.sum(dim=1).clamp(min=1.0)

    def pooled_ce(logits, label):
        pooled = (logits * w).sum(dim=1) / denom
        return -torch.log_softmax(pooled, -1).gather(
            1, label.long()[:, None]).mean()

    total = ctc + 0.1 * (pooled_ce(out["lid"], batch["lid_label"])
                         + pooled_ce(out["emotion"], batch["emotion_label"]))
    # Statistics pooling of the speaker frames, projection, AAM softmax.
    fr = out["speaker"]
    mean = (fr * w).sum(dim=1) / denom
    std = torch.sqrt((w * (fr - mean[:, None]) ** 2).sum(dim=1) / denom
                     + 1e-6)
    e = dense(params["spk_proj"], torch.cat([mean, std], dim=-1), lowp)
    e = e * torch.rsqrt((e * e).sum(dim=-1, keepdim=True) + 1e-8)
    wa = params["spk_aam"]
    cos = e @ (wa / wa.norm(dim=0, keepdim=True).clamp(min=1e-8))
    lab = batch["speaker_label"].long()
    t = cos.gather(1, lab[:, None])[:, 0].clamp(-1.0 + 1e-4, 1.0 - 1e-4)
    tm = t * math.cos(0.2) - torch.sqrt(1.0 - t * t) * math.sin(0.2)
    onehot = F.one_hot(lab, cos.shape[-1]).to(cos.dtype)
    logits = 30.0 * (cos + onehot * (tm - t)[:, None])
    spk = -(torch.log_softmax(logits, -1) * onehot).sum(-1).mean()
    return total + 0.3 * spk
