"""Sequence-parallel conformer forward: one long sequence split over a mesh
axis.

The PyTorch port of ``omnilingual_asr_tpu/parallel/sequence.py``. A whole
file's frames split over the axis and the encoder runs as one program over
the shards:

- FFN, LayerNorm and the heads are frame-local: no exchange;
- attention is exact ring attention (``ops/ring_attention.py``): the key
  and value blocks rotate by ``ppermute``;
- the depthwise conv exchanges halos: each shard receives its neighbours'
  edge frames, zeros at both ends of the sequence;
- RoPE positions are global (a shard's offset is its index times its
  length).

As in the reference, every dense layer here computes in f32 whatever
``encoder.dtype`` says (on a card, TF32 must be off).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..config import PipelineConfig
from ..models import layers as L
from ..ops.ring_attention import ring_attention_shards
from .mesh import (Mesh, gather, ppermute, replicate, require_one_process,
                   ring_perm, scatter)

F32 = torch.float32


def _halo_exchange(x: Sequence[torch.Tensor], pad_l: int,
                   pad_r: int) -> List[torch.Tensor]:
    """Each [T_local, D] shard with the last ``pad_l`` frames of its left
    neighbour before it and the first ``pad_r`` of its right neighbour
    after it; zeros beyond both ends of the sequence.

    A shard shorter than the halo raises ValueError: the reference's
    edge slices ``x[-pad_l:]`` then take the whole shard, and its tap loop
    fails on the misaligned shapes (``tests/test_torch_ring_sequence.py``
    holds both to that)."""
    n = len(x)
    T_local = x[0].shape[0]
    if T_local < max(pad_l, pad_r):
        raise ValueError(
            f"a shard of {T_local} frames is shorter than the conv halo "
            f"({pad_l} + {pad_r} frames): use fewer shards or a longer "
            f"sequence")
    left = (ppermute([s[T_local - pad_l:] for s in x], ring_perm(n, 1))
            if pad_l else None)
    right = (ppermute([s[:pad_r] for s in x], ring_perm(n, -1))
             if pad_r else None)
    out = []
    for i, s in enumerate(x):
        parts = []
        if pad_l:
            parts.append(torch.zeros_like(left[i]) if i == 0 else left[i])
        parts.append(s)
        if pad_r:
            parts.append(torch.zeros_like(right[i]) if i == n - 1
                         else right[i])
        out.append(torch.cat(parts, dim=0))
    return out


def _sp_convmod(p, x: Sequence[torch.Tensor],
                mask_col: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sequence-parallel conv module on [T_local, D] shards: the GLU is
    masked before the halo exchange, then the K-tap loop."""
    K = p[x[0].device]["dw"].shape[0]
    pad_l = (K - 1) // 2
    pad_r = K - 1 - pad_l
    D = x[0].shape[-1]
    glu = []
    for s, mc in zip(x, mask_col):
        pp = p[s.device]
        g = L.dense_apply(pp["pw1"], L.layernorm_apply(pp["ln"], s), F32)
        glu.append(g[:, :D] * torch.sigmoid(g[:, D:]) * mc)
    ext = _halo_exchange(glu, pad_l, pad_r)
    out = []
    for s, e in zip(x, ext):
        pp = p[s.device]
        T_local = s.shape[0]
        dw = pp["dw"].to(F32)
        h = torch.zeros((T_local, D), dtype=F32, device=s.device)
        for k in range(K):
            h = h + e[k:k + T_local] * dw[k][None, :]
        h = torch.nn.functional.silu(L.layernorm_apply(pp["dw_ln"], h))
        out.append(s + L.dense_apply(pp["pw2"], h, F32))
    return out


def _sp_attention(p, x: Sequence[torch.Tensor], mask: Sequence[torch.Tensor],
                  cos: Sequence[torch.Tensor], sin: Sequence[torch.Tensor],
                  n_heads: int) -> List[torch.Tensor]:
    """Sequence-parallel MHSA: per-shard queries, rotating keys and
    values (the ring attention math)."""
    q, k, v = [], [], []
    for s, c, sn in zip(x, cos, sin):
        pp = p[s.device]
        T_local, D = s.shape
        h = L.layernorm_apply(pp["ln"], s)
        qs, ks, vs = (L.dense_apply(pp[n], h, F32).reshape(T_local, n_heads,
                                                            -1)
                      for n in ("wq", "wk", "wv"))
        q.append(L.apply_rope(qs[None], c, sn))
        k.append(L.apply_rope(ks[None], c, sn))
        v.append(vs[None])
    att = ring_attention_shards(q, k, v, [m[None] for m in mask])
    out = []
    for s, a in zip(x, att):
        T_local, D = s.shape
        out.append(s + L.dense_apply(p[s.device]["wo"],
                                     a[0].reshape(T_local, D), F32))
    return out


def _by_device(tree, devices):
    """{device: the tree on that device} for each distinct device."""
    def place(node, d):
        if isinstance(node, dict):
            return {k: place(v, d) for k, v in node.items()}
        if isinstance(node, list):
            return [place(v, d) for v in node]
        return replicate(node, [d])[0]

    out: Dict[torch.device, object] = {}
    for d in devices:
        if d not in out:
            out[d] = place(tree, d)
    return out


def sp_conformer_forward(params, mel: torch.Tensor, mask: torch.Tensor,
                         cfg: PipelineConfig, mesh: Mesh, axis: str = "data",
                         all_heads: bool = False, with_states: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Sequence-parallel encoder forward over one sequence.

    mel: [T, n_mels] (T divisible by the axis size times the subsample
    factor); mask: [T] bool. Returns {"ctc_logits": [T', V], "mask":
    [T']} on mel's device; with ``all_heads`` also ``lid_logits``,
    ``emotion_logits`` and ``speaker_frames``, and with ``with_states``
    the pre-head encoder states as bf16 ``encoder_states`` [T', D].
    A mixture-of-experts tree raises ValueError (the reference applies a
    dense FFN to ``ffn2`` here and fails).
    """
    require_one_process(mesh, "sequence mode's ring")
    enc = cfg.encoder
    sub = enc.subsample_factor
    devices = mesh.axis_devices(axis)
    n = len(devices)
    T = mel.shape[0]
    if T % (n * sub):
        raise ValueError(f"T={T} does not split into {n} shards of whole "
                         f"{sub}-frame stacks")
    if "router" in params["blocks"][0]["ffn2"]:
        raise ValueError(
            "sequence mode takes dense FFNs only: the reference's "
            "sp_conformer_forward applies ffn_apply to a mixture-of-experts "
            "ffn2 and fails there too")
    Tp_local = T // sub // n
    p = _by_device(params, devices)
    mel_s = scatter(mel, devices, 0)
    mask_s = scatter(mask, devices, 0)
    cos_full, sin_full = L.rope_angles(Tp_local * n, enc.head_dim)
    x, m, cos, sin, mask_col = [], [], [], [], []
    for i, (ml, kl) in enumerate(zip(mel_s, mask_s)):
        pp = p[ml.device]
        h = ml.reshape(Tp_local, sub * cfg.frontend.n_mels).to(F32)
        h = L.layernorm_apply(pp["in_ln"],
                              L.dense_apply(pp["subsample"], h, F32))
        x.append(h)
        mi = kl.reshape(Tp_local, sub)[:, 0]
        m.append(mi)
        mask_col.append(mi.to(F32)[:, None])
        sl = slice(i * Tp_local, (i + 1) * Tp_local)
        cos.append(cos_full[sl].to(ml.device))
        sin.append(sin_full[sl].to(ml.device))
    for bi in range(len(params["blocks"])):
        blk = {d: pp["blocks"][bi] for d, pp in p.items()}
        x = [L.ffn_apply(blk[s.device]["ffn1"], s[None], F32,
                         half_step=True)[0] for s in x]
        x = _sp_attention({d: b["mhsa"] for d, b in blk.items()}, x, m, cos,
                          sin, enc.n_heads)
        x = _sp_convmod({d: b["conv"] for d, b in blk.items()}, x, mask_col)
        x = [L.layernorm_apply(blk[s.device]["ln_out"],
                               L.ffn_apply(blk[s.device]["ffn2"], s[None],
                                           F32, half_step=True)[0])
             for s in x]
    heads: Dict[str, List[torch.Tensor]] = {"ctc_logits": [], "mask": m}
    if all_heads:
        for key in ("lid_logits", "emotion_logits", "speaker_frames"):
            heads[key] = []
        if with_states:
            heads["encoder_states"] = []
    for s in x:
        pp = p[s.device]
        heads["ctc_logits"].append(L.dense_apply(pp["ctc_head"], s, F32))
        if not all_heads:
            continue
        heads["lid_logits"].append(L.dense_apply(pp["lid_head"], s, F32))
        heads["emotion_logits"].append(
            L.dense_apply(pp["emotion_head"], s, F32))
        h = torch.relu(L.dense_apply(pp["speaker_head"], s, F32))
        heads["speaker_frames"].append(L.dense_apply(pp["spk_head2"], h, F32))
        if with_states:
            heads["encoder_states"].append(s.to(torch.bfloat16))
    return {k: gather(v, 0, mel.device) for k, v in heads.items()}
