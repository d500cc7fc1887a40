"""Fused conformer conv module: kernel K3 and its plain PyTorch version.

Port of ``omnilingual_asr_tpu/ops/conv_module.py``: the whole module per
frame, LN -> pointwise [D, 2D] (bf16 in, f32 accumulation) -> GLU ->
x mask -> depthwise K taps, SAME (left (K-1)//2) -> LN -> SiLU ->
pointwise [D, D] (bf16 in, f32 accumulation) -> + the unmasked input.

``fused_conv_module`` launches the CUDA kernel (``csrc/conv_module.cu``:
two launches, one count) for CUDA tensors and runs ``conv_module_plain``
(the twin of the reference's ``_conv_module_ref``) for CPU tensors.
``FusedConvModule`` is the differentiable entry point: K3 forward,
autograd of the plain version backward, as the reference's custom VJP.

``fused_conv_module_split`` is the module with its channels split over
the shards of a model axis (tensor parallelism, serving): on each shard
(i) LN(x) over all D channels, the shard's pw1 value and gate columns,
GLU, mask and taps on its D / n channels, each frame's (mean, M2) over
them; (ii) the shards' statistics gathered and merged (Chan et al.'s
update), a = bf16(SiLU(LN(c))) on the shard's channels; (iii) a @ the
shard's pw2 rows, a partial output; then the partials summed over the
shards and x added once. On the card each step is a kernel of
``csrc/conv_module.cu``; ``conv_module_split_plain`` is the same split
on plain ops.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..parallel.mesh import all_gather, device_guard, psum
from . import cuda_build

#: Largest depthwise kernel the CUDA kernel's halo holds: its first stage
#: computes pw1 over a block's frames plus 32 halo rows (K - 1 <= 32).
KERNEL_MAX_TAPS = 33
#: Widest model the kernel takes: its first stage joins the D / 64 blocks
#: of a frame tile in one thread block cluster, and a cluster holds at most
#: 16 blocks, so D <= 1024 (large_config's width).
KERNEL_MAX_D = 1024


def _ln(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back to f32: a bf16 matmul input, held in f32 so
    that the product accumulates in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _taps(glu: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The depthwise taps of [B, T, C] over time in ascending order, SAME
    padding (left (K - 1) // 2), as the kernel sums them."""
    T = glu.shape[1]
    K = dw.shape[0]
    pad_l = (K - 1) // 2
    padded = torch.nn.functional.pad(glu, (0, 0, pad_l, K - 1 - pad_l))
    out = torch.zeros_like(glu)
    for k in range(K):
        out = out + padded[:, k:k + T, :] * dw[k][None, None, :]
    return out


def conv_module_plain(x, mask, ln_scale, ln_bias, pw1, dw, dwln_scale,
                      dwln_bias, pw2):
    """x [B, T, D] f32, mask [B, T] bool -> [B, T, D] f32."""
    xf = x.to(torch.float32)
    D = xf.shape[-1]
    h = _ln(xf, ln_scale, ln_bias)
    g = _bf16(h) @ _bf16(pw1)
    glu = g[..., :D] * torch.sigmoid(g[..., D:])
    glu = glu * mask.to(torch.float32)[:, :, None]
    out = _taps(glu, dw)
    out = _ln(out, dwln_scale, dwln_bias)
    out = torch.nn.functional.silu(out)
    out = _bf16(out) @ _bf16(pw2)
    return xf + out


def kernel_scratch(B: int, T: int, D: int, device, lib=None) -> torch.Tensor:
    """K3's scratch: the pw2 input bf16(SiLU(LN(c))), [B, T, D] bf16,
    between its two launches, then its first launch's A operands,
    bf16(LN(x)) of each tile of TT frames and its RP halo rows,
    [B, ceil(T / TT), RP, D] bf16 (RP, TT from the plan of ``lib``, by
    default the loaded kernel library)."""
    _, rp, tt, *_ = cuda_build.plan("omni_conv_module_plan", B, T, D,
                                    lib=lib)
    n = B * T * D + B * -(-T // tt) * rp * D
    return torch.empty(n, dtype=torch.bfloat16, device=device)


def fused_conv_module(x, mask, ln_scale, ln_bias, pw1, dw, dwln_scale,
                      dwln_bias, pw2):
    """Fused conv module; see :func:`conv_module_plain`.

    A CUDA tensor goes to kernel K3; a CPU tensor to the plain version.
    On the card pw1 and pw2 must already be bf16 (the engine keeps them so
    from load time); the plain version takes them in f32 or bf16 alike.
    """
    if not x.is_cuda:
        return conv_module_plain(x, mask, ln_scale, ln_bias, pw1, dw,
                                 dwln_scale, dwln_bias, pw2)
    B, T, D = x.shape
    K = dw.shape[0]
    dev = x.device
    f32 = torch.float32
    if D % 64 or D > KERNEL_MAX_D or K > KERNEL_MAX_TAPS:
        raise ValueError(f"conv-module kernel takes D % 64 == 0, D <= "
                         f"{KERNEL_MAX_D} and at most {KERNEL_MAX_TAPS} taps, "
                         f"got D={D}, K={K}")
    mask_i = mask.to(torch.int32).contiguous()
    cuda_build.check_tensor(x, "x", f32, (B, T, D), dev)
    cuda_build.check_tensor(mask_i, "mask", torch.int32, (B, T), dev)
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias),
                    ("dwln_scale", dwln_scale), ("dwln_bias", dwln_bias)):
        cuda_build.check_tensor(t, name, f32, (D,), dev)
    cuda_build.check_tensor(pw1, "pw1", torch.bfloat16, (D, 2 * D), dev)
    cuda_build.check_tensor(dw, "dw", f32, (K, D), dev)
    cuda_build.check_tensor(pw2, "pw2", torch.bfloat16, (D, D), dev)
    out = torch.empty_like(x)
    scratch = kernel_scratch(B, T, D, dev)
    lib = cuda_build.library()
    err = lib.omni_conv_module(
        x.data_ptr(), mask_i.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), pw1.data_ptr(), dw.data_ptr(),
        dwln_scale.data_ptr(), dwln_bias.data_ptr(), pw2.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), B, T, D, K,
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "conv-module kernel")
    fused_conv_module.launches += 1
    return out


fused_conv_module.launches = 0


class FusedConvModule(torch.autograd.Function):
    """Differentiable fused conv module: ``FusedConvModule.apply(x, mask,
    ln_scale, ln_bias, pw1, dw, dwln_scale, dwln_bias, pw2)`` -> [B, T, D]
    f32, the arguments of :func:`conv_module_plain`.

    Forward: kernel K3 on the card, given bf16 copies of the current pw1
    and pw2 (a trainer's weights change every step, so no load-time copy
    can serve), or the plain version on the CPU. Backward: recompute
    :func:`conv_module_plain` under autograd and backpropagate through it,
    as the reference's ``_fused_conv_bwd`` differentiates its XLA twin; the
    mask gets no gradient.
    """

    @staticmethod
    def forward(ctx, x, mask, ln_scale, ln_bias, pw1, dw, dwln_scale,
                dwln_bias, pw2):
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, pw1, dw,
                              dwln_scale, dwln_bias, pw2)
        if x.is_cuda:
            pw1 = pw1.to(torch.bfloat16).contiguous()
            pw2 = pw2.to(torch.bfloat16).contiguous()
        return fused_conv_module(x, mask, ln_scale, ln_bias, pw1, dw,
                                 dwln_scale, dwln_bias, pw2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            args = [t.detach().requires_grad_(n) if n else t.detach()
                    for t, n in zip(saved, need)]
            out = conv_module_plain(*args)
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if n else None for n in need)


# ---------------------------------------------------------------------------
# Split over channels (tensor parallelism)
# ---------------------------------------------------------------------------

def moments(c: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [..., 2]: the mean and the sum of squared deviations
    over the last dimension."""
    mean = c.mean(dim=-1)
    m2 = ((c - mean[..., None]) ** 2).sum(dim=-1)
    return torch.stack([mean, m2], dim=-1)


def merge_moments(parts: torch.Tensor, count: int) -> torch.Tensor:
    """[..., n, 2] (mean, M2) of n equal groups of ``count`` values ->
    [..., 2] of their union, merged in group order by Chan et al.'s
    pairwise update (exact in algebra)."""
    mean, m2 = parts[..., 0, 0], parts[..., 0, 1]
    n_a = float(count)
    for i in range(1, parts.shape[-2]):
        n = n_a + count
        d = parts[..., i, 0] - mean
        mean = mean + d * (count / n)
        m2 = m2 + parts[..., i, 1] + d * d * (n_a * count / n)
        n_a = n
    return torch.stack([mean, m2], dim=-1)


def layernorm_from_moments(c, stats, scale, bias, width: int,
                           eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``c``'s channels by the statistics (``stats`` [..., 2]:
    mean, M2) of all ``width`` channels, with the channels' own scale and
    bias."""
    inv = torch.rsqrt(stats[..., 1:2] / width + eps)
    return (c - stats[..., 0:1]) * inv * scale + bias


def split_stage1_plain(x, mask, ln_scale, ln_bias, pw1, dw):
    """(i) on one shard: x [B, T, D] f32, pw1 [D, 2 DL] (value | gate
    columns of the shard's DL channels), dw [K, DL] -> (c [B, T, DL] f32,
    stats [B, T, 2]: each frame's mean and M2 over the DL channels)."""
    xf = x.to(torch.float32)
    dl = pw1.shape[1] // 2
    g = _bf16(_ln(xf, ln_scale, ln_bias)) @ _bf16(pw1)
    glu = g[..., :dl] * torch.sigmoid(g[..., dl:])
    glu = glu * mask.to(torch.float32)[:, :, None]
    c = _taps(glu, dw)
    return c, moments(c)


def split_finish_plain(c, stats_all, dwln_scale, dwln_bias, D: int):
    """(ii) on one shard: c [B, T, DL], every shard's statistics
    [B, T, n, 2], the shard's second-LN scale and bias [DL] -> a =
    bf16(SiLU(LN(c))) [B, T, DL] (bf16 values held in f32)."""
    st = merge_moments(stats_all, c.shape[-1])
    a = layernorm_from_moments(c, st, dwln_scale, dwln_bias, D)
    return _bf16(torch.nn.functional.silu(a))


def split_stage2_plain(a, pw2):
    """(iii) on one shard: a [B, T, DL] @ pw2 [DL, D] (bf16 in, f32
    accumulation) -> the shard's partial output [B, T, D]."""
    return _bf16(a) @ _bf16(pw2)


def split_stage1_kernel(x, mask, ln_scale, ln_bias, pw1, dw):
    """(i) on kernel K3's first stage (split mode); see
    :func:`split_stage1_plain`. pw1 bf16."""
    B, T, D = x.shape
    K, dl = dw.shape
    dev = x.device
    f32 = torch.float32
    if D % 64 or D > KERNEL_MAX_D or dl % 64 or D % dl or \
            K > KERNEL_MAX_TAPS:
        raise ValueError(f"the split conv-module kernel takes D % 64 == 0, "
                         f"D <= {KERNEL_MAX_D}, a shard's channels D / n "
                         f"% 64 == 0 and at most {KERNEL_MAX_TAPS} taps, "
                         f"got D={D}, D / n={dl}, K={K}")
    mask_i = mask.to(torch.int32).contiguous()
    cuda_build.check_tensor(x, "x", f32, (B, T, D), dev)
    cuda_build.check_tensor(mask_i, "mask", torch.int32, (B, T), dev)
    for name, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        cuda_build.check_tensor(t, name, f32, (D,), dev)
    cuda_build.check_tensor(pw1, "pw1", torch.bfloat16, (D, 2 * dl), dev)
    cuda_build.check_tensor(dw, "dw", f32, (K, dl), dev)
    lib = cuda_build.library()
    _, rp, tt, *_ = cuda_build.plan("omni_conv_split_plan", B, T, D, dl)
    scratch = torch.empty(B * -(-T // tt) * rp * D, dtype=torch.bfloat16,
                          device=dev)
    c = torch.empty((B, T, dl), dtype=f32, device=dev)
    stats = torch.empty((B, T, 2), dtype=f32, device=dev)
    err = lib.omni_conv_split_stage1(
        x.data_ptr(), mask_i.data_ptr(), ln_scale.data_ptr(),
        ln_bias.data_ptr(), pw1.data_ptr(), dw.data_ptr(), scratch.data_ptr(),
        c.data_ptr(), stats.data_ptr(), B, T, D, dl, K,
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "split conv-module kernel, stage 1")
    return c, stats


def split_finish_kernel(c, stats_all, dwln_scale, dwln_bias, D: int):
    """(ii) on ``conv_split_finish_kernel``; see :func:`split_finish_plain`.
    Returns a in bf16."""
    B, T, dl = c.shape
    n = stats_all.shape[-2]
    dev = c.device
    f32 = torch.float32
    stats_all = stats_all.contiguous()
    cuda_build.check_tensor(c, "c", f32, (B, T, dl), dev)
    cuda_build.check_tensor(stats_all, "stats", f32, (B, T, n, 2), dev)
    for name, t in (("dwln_scale", dwln_scale), ("dwln_bias", dwln_bias)):
        cuda_build.check_tensor(t, name, f32, (dl,), dev)
    a = torch.empty((B, T, dl), dtype=torch.bfloat16, device=dev)
    err = cuda_build.library().omni_conv_split_finish(
        c.data_ptr(), stats_all.data_ptr(), n, dwln_scale.data_ptr(),
        dwln_bias.data_ptr(), a.data_ptr(), B * T, dl, D,
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "split conv-module kernel, LayerNorm")
    return a


def split_stage2_kernel(a, pw2):
    """(iii) on K3's second stage without the residual; see
    :func:`split_stage2_plain`. a and pw2 bf16."""
    B, T, dl = a.shape
    D = pw2.shape[1]
    dev = a.device
    cuda_build.check_tensor(a, "a", torch.bfloat16, (B, T, dl), dev)
    cuda_build.check_tensor(pw2, "pw2", torch.bfloat16, (dl, D), dev)
    out = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    err = cuda_build.library().omni_conv_split_stage2(
        a.data_ptr(), pw2.data_ptr(), out.data_ptr(), B * T, dl, D,
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "split conv-module kernel, stage 2")
    return out


def _split(steps, xs, masks, ln_scales, ln_biases, pw1s, dws, dwln_scales,
           dwln_biases, pw2s) -> List[torch.Tensor]:
    stage1, finish, stage2 = steps
    n = len(xs)
    D = xs[0].shape[-1]
    cs, stats = [], []
    for m in range(n):
        with device_guard(xs[m]):
            c, st = stage1(xs[m], masks[m], ln_scales[m], ln_biases[m],
                           pw1s[m], dws[m])
        cs.append(c)
        stats.append(st[..., None, :])
    stats_all = all_gather(stats, dim=-2)        # [B, T, n, 2] a shard
    parts = []
    for m in range(n):
        with device_guard(xs[m]):
            a = finish(cs[m], stats_all[m], torch.chunk(dwln_scales[m], n)[m],
                       torch.chunk(dwln_biases[m], n)[m], D)
            parts.append(stage2(a, pw2s[m]))
    sums = psum(parts)
    out, seen = [], {}
    for x, s in zip(xs, sums):             # x once, on each distinct copy
        key = (id(x), id(s))
        if key not in seen:
            seen[key] = x.to(torch.float32) + s
        out.append(seen[key])
    return out


_PLAIN_STEPS = (split_stage1_plain, split_finish_plain, split_stage2_plain)
_KERNEL_STEPS = (split_stage1_kernel, split_finish_kernel,
                 split_stage2_kernel)


def conv_module_split_plain(xs: Sequence[torch.Tensor], masks, ln_scales,
                            ln_biases, pw1s, dws, dwln_scales, dwln_biases,
                            pw2s) -> List[torch.Tensor]:
    """The conv module split over n shards, on plain ops. Arguments are
    lists over the shards: x [B, T, D] f32 and mask [B, T] (replicated),
    the first LN's scale and bias [D] (replicated), pw1 [D, 2 D / n] (the
    shard's value columns, then its gate columns), dw [K, D / n], the
    second LN's scale and bias [D] (replicated; shard m reads its
    channels) and pw2 [D / n, D] (the shard's rows). Returns x + the sum
    of the shards' partials on each shard (shards of one device share
    it); :func:`conv_module_plain` of the whole weights up to f32 order."""
    return _split(_PLAIN_STEPS, xs, masks, ln_scales, ln_biases, pw1s, dws,
                  dwln_scales, dwln_biases, pw2s)


def fused_conv_module_split(xs: Sequence[torch.Tensor], masks, ln_scales,
                            ln_biases, pw1s, dws, dwln_scales, dwln_biases,
                            pw2s) -> List[torch.Tensor]:
    """The split conv module; see :func:`conv_module_split_plain`. CUDA
    tensors go to kernel K3's split launches (pw1 and pw2 bf16; D / n
    % 64 == 0), three a shard, counted one a shard; CPU tensors to the
    plain split."""
    if not xs[0].is_cuda:
        return conv_module_split_plain(xs, masks, ln_scales, ln_biases, pw1s,
                                       dws, dwln_scales, dwln_biases, pw2s)
    out = _split(_KERNEL_STEPS, xs, masks, ln_scales, ln_biases, pw1s, dws,
                 dwln_scales, dwln_biases, pw2s)
    fused_conv_module_split.launches += len(xs)
    return out


fused_conv_module_split.launches = 0


def _unique(outs: Sequence[torch.Tensor]):
    """(each distinct tensor once, in order; each entry's index into
    them)."""
    seen, uniq, where = {}, [], []
    for o in outs:
        if id(o) not in seen:
            seen[id(o)] = len(uniq)
            uniq.append(o)
        where.append(seen[id(o)])
    return uniq, where


class FusedConvModuleSplit(torch.autograd.Function):
    """Differentiable split conv module over all n shards:
    ``FusedConvModuleSplit.apply(n, *xs, *masks, *ln_scales, *ln_biases,
    *pw1s, *dws, *dwln_scales, *dwln_biases, *pw2s)`` -> the distinct
    results of :func:`conv_module_split_plain` (shards on one device share
    one; :func:`tp_convmod_apply_fused` maps them back to the shards).

    Forward: :func:`fused_conv_module_split` (K3's split launches on the
    card, given bf16 copies of pw1 and pw2, or the plain split on the
    CPU). Backward: recompute :func:`conv_module_split_plain` under
    autograd on the same inputs and backpropagate through it, as
    :class:`FusedConvModule` does for the whole module. An argument that
    is one tensor at several positions (a replicated activation or leaf on
    one device) is one input of the recompute, as in the forward, and its
    gradient is returned once; the masks get none."""

    @staticmethod
    def forward(ctx, n, *args):
        ctx.n = n
        first = {}
        ctx.first = [first.setdefault(id(a), i) for i, a in enumerate(args)]
        ctx.save_for_backward(*args)
        lists = [list(args[i * n:(i + 1) * n]) for i in range(9)]
        if lists[0][0].is_cuda:
            for k in (4, 8):            # pw1, pw2
                lists[k] = [w.to(torch.bfloat16).contiguous()
                            for w in lists[k]]
        uniq, where = _unique(fused_conv_module_split(*lists))
        ctx.where = where
        return tuple(uniq)

    @staticmethod
    def backward(ctx, *gouts):
        n = ctx.n
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        wants = {}
        for i, f in enumerate(ctx.first):
            wants[f] = wants.get(f, False) or need[i]
        with torch.enable_grad():
            inputs = {f: saved[f].detach().requires_grad_(wants[f])
                      for f in wants}
            args = [inputs[f] for f in ctx.first]
            lists = [args[i * n:(i + 1) * n] for i in range(9)]
            uniq, where = _unique(conv_module_split_plain(*lists))
            if where != ctx.where:
                raise RuntimeError("the split conv module's recompute "
                                   "shares its results otherwise than its "
                                   "forward")
            wrt = [f for f in wants if wants[f]]
            grads = torch.autograd.grad(
                uniq, [inputs[f] for f in wrt],
                [torch.zeros_like(u) if g is None else g
                 for u, g in zip(uniq, gouts)], allow_unused=True)
        by_first = dict(zip(wrt, grads))
        out = [by_first.get(f) if f == i else None
               for i, f in enumerate(ctx.first)]
        return (None, *out)


def tp_convmod_apply_fused(ps, xs, masks) -> List[torch.Tensor]:
    """The conv module over the model shards' ``conv`` trees ``ps``
    (``layers.convmod_spec``'s placement) through
    :func:`fused_conv_module_split`. Where gradients are taken it runs
    through :class:`FusedConvModuleSplit` (K3's split launches forward,
    autograd of the plain split backward) with the f32 weights; serving
    passes pw1 and pw2 as they are held, bf16 on the card already (the
    engine holds them so from load time), others rounded here each
    call. One shard (a mesh's model axis of 1) is the whole module, kernel
    K3 (:func:`convmod_apply_fused`)."""
    if len(ps) == 1:
        return [convmod_apply_fused(ps[0], xs[0], masks[0])]
    xs = [x.to(torch.float32).contiguous() for x in xs]
    args = [xs, masks,
            [p["ln"]["scale"] for p in ps], [p["ln"]["bias"] for p in ps],
            [dense_weight(p["pw1"]) for p in ps], [p["dw"] for p in ps],
            [p["dw_ln"]["scale"] for p in ps], [p["dw_ln"]["bias"] for p in ps],
            [dense_weight(p["pw2"]) for p in ps]]
    if torch.is_grad_enabled() and any(
            t.requires_grad for a in args for t in a):
        uniq = FusedConvModuleSplit.apply(len(xs),
                                          *[t for a in args for t in a])
        order = {}
        where = [order.setdefault((id(x), x.device), len(order))
                 for x in xs]
        return [uniq[w] for w in where]
    for k in (4, 8):
        args[k] = [w.to(torch.bfloat16).contiguous() if x.is_cuda else w
                   for w, x in zip(args[k], xs)]
    return fused_conv_module_split(*args)


def dense_weight(leaf) -> torch.Tensor:
    """A pointwise weight from a plain or quantized leaf: ``f32(w_q) *
    w_scale`` in f32, as the reference's ``_dense_weight`` (the kernel then
    rounds it to bf16; the dense layers' dequantization is another one)."""
    if "w_q" in leaf:
        return leaf["w_q"].to(torch.float32) * leaf["w_scale"][None, :]
    return leaf["w"]


def convmod_apply_fused(p, x, mask):
    """Drop-in for ``models.layers.convmod_apply`` through the fused path
    (differentiable, :class:`FusedConvModule`)."""
    return FusedConvModule.apply(
        x.to(torch.float32).contiguous(), mask,
        p["ln"]["scale"], p["ln"]["bias"], dense_weight(p["pw1"]), p["dw"],
        p["dw_ln"]["scale"], p["dw_ln"]["bias"], dense_weight(p["pw2"]))
