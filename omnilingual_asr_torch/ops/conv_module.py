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
"""

from __future__ import annotations

import torch

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


def conv_module_plain(x, mask, ln_scale, ln_bias, pw1, dw, dwln_scale,
                      dwln_bias, pw2):
    """x [B, T, D] f32, mask [B, T] bool -> [B, T, D] f32."""
    xf = x.to(torch.float32)
    D = xf.shape[-1]
    T = xf.shape[1]
    h = _ln(xf, ln_scale, ln_bias)
    g = _bf16(h) @ _bf16(pw1)
    glu = g[..., :D] * torch.sigmoid(g[..., D:])
    glu = glu * mask.to(torch.float32)[:, :, None]
    K = dw.shape[0]
    pad_l = (K - 1) // 2
    padded = torch.nn.functional.pad(glu, (0, 0, pad_l, K - 1 - pad_l))
    out = torch.zeros_like(glu)
    for k in range(K):
        out = out + padded[:, k:k + T, :] * dw[k][None, None, :]
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
