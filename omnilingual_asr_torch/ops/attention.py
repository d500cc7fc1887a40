"""Flash attention: kernels K2 (forward), K6 (dQ) and K7 (dK/dV), their
plain PyTorch versions, and the autograd Function that joins them.

Port of ``omnilingual_asr_tpu/ops/attention.py``: non-causal attention with
a key-validity mask, scale 1/sqrt(D), f32 softmax, output in q's dtype
(bf16) and the row logsumexp (``_flash_fwd_lse_kernel`` via ``_fwd_lse``);
its backward recomputes ``p = exp(s - lse) * keymask`` from the forward's
lse (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``), with
``delta = sum_d dO * O`` computed outside the kernels. A fully-masked query
row (a padded batch slot) gets output 0, lse +1e30 and zero gradients.

Each wrapper launches its CUDA kernel (``csrc/attention.cu``,
``csrc/attention_bwd.cu``) for CUDA tensors and runs its plain version for
CPU tensors. Layouts follow the caller: q, k, v, o, dO [B, T, H, D], mask
[B, T], lse and delta [B, H, T]. :class:`FlashAttention` is the
differentiable entry point that the model calls.
"""

from __future__ import annotations

import math

import torch

from . import cuda_build

NEG_INF = -1e30
#: Query-block length of the reference kernel. The JAX engine routes
#: attention through its flash kernel only when the subsampled window
#: length is a multiple of it (engine.py:364-365); the port's engine and
#: trainer keep that rule so that they take the same numerical path as the
#: reference.
REFERENCE_BLOCK_Q = 256
#: Head dimensions the CUDA kernels are instantiated for.
KERNEL_HEAD_DIMS = (64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor):
    """q, k, v [B, T, H, D]; mask [B, T] bool -> (o [B, T, H, D] in q's
    dtype, lse [B, H, T] f32). Same function as the kernel, in one pass."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf = q.to(torch.float32) * scale
    s = torch.einsum("bthd,bshd->bhts", qf, k.to(torch.float32))
    valid = mask.to(torch.bool)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p, v.to(torch.float32))
    denom = torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]
    out = (out / denom).to(q.dtype)
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, 1e30))
    return out, lse


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum_d dO * O in f32: o, do [B, T, H, D] -> [B, H, T]. Plain
    PyTorch, as the reference computes it outside its kernels."""
    d = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
    return d.permute(0, 2, 1).contiguous()


def _recompute(q, k, v, mask, do, lse, delta):
    """The backward's f32 intermediates: (p, ds) [B, H, T, T]."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    s = torch.einsum("bthd,bshd->bhts", q.to(f32), k.to(f32)) * scale
    valid = mask.to(torch.bool)[:, None, None, :]
    p = torch.exp(s - lse[..., None]) * valid
    dp = torch.einsum("bthd,bshd->bhts", do.to(f32), v.to(f32))
    ds = p * (dp - delta[..., None])
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta):
    """dQ [B, T, H, D] in q's dtype; same function as kernel K6."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _recompute(q, k, v, mask, do, lse, delta)
    dq = torch.einsum("bhts,bshd->bthd", ds, k.to(torch.float32)) * scale
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta):
    """(dK, dV) [B, T, H, D] in k's and v's dtypes; same function as
    kernel K7."""
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _recompute(q, k, v, mask, do, lse, delta)
    dk = torch.einsum("bhts,bthd->bshd", ds, q.to(f32)) * scale
    dv = torch.einsum("bhts,bthd->bshd", p, do.to(f32))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, mask, o, lse, do):
    """The whole backward from the forward's o and lse: (dq, dk, dv) in
    q's dtype. Recomputes p from lse; does not call autograd."""
    delta = flash_delta(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    return dq, dk, dv


def _check_kernel_args(q, k, v, mask, extra=()):
    """Validate the operands every flash kernel reads; returns
    (B, T, H, D, int32 mask)."""
    B, T, H, D = q.shape
    dev = q.device
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head dim in {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        cuda_build.check_tensor(t, name, torch.bfloat16, (B, T, H, D), dev)
    mask_i = mask.to(torch.int32).contiguous()
    cuda_build.check_tensor(mask_i, "mask", torch.int32, (B, T), dev)
    return B, T, H, D, mask_i


def _check_rows(lse, delta, B, H, T, dev):
    cuda_build.check_tensor(lse, "lse", torch.float32, (B, H, T), dev)
    cuda_build.check_tensor(delta, "delta", torch.float32, (B, H, T), dev)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor):
    """Flash attention forward; see :func:`flash_attention_plain`.

    A CUDA tensor goes to kernel K2 (bf16 q/k/v, head dim 64 or 128); a CPU
    tensor to the plain version. Returns (o, lse); not differentiable (use
    :class:`FlashAttention`).
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    B, T, H, D, mask_i = _check_kernel_args(q, k, v, mask)
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    lib = cuda_build.library()
    err = lib.omni_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             mask_i.data_ptr(), out.data_ptr(),
                             lse.data_ptr(), B, T, H, D,
                             1.0 / math.sqrt(D), cuda_build.stream_ptr(dev))
    cuda_build.check(err, "flash-attention kernel")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd_dq(q, k, v, mask, do, lse, delta) -> torch.Tensor:
    """dQ; see :func:`flash_attention_bwd_dq_plain`. A CUDA tensor goes to
    kernel K6 (bf16 q/k/v/dO, f32 lse/delta [B, H, T]); a CPU tensor to the
    plain version."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta)
    B, T, H, D, mask_i = _check_kernel_args(q, k, v, mask, (("do", do),))
    dev = q.device
    _check_rows(lse, delta, B, H, T, dev)
    dq = torch.empty_like(q)
    lib = cuda_build.library()
    err = lib.omni_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, T, H, D, 1.0 / math.sqrt(D), cuda_build.stream_ptr(dev))
    cuda_build.check(err, "flash-attention dQ kernel")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta):
    """(dK, dV); see :func:`flash_attention_bwd_dkv_plain`. A CUDA tensor
    goes to kernel K7 (arguments as K6's); a CPU tensor to the plain
    version."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    B, T, H, D, mask_i = _check_kernel_args(q, k, v, mask, (("do", do),))
    dev = q.device
    _check_rows(lse, delta, B, H, T, dev)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = cuda_build.library()
    err = lib.omni_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, D, 1.0 / math.sqrt(D),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, "flash-attention dK/dV kernel")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    mask) -> o`` [B, T, H, D] in q's dtype.

    Forward: K2 (or its plain version on the CPU), saving o and lse.
    Backward: delta in plain PyTorch, then K6 and K7 (or their plain
    versions); gradients in q's dtype from f32 sums, none for the mask.
    Under ``torch.inference_mode`` nothing is saved and it costs nothing
    beyond the forward.
    """

    @staticmethod
    def forward(ctx, q, k, v, mask):
        o, lse = flash_attention(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = flash_delta(o, do)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_attention_bwd_dq(q, k, v, mask, do, lse, delta)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta)
        return dq, dk, dv, None
