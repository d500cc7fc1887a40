"""Flash-attention forward: kernel K2 and its plain PyTorch version.

Port of the forward of ``omnilingual_asr_tpu/ops/attention.py``
(``_flash_fwd_lse_kernel`` via ``_fwd_lse``): non-causal attention with a
key-validity mask, scale 1/sqrt(D), f32 softmax, output in q's dtype (bf16)
and the row logsumexp. A fully-masked query row (a padded batch slot) gets
output 0 and lse +1e30.

``flash_attention`` launches the CUDA kernel (``csrc/attention.cu``) for CUDA
tensors and runs ``flash_attention_plain`` for CPU tensors. Layouts follow
the caller: q, k, v [B, T, H, D], mask [B, T], lse [B, H, T].
"""

from __future__ import annotations

import math

import torch

from . import cuda_build

NEG_INF = -1e30
#: Query-block length of the reference kernel. The JAX engine routes
#: attention through its flash kernel only when the subsampled window
#: length is a multiple of it (engine.py:364-365); the port's engine keeps
#: that rule so that it takes the same numerical path as the reference.
REFERENCE_BLOCK_Q = 256
#: Head dimension the CUDA kernel is built for.
KERNEL_HEAD_DIM = 64


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor):
    """Flash attention forward; see :func:`flash_attention_plain`.

    A CUDA tensor goes to kernel K2 (bf16 q/k/v, head dim 64); a CPU
    tensor to the plain version.
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    B, T, H, D = q.shape
    dev = q.device
    bf16 = torch.bfloat16
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"flash kernel takes head dim {KERNEL_HEAD_DIM}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_build.check_tensor(t, name, bf16, (B, T, H, D), dev)
    mask_i = mask.to(torch.int32).contiguous()
    cuda_build.check_tensor(mask_i, "mask", torch.int32, (B, T), dev)
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
