"""Flash attention: kernels K2 (forward), K6 (dQ) and K7 (dK/dV), their
plain PyTorch versions, and the autograd Function that joins them.

Port of ``omnilingual_asr_tpu/ops/attention.py``: non-causal attention with
a key-validity mask, scale 1/sqrt(D), f32 softmax, output in q's dtype
(bf16, f16 or f32) and the row logsumexp (``_flash_fwd_lse_kernel`` via
``_fwd_lse``);
its backward recomputes ``p = exp(s - lse) * keymask`` from the forward's
lse (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``), with
``delta = sum_d dO * O`` computed outside the kernels. A fully-masked query
row (a padded batch slot) gets output 0, lse +1e30 and zero gradients.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. The Pallas kernels are generic in their input
type, so each entry point dispatches on q's dtype: bf16 to the tensor-core
kernels (``csrc/attention.cu``, ``csrc/attention_bwd.cu``), f32 (the f32
encoder, ``EncoderConfig.dtype == "float32"``) to their f32 variants
(``csrc/attention_f32.cu``: ``flash_attention_f32``,
``flash_attention_bwd_dq_f32`` and ``flash_attention_bwd_dkv_f32``, all on
TF32 tensor cores, three products a product; their arithmetic in plain
PyTorch: ``flash_attention_fwd_tf32_emulated`` and
``flash_attention_bwd_tf32_emulated``), and f16 (the f16 encoder,
``EncoderConfig.dtype == "float16"``) to the kernels built over f16
operands (``flash_attention_f16``: ``csrc/attention_f16.cu``, on Hopper's
wgmma and TMA, P x 2^14 split as f16 hi + lo against V native;
``flash_attention_bwd_dq_f16`` and
``flash_attention_bwd_dkv_f16``: every product on f16 tensor cores, P and
dS split as f16 hi + lo under exact power-of-two scales; their arithmetic
in plain PyTorch: ``flash_attention_fwd_f16_emulated`` and
``flash_attention_bwd_f16_emulated``). Each kernel keeps its own launch
count, so a count says which dtype ran. Layouts follow the caller: q, k,
v, o, dO [B, T, H, D], mask [B, T], lse and delta [B, H, T].
:class:`FlashAttention` is the differentiable entry point that the model
calls.
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


#: Keys a tile of kernel K2 holds (``BK`` in ``csrc/attention.cu``).
KERNEL_KEY_TILE = 64


def _hi_lo(x: torch.Tensor, dtype=torch.bfloat16):
    """x = hi + lo as two ``dtype`` values held in f32: hi = dtype(x), lo =
    dtype(x - hi). In bf16, f32's exponent range; an f16 value splits so
    exactly."""
    f32 = torch.float32
    hi = x.to(dtype).to(f32)
    return hi, (x - hi).to(dtype).to(f32)


def _emulated_fwd(q, k, v, mask, pv):
    """Kernel K2's tile loop in plain PyTorch: keys in tiles of
    ``KERNEL_KEY_TILE`` with an f32 online softmax, s = (q k^T) * scale over
    q's values, and ``pv(p, v_tile)`` the f32 P V product of a tile as the
    kernel takes it. Returns (o f32 [B, T, H, D], lse)."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qf, kf, vf = (x.to(f32).permute(0, 2, 1, 3) for x in (q, k, v))
    acc = torch.zeros((B, H, T, D), dtype=f32, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, T), dtype=f32, device=q.device)
    for j0 in range(0, T, KERNEL_KEY_TILE):
        kt = kf[:, :, j0:j0 + KERNEL_KEY_TILE]
        vt = vf[:, :, j0:j0 + KERNEL_KEY_TILE]
        valid = mask[:, j0:j0 + KERNEL_KEY_TILE].to(torch.bool)[
            :, None, None, :]
        s = (qf @ kt.transpose(-1, -2)) * scale
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + pv(p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, 1e30))
    return out.permute(0, 2, 1, 3), lse


def flash_attention_emulated(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor,
                             split_p: bool = True):
    """Kernel K2's arithmetic in plain PyTorch, to predict on the CPU what
    its bf16 tensor-core products do to the result: keys in tiles of
    ``KERNEL_KEY_TILE`` with an f32 online softmax, s = (q k^T) * scale
    over bf16 inputs, and P rounded to bf16 for the P V product, either as
    hi + lo (``split_p``, hi = bf16(p), lo = bf16(p - hi), two products, as
    the kernel does) or as hi alone. The running sum takes the f32 p.
    Same arguments and results as :func:`flash_attention_plain`; bf16
    operands only (the f32 forward rounds nothing)."""
    _bf16_only(q)

    def pv(p, vt):
        hi, lo = _hi_lo(p)
        return hi @ vt + lo @ vt if split_p else hi @ vt

    out, lse = _emulated_fwd(q, k, v, mask, pv)
    return out.to(q.dtype), lse


def _bf16_only(q: torch.Tensor) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the emulated kernels model bf16 tensor cores; got "
                        f"{q.dtype} operands")


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


#: Operands of the backward's second products that kernels K6 and K7 feed
#: their bf16 tensor cores as hi + lo halves (two products) rather than as
#: one bf16 value: "p" for dV = P^T dO, "ds" for dQ = dS K and dK = dS^T Q.
KERNEL_BWD_SPLIT = ("p", "ds")


def flash_attention_bwd_emulated(q, k, v, mask, do, lse, delta,
                                 split=KERNEL_BWD_SPLIT):
    """Kernels K6 and K7's arithmetic in plain PyTorch, to predict on the
    CPU what their bf16 tensor-core products do to the gradients. s and dp
    are f32 sums of exact bf16 products, as in the plain version; p and ds
    are then rounded to bf16 for the products that take them, either as
    hi + lo (operands named in ``split``: hi = bf16(x), lo = bf16(x - hi),
    two products, as the kernels do) or as hi alone. Sums in f32; dQ and
    dK times ``scale`` once, after the sum. Same arguments and results as
    :func:`flash_attention_bwd_dq_plain` and
    :func:`flash_attention_bwd_dkv_plain` together: (dq, dk, dv); bf16
    operands only."""
    _bf16_only(q)
    f32 = torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _recompute(q, k, v, mask, do, lse, delta)

    def parts(x, name):
        return _hi_lo(x) if name in split else _hi_lo(x)[:1]

    qf, kf, dof = (t.to(f32) for t in (q, k, do))
    dq = sum(torch.einsum("bhts,bshd->bthd", x, kf)
             for x in parts(ds, "ds")) * scale
    dk = sum(torch.einsum("bhts,bthd->bshd", x, qf)
             for x in parts(ds, "ds")) * scale
    dv = sum(torch.einsum("bhts,bthd->bshd", x, dof) for x in parts(p, "p"))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (10 mantissa bits; ties away from
    zero), as an f32 tensor: ``cvt.rna.tf32.f32`` with the 13 low bits
    cleared, by bit operations on an int32 view (finite values)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32x3(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int):
    """einsum(eq, a, b) as the f32 K2, K6 and K7 take it: a = a_hi + a_lo,
    b = b_hi + b_lo (hi = tf32(x), lo = tf32(x - hi)), summed as
    a_hi b_lo + a_lo b_hi + a_hi b_hi (``terms`` 3) or a_hi b_hi alone
    (``terms`` 1: one TF32 product)."""
    ah, bh = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        small = (torch.einsum(eq, ah, tf32_round(b - bh))
                 + torch.einsum(eq, tf32_round(a - ah), bh))
        out = small + out
    elif terms != 1:
        raise ValueError(f"terms must be 3 or 1, got {terms}")
    return out


def _f32_only(q: torch.Tensor) -> None:
    if q.dtype != torch.float32:
        raise TypeError(f"the TF32 emulation models the f32 kernels; got "
                        f"{q.dtype} operands")


def flash_attention_fwd_tf32_emulated(q, k, v, mask, terms: int = 3):
    """The f32 kernel K2's arithmetic (``csrc/attention_f32.cu``) in plain
    PyTorch, to show on the CPU what its TF32 tensor-core products do to o
    and lse: s = (q scale) k^T and o = p v, each from operands rounded to
    tf32 and split as hi + lo, three products summed in f32
    (:func:`_tf32x3`; ``terms=1`` keeps only hi hi), with q times scale
    rounded to f32 first and the softmax in f32 in one pass (the kernel's
    online softmax, its order of sums and the tensor cores' truncation
    inside a product are not modelled). Same arguments and results as
    :func:`flash_attention_plain`; f32 operands only."""
    _f32_only(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _tf32x3("bthd,bshd->bhts", q * scale, k, terms)
    valid = mask.to(torch.bool)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1)
    out = _tf32x3("bhts,bshd->bthd", p, v, terms)
    out = out / torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, 1e30))
    return out, lse


def flash_attention_bwd_tf32_emulated(q, k, v, mask, do, lse, delta,
                                      terms: int = 3):
    """The f32 kernels K6 and K7's arithmetic (``csrc/attention_f32.cu``)
    in plain PyTorch, to show on the CPU what their TF32 tensor-core
    products do to the gradients: each of the five products (S = Q K^T,
    dP = dO V^T, dQ = dS K, dV = P^T dO, dK = dS^T Q) from operands
    rounded to tf32 and split as hi + lo, three products summed in f32
    (:func:`_tf32x3`; ``terms=1`` keeps only hi hi). The kernels' order of
    sums and the tensor cores' truncation inside a product are not
    modelled. Same arguments and results as
    :func:`flash_attention_bwd_dq_plain` and
    :func:`flash_attention_bwd_dkv_plain` together: (dq, dk, dv), f32
    operands only."""
    _f32_only(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _tf32x3("bthd,bshd->bhts", q, k, terms) * scale
    p = torch.exp(s - lse[..., None]) * mask.to(torch.bool)[:, None, None, :]
    dp = _tf32x3("bthd,bshd->bhts", do, v, terms)
    ds = p * (dp - delta[..., None])
    dq = _tf32x3("bhts,bshd->bthd", ds, k, terms) * scale
    dk = _tf32x3("bhts,bthd->bshd", ds, q, terms) * scale
    dv = _tf32x3("bhts,bthd->bshd", p, do, terms)
    return dq, dk, dv


def _f16_only(q: torch.Tensor) -> None:
    if q.dtype != torch.float16:
        raise TypeError(f"the f16 emulation models the f16 kernels; got "
                        f"{q.dtype} operands")


#: The f16 K2, K6 and K7's scales (``csrc/attention_f16.cu``,
#: ``csrc/attention_bwd.cu``): P times 2^F16_P_EXP for O = P V and
#: dV = P^T dO; dS under an exponent e a row of the
#: accumulator (a query of dQ, a key of dK), which starts at
#: F16_EXP_START and, at a step whose largest |dS| of the row m has
#: floor(log2 m) + e >= F16_EXP_LIMIT, drops to F16_EXP_RESET -
#: floor(log2 m) (the row's accumulator scaled by the same exact power of
#: two).
F16_P_EXP = 14
F16_EXP_START = 64
F16_EXP_LIMIT = 15
F16_EXP_RESET = 10


def _f16_row_exponents(ds: torch.Tensor, dim: int) -> torch.Tensor:
    """The f16 K6 and K7's dS exponent of each row of ``ds`` (f32), the
    rows running along ``dim`` (the contraction's: -1 for dQ = dS K, -2
    for dK = dS^T Q), kept as a dimension of size 1: the rule above for
    the row's largest |dS| taken in one step, the smallest exponent that
    the kernels' running one can end at (the coarsest split). Rows of
    zeros keep F16_EXP_START."""
    m = ds.abs().amax(dim=dim, keepdim=True)
    lg = (torch.frexp(m).exponent - 1).to(torch.float32)  # floor(log2 m)
    drop = (m > 0) & (lg + F16_EXP_START >= F16_EXP_LIMIT)
    return torch.where(drop, F16_EXP_RESET - lg,
                       torch.full_like(lg, F16_EXP_START))


def _f16_scaled_product(eq: str, a: torch.Tensor, b: torch.Tensor, exp,
                        b_exact: bool, trunc: bool = False) -> torch.Tensor:
    """einsum(eq, a, b) as the f16 K2, K6 and K7 take a second product: the
    f32 a (P or dS) times 2^exp (a number, or exponents broadcast over a)
    split as f16 hi + lo, the f16 b as it is (``b_exact=False``: rounded
    to bf16), a_hi b + a_lo b summed in f32 and times 2^-exp (exact). The
    split rounds hi to f16 (K6, K7) or, with ``trunc`` (K2), clears the 13
    low mantissa bits of a 2^exp (h) and takes hi = f16(h), lo = f16(a 2^exp
    - h)."""
    two = torch.exp2(torch.as_tensor(exp, dtype=torch.float32))
    if trunc:
        x = (a * two).contiguous()
        h = (x.view(torch.int32) & -0x2000).view(torch.float32)
        hi = h.to(torch.float16).to(torch.float32)
        lo = (x - h).to(torch.float16).to(torch.float32)
    else:
        hi, lo = _hi_lo(a * two, torch.float16)
    bf = b.to(torch.float32 if b_exact else torch.bfloat16).to(torch.float32)
    return torch.einsum(eq, hi / two, bf) + torch.einsum(eq, lo / two, bf)


def flash_attention_fwd_f16_emulated(q, k, v, mask, v_exact: bool = True):
    """The f16 kernel K2's arithmetic (``csrc/attention_f16.cu``) in plain
    PyTorch, to show on the CPU what its products do to o and lse: the key
    tiles and online softmax of :func:`flash_attention_emulated`, s an f32
    sum of exact products of the f16 values, and P V as
    :func:`_f16_scaled_product` takes it: p times 2^F16_P_EXP split as f16
    hi (p 2^14 with its 13 low mantissa bits cleared) + lo against V exact,
    two products summed in f32 (the running sum takes the same p, so the
    scale cancels). The kernel's exp2 of the scaled score (the scale in
    its argument), its order of sums and the tensor cores' truncation
    inside a product are not modelled. On
    ``tests/test_torch_f16.py``'s ragged case ([3, 200, 2, D]) the model
    differs from the plain version by 3.1e-7 and 4.1e-7 of max|o| in f32
    at D 64 and 128 and uses 0.60 and 0.72 of the card's gate
    (``card_cases.TOL_F16_*``) once rounded to f16. Planted fault:
    ``v_exact=False``, V rounded to bf16 (the bf16 kernel's arithmetic),
    2.9e-3 and 2.8e-3 of max|o|, 8.5 and 12.5 of the gate. P split in
    f16 without the scale (its lo half leaves f16's normal range for
    p < 2^-3) is no planted fault: on that case it reads as the model,
    0.60 and 0.72 of the gate, because the p it flushes are too small to
    move o. Same arguments and results as :func:`flash_attention_plain`;
    f16 operands only."""
    _f16_only(q)
    out, lse = _emulated_fwd(q, k, v, mask, lambda p, vt: _f16_scaled_product(
        "bhts,bhsd->bhtd", p, vt, F16_P_EXP, v_exact, trunc=True))
    return out.to(q.dtype), lse


def flash_attention_bwd_f16_emulated(q, k, v, mask, do, lse, delta,
                                     ds_exp=None, b_exact: bool = True):
    """The f16 kernels K6 and K7's arithmetic (``csrc/attention_bwd.cu`` at
    F16) in plain PyTorch, to show on the CPU what their products do to
    the gradients: S and dP f32 sums of exact products of the f16 values
    (as in the plain version), then dV = P^T dO with P times 2^F16_P_EXP,
    and dQ = dS K and dK = dS^T Q with dS under its rows' exponents
    (:func:`_f16_row_exponents`: queries for dQ, keys for dK), each as
    :func:`_f16_scaled_product` takes it; dQ and dK times ``scale`` after
    the sum. Planted faults: ``ds_exp`` a number, one fixed exponent for
    every dS (0: the unscaled f16 split, which flushes at small dO; a
    fixed scale that holds dO x 1 overflows f16 at large dO), and
    ``b_exact=False`` (the f16 operand rounded to bf16). The kernels' order
    of sums, their running exponents (finer than the model's where a
    row's |dS| grows across steps) and the tensor cores' truncation
    inside a product are not modelled. Same arguments and results as
    :func:`flash_attention_bwd_dq_plain` and
    :func:`flash_attention_bwd_dkv_plain` together: (dq, dk, dv), f16
    operands only."""
    _f16_only(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _recompute(q, k, v, mask, do, lse, delta)

    def exp(dim):
        return _f16_row_exponents(ds, dim) if ds_exp is None else ds_exp

    dq = _f16_scaled_product("bhts,bshd->bthd", ds, k, exp(-1),
                             b_exact) * scale
    dk = _f16_scaled_product("bhts,bthd->bshd", ds, q, exp(-2),
                             b_exact) * scale
    dv = _f16_scaled_product("bhts,bthd->bshd", p, do, F16_P_EXP, b_exact)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, mask, o, lse, do):
    """The whole backward from the forward's o and lse: (dq, dk, dv) in
    q's dtype. Recomputes p from lse; does not call autograd."""
    delta = flash_delta(o, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    return dq, dk, dv


#: The dtypes the flash kernels take: bf16 (K2, K6, K7 on the tensor
#: cores), f32 (their variants, on TF32 tensor cores) and f16 (their
#: variants over f16 operands, on f16 tensor cores).
KERNEL_DTYPES = (torch.bfloat16, torch.float32, torch.float16)


def _check_kernel_args(q, k, v, mask, extra=(), dtype=torch.bfloat16):
    """Validate the operands a flash kernel of ``dtype`` reads (q, k, v and
    ``extra``'s (name, tensor) pairs each against ``dtype``, the mask
    against int32); returns (B, T, H, D, int32 mask)."""
    B, T, H, D = q.shape
    dev = q.device
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head dim in {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        cuda_build.check_tensor(t, name, dtype, (B, T, H, D), dev)
    mask_i = mask.to(torch.int32).contiguous()
    cuda_build.check_tensor(mask_i, "mask", torch.int32, (B, T), dev)
    return B, T, H, D, mask_i


def _check_rows(lse, delta, B, H, T, dev):
    cuda_build.check_tensor(lse, "lse", torch.float32, (B, H, T), dev)
    cuda_build.check_tensor(delta, "delta", torch.float32, (B, H, T), dev)


def _kernel_dtype(q: torch.Tensor) -> torch.dtype:
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash kernels take q in {KERNEL_DTYPES}, got "
                        f"{q.dtype}")
    return q.dtype


def _launch_fwd(entry, dtype, q, k, v, mask):
    B, T, H, D, mask_i = _check_kernel_args(q, k, v, mask, dtype=dtype)
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    err = getattr(cuda_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, H, D, 1.0 / math.sqrt(D),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, f"flash-attention kernel ({entry})")
    return out, lse


def _launch_dq(entry, dtype, q, k, v, mask, do, lse, delta):
    B, T, H, D, mask_i = _check_kernel_args(q, k, v, mask, (("do", do),),
                                            dtype)
    dev = q.device
    _check_rows(lse, delta, B, H, T, dev)
    dq = torch.empty_like(q)
    err = getattr(cuda_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, T, H, D, 1.0 / math.sqrt(D), cuda_build.stream_ptr(dev))
    cuda_build.check(err, f"flash-attention dQ kernel ({entry})")
    return dq


def _launch_dkv(entry, dtype, q, k, v, mask, do, lse, delta):
    B, T, H, D, mask_i = _check_kernel_args(q, k, v, mask, (("do", do),),
                                            dtype)
    dev = q.device
    _check_rows(lse, delta, B, H, T, dev)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = getattr(cuda_build.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, D, 1.0 / math.sqrt(D),
        cuda_build.stream_ptr(dev))
    cuda_build.check(err, f"flash-attention dK/dV kernel ({entry})")
    return dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor):
    """Flash attention forward; see :func:`flash_attention_plain`.

    A CUDA tensor goes to kernel K2 (bf16 q/k/v, head dim 64 or 128), or
    at f32 to :func:`flash_attention_f32`, at f16 to
    :func:`flash_attention_f16`; a CPU tensor to the plain version.
    Returns (o, lse); not differentiable (use :class:`FlashAttention`).
    """
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    dtype = _kernel_dtype(q)
    if dtype == torch.float32:
        return flash_attention_f32(q, k, v, mask)
    if dtype == torch.float16:
        return flash_attention_f16(q, k, v, mask)
    out = _launch_fwd("omni_flash_fwd", torch.bfloat16, q, k, v, mask)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor):
    """K2 at f32 (``csrc/attention_f32.cu``: 3xTF32 ``mma.sync``, its
    rounding modelled by :func:`flash_attention_fwd_tf32_emulated`): f32
    q/k/v, head dim 64 or 128, for a CUDA tensor; the plain version for a
    CPU tensor."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    out = _launch_fwd("omni_flash_fwd_f32", torch.float32, q, k, v, mask)
    flash_attention_f32.launches += 1
    return out


flash_attention_f32.launches = 0


def flash_attention_f16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor):
    """K2 at f16 (``csrc/attention_f16.cu``: TMA copies and wgmma
    products, its rounding modelled by
    :func:`flash_attention_fwd_f16_emulated`): f16 q/k/v, head dim 64 or
    128, each 16-byte aligned (TMA's rule; a misaligned operand raises),
    for a CUDA tensor; the plain version for a CPU tensor."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask)
    out = _launch_fwd("omni_flash_fwd_f16", torch.float16, q, k, v, mask)
    flash_attention_f16.launches += 1
    return out


flash_attention_f16.launches = 0


def flash_attention_bwd_dq(q, k, v, mask, do, lse, delta) -> torch.Tensor:
    """dQ; see :func:`flash_attention_bwd_dq_plain`. A CUDA tensor goes to
    kernel K6 (bf16 q/k/v/dO, f32 lse/delta [B, H, T]), or at f32 to
    :func:`flash_attention_bwd_dq_f32`, at f16 to
    :func:`flash_attention_bwd_dq_f16`; a CPU tensor to the plain
    version."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta)
    dtype = _kernel_dtype(q)
    if dtype == torch.float32:
        return flash_attention_bwd_dq_f32(q, k, v, mask, do, lse, delta)
    if dtype == torch.float16:
        return flash_attention_bwd_dq_f16(q, k, v, mask, do, lse, delta)
    dq = _launch_dq("omni_flash_bwd_dq", torch.bfloat16, q, k, v, mask, do,
                    lse, delta)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dq_f32(q, k, v, mask, do, lse, delta
                               ) -> torch.Tensor:
    """K6 at f32 (``csrc/attention_f32.cu``: 3xTF32 ``mma.sync``) for a
    CUDA tensor; the plain version for a CPU tensor."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta)
    dq = _launch_dq("omni_flash_bwd_dq_f32", torch.float32, q, k, v, mask,
                    do, lse, delta)
    flash_attention_bwd_dq_f32.launches += 1
    return dq


flash_attention_bwd_dq_f32.launches = 0


def flash_attention_bwd_dq_f16(q, k, v, mask, do, lse, delta
                               ) -> torch.Tensor:
    """K6 at f16 (``csrc/attention_bwd.cu`` over f16 operands, its
    rounding modelled by :func:`flash_attention_bwd_f16_emulated`) for a
    CUDA tensor; the plain version for a CPU tensor."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_plain(q, k, v, mask, do, lse, delta)
    dq = _launch_dq("omni_flash_bwd_dq_f16", torch.float16, q, k, v, mask,
                    do, lse, delta)
    flash_attention_bwd_dq_f16.launches += 1
    return dq


flash_attention_bwd_dq_f16.launches = 0


def flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta):
    """(dK, dV); see :func:`flash_attention_bwd_dkv_plain`. A CUDA tensor
    goes to kernel K7 (arguments as K6's), or at f32 to
    :func:`flash_attention_bwd_dkv_f32`, at f16 to
    :func:`flash_attention_bwd_dkv_f16`; a CPU tensor to the plain
    version."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    dtype = _kernel_dtype(q)
    if dtype == torch.float32:
        return flash_attention_bwd_dkv_f32(q, k, v, mask, do, lse, delta)
    if dtype == torch.float16:
        return flash_attention_bwd_dkv_f16(q, k, v, mask, do, lse, delta)
    out = _launch_dkv("omni_flash_bwd_dkv", torch.bfloat16, q, k, v, mask,
                      do, lse, delta)
    flash_attention_bwd_dkv.launches += 1
    return out


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dkv_f32(q, k, v, mask, do, lse, delta):
    """K7 at f32 (``csrc/attention_f32.cu``: 3xTF32 ``mma.sync``) for a
    CUDA tensor; the plain version for a CPU tensor."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    out = _launch_dkv("omni_flash_bwd_dkv_f32", torch.float32, q, k, v,
                      mask, do, lse, delta)
    flash_attention_bwd_dkv_f32.launches += 1
    return out


flash_attention_bwd_dkv_f32.launches = 0


def flash_attention_bwd_dkv_f16(q, k, v, mask, do, lse, delta):
    """K7 at f16 (``csrc/attention_bwd.cu`` over f16 operands, its
    rounding modelled by :func:`flash_attention_bwd_f16_emulated`) for a
    CUDA tensor; the plain version for a CPU tensor."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    out = _launch_dkv("omni_flash_bwd_dkv_f16", torch.float16, q, k, v,
                      mask, do, lse, delta)
    flash_attention_bwd_dkv_f16.launches += 1
    return out


flash_attention_bwd_dkv_f16.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    mask) -> o`` [B, T, H, D] in q's dtype.

    Forward: K2 (or its plain version on the CPU), saving o and lse.
    Backward: delta in plain PyTorch, then K6 and K7 (or their plain
    versions); gradients in q's dtype from f32 sums, none for the mask.
    bf16 operands take the tensor-core kernels, f32 ones their f32
    variants, f16 ones their f16 variants.
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
