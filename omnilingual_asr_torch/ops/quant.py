"""Int8 weight quantization for serving: kernels K4 and K5 and their plain
PyTorch versions.

Port of ``omnilingual_asr_tpu/ops/quant.py``. Dense weights are quantized
symmetrically per output channel (``w ~ w_q * scale[n]``, int8 in
[-127, 127]), and two matmuls take them:

- ``quantized_matmul`` (K4, W8A16): ``(bf16(x) @ bf16(w_q)) * scale[n]``,
  f32 accumulation;
- ``quantized_matmul_a8`` (K5, W8A8): each row of the f32 activations is
  quantized on the fly (``sx = max(absmax, 1e-8) * (1/127)``,
  ``xq = clip(round_half_even(x / sx), -127, 127)``), then
  ``f32(xq @ w_q) * sx[m] * scale[n]`` with exact int32 accumulation.

Both add an optional f32 bias afterwards, as ``y + b`` (the reference adds
it outside its kernel; the CUDA kernels fold it into their epilogue in the
same order). Each launches its CUDA kernel (``csrc/quant.cu``) for CUDA
tensors and runs its plain version for CPU tensors. The kernels read the
weight K-contiguous, as ``w_t = w_q.t().contiguous()`` [N, K]; callers that
call often (the engine) keep that copy from load time. The kernels serve
only: on the card an input that requires grad is refused
(:func:`refuse_grad`) rather than given an output without a graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import cuda_build

#: Output-channel tile of the reference's Pallas kernels; ``kernel_shapes_ok``
#: keeps the reference's dispatch rule so that both packages take the kernel
#: path on the same layers.
REFERENCE_BLOCK_N = 512
#: The CUDA kernels walk K in chunks of 128 and N in tiles of 128.
KERNEL_BLOCK_K = 128
KERNEL_BLOCK_N = 128


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] f32 -> (w_q [in, out] int8, scale [out] f32)."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=0)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which can land one ulp from the reference's scale.
    scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127)
    return w_q.to(torch.int8), scale


def dequantize_weight(w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return w_q.to(torch.float32) * scale[None, :]


def quantization_error(w: torch.Tensor) -> float:
    """Relative L2 error of the int8 round trip (for reporting)."""
    w = w.to(torch.float32)
    back = dequantize_weight(*quantize_weight(w))
    return float(torch.linalg.norm(back - w) / torch.linalg.norm(w))


def kernel_shapes_ok(in_dim: int, out_dim: int) -> bool:
    """The reference's rule for routing a layer to the kernels."""
    return out_dim % REFERENCE_BLOCK_N == 0 and in_dim % 128 == 0


def quantize_param_tree(params) -> Dict:
    """Every ``{"w": 2-D}`` leaf dict becomes ``{"w_q": int8, "w_scale":
    f32}`` (its other entries, such as the bias, unchanged); bare arrays
    (``spk_aam``, the depthwise ``dw``) and LayerNorms stay as they are."""
    def visit(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                w_q, scale = quantize_weight(w)
                out = {k: v for k, v in node.items() if k != "w"}
                out["w_q"] = w_q
                out["w_scale"] = scale
                return out
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    return visit(params)


def add_kernel_layouts(params) -> Dict:
    """Add ``w_t`` (the K-contiguous int8 copy the kernels read) to every
    quantized leaf whose shape the kernels take."""
    def visit(node):
        if isinstance(node, dict):
            if "w_q" in node:
                out = dict(node)
                if kernel_shapes_ok(*node["w_q"].shape):
                    out["w_t"] = node["w_q"].t().contiguous()
                return out
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    return visit(params)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(torch.float32)


def quantized_matmul_plain(x, w_q, scale, bias=None) -> torch.Tensor:
    """K4's function: x [M, K] f32/bf16, w_q [K, N] int8, scale [N] f32 ->
    [M, N] f32. Every bf16 x int8 product is exact in f32, so the f32
    matmul is what a bf16 matmul with f32 accumulation computes (TF32 must
    stay off on a card)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    y = (xb @ w_q.to(torch.float32)) * scale.to(torch.float32)
    return _add_bias(y, bias)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row activation quantization of K5: (xq [M, K] f32 holding int8
    values, sx [M] f32). Round half to even, IEEE division, as the
    reference."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=1)
    # A Python scalar multiplies as its f32 value: f32(1/127), the
    # reference's constant.
    sx = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x / sx[:, None]), -127, 127)
    return xq, sx


def quantized_matmul_a8_plain(x, w_q, scale, bias=None) -> torch.Tensor:
    """K5's function: x [M, K] f32, w_q [K, N] int8, scale [N] f32 ->
    [M, N] f32. The integer products are summed in f64, which holds every
    int32 sum of the kernel exactly, then converted to f32 as the kernel
    converts its int32 accumulator."""
    xq, sx = quantize_rows(x)
    acc = (xq.to(torch.float64) @ w_q.to(torch.float64)).to(torch.float32)
    y = acc * sx[:, None] * scale.to(torch.float32)[None, :]
    return _add_bias(y, bias)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def refuse_grad(what: str, *tensors) -> None:
    """K4 and K5 serve only: their outputs carry no autograd graph, so a
    caller that needs gradients through them gets an error, not a tensor
    whose gradients are silently zero."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} kernel has no backward: it serves only; train through "
            f"the unquantized weights")


def kernel_scratch(M: int, K: int, device, mode: str = "a8") -> torch.Tensor:
    """What K5 (``mode="a8"``) or K4 (``"w8"``) keeps between its two
    launches, as bytes: K5 each row of x quantized, xq [M, K] int8, then
    the row scales sx [M] f32; K4 bf16(x) [M, K]."""
    n = M * K + 4 * M if mode == "a8" else 2 * M * K
    return torch.empty(n, dtype=torch.uint8, device=device)


# C entry point and name of the kernel that serves each mode.
_KERNELS = {"w8": ("omni_q_matmul", "W8A16 matmul"),
            "a8": ("omni_q8a8_matmul", "W8A8 matmul")}


def _launch(mode: str, x, w_q, scale, bias, w_t) -> torch.Tensor:
    entry, what = _KERNELS[mode]
    M, K = x.shape
    K2, N = w_q.shape
    dev = x.device
    if K != K2:
        raise ValueError(f"x has K={K}, w_q has K={K2}")
    if K % KERNEL_BLOCK_K or N % KERNEL_BLOCK_N or M < 1:
        raise ValueError(f"{what} kernel takes K % {KERNEL_BLOCK_K} == 0 and "
                         f"N % {KERNEL_BLOCK_N} == 0, got M={M}, K={K}, "
                         f"N={N}")
    if w_t is None:
        w_t = w_q.t().contiguous()
    cuda_build.check_tensor(x, "x", torch.float32, (M, K), dev)
    cuda_build.check_tensor(w_t, "w_t", torch.int8, (N, K), dev)
    cuda_build.check_tensor(scale, "scale", torch.float32, (N,), dev)
    if bias is not None:
        cuda_build.check_tensor(bias, "bias", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    # Held until the launch is queued, so that the allocator hands its
    # memory out again only in stream order.
    scratch = kernel_scratch(M, K, dev, mode)
    lib = cuda_build.library()
    err = getattr(lib, entry)(
        x.data_ptr(), w_t.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), M, N, K, cuda_build.stream_ptr(dev))
    cuda_build.check(err, f"{what} kernel")
    return out


def quantized_matmul(x, w_q, scale, bias=None, w_t=None) -> torch.Tensor:
    """W8A16 matmul; see :func:`quantized_matmul_plain`.

    A CUDA tensor goes to kernel K4: x f32 [M, K], K and N multiples of
    128; ``w_t`` is the [N, K] int8 copy of ``w_q`` the kernel reads, made
    here when not given. Two launches, one count: x rounded to bf16 once,
    then the product. A CPU tensor goes to the plain version.
    """
    if not x.is_cuda:
        return quantized_matmul_plain(x, w_q, scale, bias)
    refuse_grad("W8A16 matmul", x, scale, bias)
    out = _launch("w8", x, w_q, scale, bias, w_t)
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0


def quantized_matmul_a8(x, w_q, scale, bias=None, w_t=None) -> torch.Tensor:
    """W8A8 matmul with per-row activation quantization; see
    :func:`quantized_matmul_a8_plain`.

    A CUDA tensor goes to kernel K5 (same arguments and limits as
    :func:`quantized_matmul`; two launches, one count: each row of x
    quantized once, then the int8 product); a CPU tensor to the plain
    version.
    """
    if not x.is_cuda:
        return quantized_matmul_a8_plain(x, w_q, scale, bias)
    refuse_grad("W8A8 matmul", x, scale, bias)
    out = _launch("a8", x, w_q, scale, bias, w_t)
    quantized_matmul_a8.launches += 1
    return out


quantized_matmul_a8.launches = 0


def dense_quant_matmul(x, w_q, scale, mode: str = "a8", bias=None,
                       w_t=None) -> torch.Tensor:
    """x [..., K] @ a quantized weight through K5 (``mode="a8"``) or K4
    (``mode="w8"``), plus the bias; the leading shape is restored. The
    caller checks :func:`kernel_shapes_ok` first. Rows are independent, so
    unlike the reference nothing pads M."""
    if mode not in ("a8", "w8"):
        raise ValueError(f"mode must be 'a8' or 'w8', got {mode!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    fn = quantized_matmul_a8 if mode == "a8" else quantized_matmul
    y = fn(x2, w_q, scale, bias, w_t)
    return y.reshape(*lead, w_q.shape[1])
