"""The yardstick: peaks of one H100 SXM, the roofline bound of a kernel
call, each kernel operation's operations and bytes, and the model FLOPs of
the whole forward, the decoders' steps and the training step, all computed
from shapes.

The peaks and ``bound`` are a frozen copy of the arithmetic that the port's
card smoke test uses; the operations and bytes of K1, K2, K3, K6 and K7
count what that test counts for each case (valid keys only, each input
byte read once and each output byte written once).
"""

from __future__ import annotations

import math

#: NVIDIA's data sheet, H100 SXM, dense rates, at the 700 W power limit.
H100_SXM_PEAKS = {"f32": 67e12, "bf16": 989e12, "f16": 989e12,
                  "int8": 1979e12, "tf32": 495e12, "bytes": 3.35e12}

#: The peak a model's FLOPs are held against (the configurations' dtype is
#: bf16).
MFU_PEAK = H100_SXM_PEAKS["bf16"]

BF16, F32, I32, BOOL = 2, 4, 4, 1


def bound(flops_by_type: dict, n_bytes: int, peaks=H100_SXM_PEAKS):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = n_bytes / peaks["bytes"]
    t_ops = sum(f / peaks[kind] for kind, f in flops_by_type.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Kernel operations (one call each)
# ---------------------------------------------------------------------------

def k1_mel(n_frames: int, n_fft: int, n_mels: int, n_weights: int):
    """K1 over ``n_frames`` frames: a real FFT of each frame and the
    filterbank's ``n_weights`` nonzero weights; frames, fb and the output in
    f32. -> (flops_by_type, bytes)."""
    flops = n_frames * (2.5 * n_fft * math.log2(n_fft) + 2 * n_weights)
    n_bins = n_fft // 2 + 1
    n_bytes = F32 * (n_frames * n_fft + n_bins * n_mels + n_frames * n_mels)
    return {"f32": flops}, n_bytes


def k2_attn_fwd(B: int, T: int, H: int, D: int, valid_keys: int):
    """K2 (bf16 operands): every query row against the valid keys;
    ``valid_keys`` is the sum of valid keys over the batch rows. Reads q, k,
    v and the int32 mask, writes o (bf16) and the f32 log-sum-exp."""
    flops = 4 * H * D * T * valid_keys
    qkvo = B * T * H * D * BF16
    n_bytes = 4 * qkvo + B * T * I32 + B * H * T * F32
    return {"bf16": flops}, n_bytes


def k6_attn_bwd_dq(B: int, T: int, H: int, D: int, valid_keys: int):
    """K6: dQ. Reads q, k, v, dO, the mask, lse and delta; writes dQ."""
    work = H * T * D * valid_keys
    io = 4 * B * T * H * D * BF16 + B * T * I32 + 2 * B * H * T * F32
    return {"bf16": 6 * work}, io + B * T * H * D * BF16


def k7_attn_bwd_dkv(B: int, T: int, H: int, D: int, valid_keys: int):
    """K7: dK and dV from the same reads as K6."""
    work = H * T * D * valid_keys
    io = 4 * B * T * H * D * BF16 + B * T * I32 + 2 * B * H * T * F32
    return {"bf16": 8 * work}, io + 2 * B * T * H * D * BF16


def k3_conv_module(B: int, T: int, D: int, K: int):
    """K3 forward: both pointwise products in bf16 over every frame, the
    depthwise taps in f32. Reads x (f32), the mask, pw1 and pw2 (bf16), the
    taps and both LayerNorms; writes the f32 output."""
    pw = 2 * B * T * D * (2 * D + D)
    dw = 2 * B * T * D * K
    n_bytes = (2 * B * T * D * F32 + B * T * BOOL + 3 * D * D * BF16
               + K * D * F32 + 4 * 4 * D)
    return {"bf16": pw, "f32": dw}, n_bytes


def call_bound_ms(op) -> float:
    return bound(*op)[0]


# ---------------------------------------------------------------------------
# Model FLOPs (multiply-adds count 2)
# ---------------------------------------------------------------------------

def encoder_flops_per_frame(d: int, n_layers: int, ffn_mult: int,
                            conv_kernel: int, n_mels: int, sub: int,
                            keys: int, vocab: int, n_langs: int = 2048,
                            n_emotions: int = 4, spk_dim: int = 256) -> float:
    """Forward FLOPs of one subsampled frame of the conformer with its
    heads, attending over ``keys`` valid keys: the subsampler, each block's
    two FFNs, attention projections and products, the conv module's
    pointwise and depthwise products, and the CTC, LID, emotion and speaker
    heads."""
    f = d * ffn_mult
    block = (2 * (2 * 2 * d * f)          # two FFNs
             + 4 * 2 * d * d              # q, k, v, o
             + 4 * keys * d               # QK^T and PV
             + 2 * d * 2 * d + 2 * d * d  # pw1, pw2
             + 2 * d * conv_kernel)       # depthwise
    heads = 2 * d * (vocab + n_langs + n_emotions + spk_dim) \
        + 2 * spk_dim * spk_dim
    return 2 * sub * n_mels * d + n_layers * block + heads


#: The x-vector embedder's (kernel, stride, out channels) a layer.
XVECTOR_LAYERS = ((5, 2, 128), (5, 2, 256), (3, 1, 256), (3, 1, 256),
                  (3, 1, 256))


def xvector_flops_per_frame(n_mels: int, spk_dim: int = 256) -> float:
    """Forward FLOPs of the x-vector embedder per output frame (1/4 of the
    mel rate): each conv's output positions per output frame times its
    products, then the projection."""
    total, c_in = 0.0, n_mels
    rate = 4.0                       # mel frames per output frame
    for k, stride, c_out in XVECTOR_LAYERS:
        rate /= stride
        total += rate * 2 * k * c_in * c_out
        c_in = c_out
    return total + 2 * c_in * spk_dim


def decoder_step_flops(d: int, n_layers: int, vocab: int, position: int,
                       memory: int) -> float:
    """One greedy decode step at ``position`` (0-based) over ``memory``
    valid memory slots: each block's self-attention (fused q, k, v and o,
    the products over the ``position + 1`` cached keys), cross-attention
    (q, o and the products; the memory's k and v are
    :func:`decoder_memory_flops`) and FFN (x4), then the output head."""
    block = (2 * d * 3 * d + 2 * d * d + 4 * (position + 1) * d
             + 2 * d * d + 2 * d * d + 4 * memory * d
             + 2 * 2 * d * 4 * d)
    return n_layers * block + 2 * d * vocab


def decoder_memory_flops(d: int, n_layers: int, memory: int) -> float:
    """The cross-attention keys and values of ``memory`` slots, once a
    decode."""
    return n_layers * memory * 2 * d * 2 * d


def source_encoder_flops(d: int, n_layers: int, tokens: int) -> float:
    """The text translator's byte encoder over ``tokens`` valid source
    bytes (fused q, k, v, o, the products over the valid bytes, FFN x4)."""
    per_token = 2 * d * 3 * d + 2 * d * d + 4 * tokens * d + 2 * 2 * d * 4 * d
    return n_layers * tokens * per_token


def train_step_flops(frames: int, per_frame: float) -> float:
    """Forward and backward of a training step: three times the forward
    FLOPs of its valid frames."""
    return 3.0 * frames * per_frame
