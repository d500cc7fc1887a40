"""Attention backward (K6 for dQ, K7 for dK and dV) against its roofline,
in %: each call's bound at the cell's shapes (valid keys only) times the
calls in the traced slice, over the device time of the kernels that
implement them; calls and time come from the same events."""

from benchmark.harness import roofline_share

#: (kernel that marks one call, the fact with one call's shape).
PARTS = [(r"\bflash_bwd_dq_kernel\b", "attn_bwd_dq"),
         (r"\bflash_bwd_dkv_kernel\b", "attn_bwd_dkv")]
#: Kernel names (regular expressions) that compute the operation.
KERNELS = [r"\bflash_bwd_dq_kernel\b", r"\bflash_bwd_dkv_kernel\b"]


def read(rec):
    return roofline_share(rec, PARTS, KERNELS)
