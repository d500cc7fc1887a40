"""Attention forward (K2) against its roofline, in %: the bound of one
call at the cell's shapes (valid keys only) times the calls in the traced
slice, over the device time of the kernels that implement it. Each call is
one ``flash_fwd_kernel``; calls and time come from the same events."""

from benchmark.harness import roofline_share

#: (kernel that marks one call, the fact with one call's shape).
PARTS = [(r"\bflash_fwd_kernel\b", "attn_fwd")]
#: Kernel names (regular expressions) that compute the operation.
KERNELS = [r"\bflash_fwd_kernel\b"]


def read(rec):
    return roofline_share(rec, PARTS, KERNELS)
