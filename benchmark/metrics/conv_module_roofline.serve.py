"""The conv module (K3: two kernels a call) against its roofline, in %:
the bound of one call at the cell's shapes times the calls in the traced
slice (one ``conv_stage1_kernel`` each), over the device time of the
kernels that implement it; calls and time come from the same events."""

from benchmark.harness import roofline_share

#: (kernel that marks one call, the fact with one call's shape).
PARTS = [(r"\bconv_stage1_kernel\b", "conv_module")]
#: Kernel names (regular expressions) that compute the operation.
KERNELS = [r"\bconv_stage1_kernel\b", r"\bconv_stage2_kernel\b"]


def read(rec):
    return roofline_share(rec, PARTS, KERNELS)
