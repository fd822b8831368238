"""The Gibbs kernel's share of its roofline, %: the least time of the
device pass's cycles (roofline.gibbs_bound at the window's first
configuration) over the device time of the launches whose name matches
PATTERN."""

from benchmark import readers

PATTERN = r"gibbs_kernel"


def read(ctx):
    return readers.kernel_roofline(ctx, "cycle", PATTERN)
