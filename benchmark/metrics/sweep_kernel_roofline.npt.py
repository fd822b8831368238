"""The sweep kernel's share of its roofline, %, NPT cells: the least
time of the device pass's sweeps (roofline.sweep_bound at the window's
first configuration, real atoms) over the device time of the launches
whose name matches PATTERN."""

from benchmark import readers

PATTERN = r"sweep_kernel"


def read(ctx):
    return readers.kernel_roofline(ctx, "sweep", PATTERN)
