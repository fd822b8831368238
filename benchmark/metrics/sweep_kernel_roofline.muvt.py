"""The sweep kernel's share of its roofline in the muVT cycles, %: the
launches the port's `gcmc.cycle` spans counted in the device pass, each
one cycle of every chain (roofline_muvt.muvt_bound at the window's first
configuration), over the device time of the launches whose name matches
PATTERN.  Nothing where the port marks no cycle."""

PATTERN = r"sweep_kernel"


def read(ctx):
    if ctx.unit != "muvt_cycle" or ctx.trace is None:
        return None
    _, _, cycles = ctx.spans.total("gcmc.cycle", "count")
    device_s = ctx.trace.kernel_s(PATTERN)
    if not cycles or device_s <= 0.0:
        return None
    return 100.0 * cycles * ctx.bounds["unit"] * 1e-3 / device_s
