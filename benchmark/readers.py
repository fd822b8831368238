"""What the per-layer readers in metrics/ share: each metric file names
its quantity and the work unit of the cells it reads ("sweep" in the
fixed-N cells, "cycle" in the Gibbs cells) and returns None where its
run has nothing to read.

ctx: unit, spans (tracing.Spans: the timing pass's synchronised spans,
mode "time"; the device pass's counted units, mode "count"), trace (the
device pass's tracing.Trace, CUDA activity alone), bounds (the cell's
least times in ms, roofline.py: "unit" one sweep or Gibbs launch of every
chain, "recompute" one recompute of every chain), volume_events (volume
moves in the device pass, each of every chain)."""


def ms_per_unit(ctx, unit):
    """Milliseconds inside run_steps per sweep or cycle it ran."""
    if ctx.unit != unit:
        return None
    s, units, _ = ctx.spans.total("run_steps")
    return 1e3 * s / units if units else None


def block_end_ms(ctx, unit):
    """Mean milliseconds of the block-end full_energy call."""
    if ctx.unit != unit:
        return None
    s, _, n = ctx.spans.total("full_energy")
    return 1e3 * s / n if n else None


def kernel_roofline(ctx, unit, pattern):
    """%: the least time of the device pass's sweeps or cycles over the
    device time of the launches whose name matches pattern."""
    if ctx.unit != unit or ctx.trace is None:
        return None
    _, units, _ = ctx.spans.total("run_steps", "count")
    device_s = ctx.trace.kernel_s(pattern)
    if not units or device_s <= 0.0:
        return None
    return 100.0 * units * ctx.bounds["unit"] * 1e-3 / device_s


def step_mfu(ctx, unit):
    """%: the least time of all the device pass's blocks did (their sweeps
    or cycles, block-end recomputes and volume moves' recomputes) over the
    pass's wall (nothing where the pass saw no device activity)."""
    if ctx.unit != unit or ctx.trace is None or ctx.trace.busy_s <= 0.0:
        return None
    _, units, _ = ctx.spans.total("run_steps", "count")
    _, _, ends = ctx.spans.total("full_energy", "count")
    if not units:
        return None
    least_ms = units * ctx.bounds["unit"] \
        + (ends + ctx.volume_events) * ctx.bounds["recompute"]
    return 100.0 * least_ms * 1e-3 / ctx.trace.window_s


def idle_share(ctx, unit):
    """%: the share of the device pass's wall in which no kernel, copy or
    set ran on the card."""
    if ctx.unit != unit or ctx.trace is None or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
