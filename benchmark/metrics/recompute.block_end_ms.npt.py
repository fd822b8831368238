"""Mean milliseconds of the block-end full_energy of MonteCarlo, NPT
cells (a span around the call run_block makes, the card synchronised at
its ends, no profiler on)."""

from benchmark import readers


def read(ctx):
    return readers.block_end_ms(ctx, "sweep")
