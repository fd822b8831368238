"""Milliseconds inside MonteCarlo.run_steps per sweep, NPT cells: the
volume moves run inside it (a span around the call run_block makes, the
card synchronised at its ends, no profiler on)."""

from benchmark import readers


def read(ctx):
    return readers.ms_per_unit(ctx, "sweep")
