"""Milliseconds inside MolGCMC.run_steps per muVT cycle (one sweep-kernel
launch of the slot moves and exchange attempts; a span around the call
run_block makes, the card synchronised at its ends, no profiler on)."""

from benchmark import readers


def read(ctx):
    return readers.ms_per_unit(ctx, "muvt_cycle")
