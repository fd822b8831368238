"""Milliseconds inside MolGibbsEnsemble.run_steps per Gibbs cycle, volume
moves included (a span around the call run_block makes, the card
synchronised at its ends, no profiler on)."""

from benchmark import readers


def read(ctx):
    return readers.ms_per_unit(ctx, "cycle")
