"""Mean milliseconds of MolGCMC's block-end full_energy (the chunked
slot recompute; a span around the call run_block makes, the card
synchronised at its ends, no profiler on)."""

from benchmark import readers


def read(ctx):
    return readers.block_end_ms(ctx, "muvt_cycle")
