"""The whole block's share of the card's peak, %, NVT cells: the least
time of the device pass's sweeps (roofline.sweep_bound) and block-end
recomputes (roofline.recompute_bound) over the pass's wall."""

from benchmark import readers


def read(ctx):
    return readers.step_mfu(ctx, "sweep")
