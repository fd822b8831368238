"""The whole block's share of the card's peak, %: the least time of the
device pass's muVT cycles (roofline_muvt.muvt_bound) and block-end
recomputes of the active slots (roofline.recompute_bound) over the
pass's wall."""

from benchmark import readers


def read(ctx):
    return readers.step_mfu(ctx, "muvt_cycle")
