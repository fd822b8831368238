"""The whole block's share of the card's peak, %: the least time of
the device pass's Gibbs cycles (roofline.gibbs_bound), block-end and
volume-exchange recomputes of both boxes (roofline.recompute_bound) over
the pass's wall."""

from benchmark import readers


def read(ctx):
    return readers.step_mfu(ctx, "cycle")
