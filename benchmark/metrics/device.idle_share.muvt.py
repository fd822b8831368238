"""The share of the device pass's wall in which no kernel, copy or set
ran on the card, %, in the muVT cells."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "muvt_cycle")
