"""Share of the device pass's wall in which no kernel, copy or set ran
on the card, %, Gibbs cells."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx, "cycle")
