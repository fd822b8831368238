"""Periodic-boundary geometry for cubic boxes (counterpart of
metropolismontecarlo_tpu/ops/pbc.py).  `box` is a scalar or a tensor
that broadcasts against the displacement."""

import torch


def min_image(dr, box):
    """Minimum-image displacement, wrapped into (-box/2, box/2]."""
    return dr - box * torch.round(dr / box)


def min_image_dist2(ri, rj, box):
    """Squared minimum-image distance between (..., 3) position arrays."""
    dr = min_image(ri - rj, box)
    return torch.sum(dr * dr, dim=-1)


def wrap(r, box):
    """Wrap coordinates into [0, box)."""
    return r - box * torch.floor(r / box)


def pair_min_image(ra, rb, box):
    """All-pairs displacement ra - rb: (..., P, 3), (..., A, 3) ->
    (..., P, A, 3)."""
    return min_image(ra[..., :, None, :] - rb[..., None, :, :], box)


def batch_view(x, n):
    """x of a batch shape (...) viewed as (..., 1 * n), to broadcast a
    per-configuration scalar (box, kappa) over n trailing axes."""
    return x.reshape(tuple(x.shape) + (1,) * n)
