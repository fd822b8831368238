"""Bare truncated Coulomb, factor * sum qq / r (counterpart of
metropolismontecarlo_tpu/ops/coulomb.py)."""

import torch

from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR


def bare_pair_sum(d2, qq, mask, factor=COULOMB_FACTOR):
    """Masked pairwise 1/r sum over the trailing two axes."""
    d2s = torch.where(mask, d2, torch.ones_like(d2))
    term = qq / torch.sqrt(d2s)
    return factor * torch.sum(torch.where(mask, term, 0.0), dim=(-1, -2))
