"""Wolf damped-Coulomb summation (counterpart of
metropolismontecarlo_tpu/ops/wolf.py), Wolf et al., J. Chem. Phys. 110,
8254 (1999):

  E = factor [ sum_{i<j, r<rc} q_i q_j (erfc(k r)/r - erfc(k rc)/rc)
               - (erfc(k rc)/(2 rc) + k/sqrt(pi)) sum_i q_i^2 ]

The "ref" style drops the pairwise shift and adds the global constant
-factor erfc(k rc)/rc (sum q)^2 instead.  kappa is a tensor
of the batch shape (...) of the other arguments."""

import math

import torch

from metropolismontecarlo_tpu_torch.ops.pbc import batch_view
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

_RTPI = math.sqrt(math.pi)


def wolf_pair_sum(d2, qq, mask, kappa, r_cut, factor=COULOMB_FACTOR,
                  shifted=True):
    """Masked pairwise Wolf sum over the trailing two axes, pairs with
    r < r_cut only."""
    kappa = batch_view(kappa, 2)
    d2s = torch.where(mask, d2, torch.ones_like(d2))
    r = torch.sqrt(d2s)
    shift = torch.special.erfc(kappa * r_cut) / r_cut if shifted else 0.0
    term = qq * (torch.special.erfc(kappa * r) / r - shift)
    keep = mask & (d2 < r_cut * r_cut)
    return factor * torch.sum(torch.where(keep, term, 0.0), dim=(-1, -2))


def wolf_ref_const(charges, kappa, r_cut, factor=COULOMB_FACTOR):
    q_tot = torch.sum(charges, dim=-1)
    return -factor * torch.special.erfc(kappa * r_cut) / r_cut * q_tot * q_tot


def wolf_ref_const_kappa(charges, kappa, r_cut, factor=COULOMB_FACTOR):
    """kappa dE/dkappa of wolf_ref_const."""
    q_tot = torch.sum(charges, dim=-1)
    coeff = 2.0 * kappa / _RTPI * torch.exp(-(kappa * r_cut) ** 2)
    return factor * coeff * q_tot * q_tot


def wolf_self(charges, kappa, r_cut, factor=COULOMB_FACTOR):
    coeff = torch.special.erfc(kappa * r_cut) / (2.0 * r_cut) + kappa / _RTPI
    return -factor * coeff * torch.sum(charges * charges, dim=-1)


def wolf_self_kappa(charges, kappa, r_cut, factor=COULOMB_FACTOR):
    """kappa dE_self/dkappa (kappa = kappa_L/box depends on the volume)."""
    coeff = kappa / _RTPI * (1.0 - torch.exp(-(kappa * r_cut) ** 2))
    return -factor * coeff * torch.sum(charges * charges, dim=-1)
