"""Lennard-Jones pair terms (counterpart of
metropolismontecarlo_tpu/ops/lj.py).

Shift modes: "none" (plain truncated LJ, tails in ops.tail) and "linear"
(Mossa cut-and-force-shifted: u + eps*l1 + eps*l2*(r/sigma), so that u
and du/dr vanish at r_cut).  Virial convention: w = sum r_ij_com . f_ab.
"""

import torch


def _shift_coeffs(r_cut_over_sigma):
    """Mossa force-shift coefficients (sigma = eps = 1 form)."""
    sc = 1.0 / r_cut_over_sigma
    sc6 = sc**6
    sc12 = sc6 * sc6
    lam1 = 4.0 * (7.0 * sc6 - 13.0 * sc12)
    lam2 = -24.0 * (sc6 - 2.0 * sc12) * sc
    return lam1, lam2


def lj_pair_terms(d2, eps, sigma, r_cut, shift="none", site_cutoff=False):
    """Per-pair (pot, r_ab . f_ab) for squared distances d2."""
    s2 = sigma * sigma / d2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    pot = 4.0 * eps * (s12 - s6)
    wvir = 24.0 * eps * (2.0 * s12 - s6)
    if shift == "linear":
        r = torch.sqrt(d2)
        lam1, lam2 = _shift_coeffs(r_cut / sigma)
        pot = pot + eps * (lam1 + lam2 * r / sigma)
        wvir = wvir - eps * lam2 * r / sigma
    elif shift != "none":
        raise ValueError(f"unknown shift mode {shift!r}")
    if site_cutoff:
        inside = d2 < r_cut * r_cut
        pot = torch.where(inside, pot, 0.0)
        wvir = torch.where(inside, wvir, 0.0)
    return pot, wvir


def lj_masked_sum(d2, dr_ab, dr_ij, mask, eps, sigma, r_cut, shift,
                  site_cutoff):
    """Masked LJ reduction over the trailing (P, A) pair axes; dr_ab and
    dr_ij are the atom and molecular displacements (..., P, A, 3).
    Returns (pot, w)."""
    d2s = torch.where(mask, d2, torch.ones((), dtype=d2.dtype,
                                           device=d2.device))
    pot, wvir = lj_pair_terms(d2s, eps, sigma, r_cut, shift, site_cutoff)
    mf = mask.to(d2.dtype)
    proj = torch.sum(dr_ij * dr_ab, dim=-1) / d2s
    return (torch.sum(pot * mf, dim=(-1, -2)),
            torch.sum(wvir * proj * mf, dim=(-1, -2)))
