"""LJ long-range tail corrections (counterpart of
metropolismontecarlo_tpu/ops/tail.py, energy and pressure terms, the
species-level coefficient of the fluctuating-N ensembles and the
impulsive pressure of cut-unshifted LJ):

  U_lrc = (8 pi / 3V) sum_ab N_a N_b eps sig^3 [(sig/rc)^9/3 - (sig/rc)^3]
  P_lrc = (16 pi / 3V^2) sum_ab N_a N_b eps sig^3 [2(sig/rc)^9/3 - (sig/rc)^3]
"""

import math

import numpy as np
import torch

LRC_PREFACTOR = 8.0 * math.pi / 3.0


def mol_tail_coeff(tvec_a, tvec_b, eps_table, sig_table, r_cut):
    """Species-level tail coefficient c_ab = t_a^T C t_b (numpy, static),
    C_ij = eps_ij sig_ij^3 [(sig_ij/rc)^9 / 3 - (sig_ij/rc)^3], for
    per-molecule atom-type counts t_a, t_b (T,).  With N_s molecules of
    species s, U_lrc = (8 pi / 3V) sum_ss' N_s N_s' c_ss': quadratic in
    the molecule counts, so every exchange delta is affine in N and rides
    the exchange constants (si, wc) of the sweep kernel."""
    eps = np.asarray(eps_table, np.float64)
    sig = np.asarray(sig_table, np.float64)
    sc3 = (sig / float(r_cut)) ** 3
    c = eps * sig**3 * (sc3**3 / 3.0 - sc3)
    return float(np.asarray(tvec_a, np.float64) @ c
                 @ np.asarray(tvec_b, np.float64))


def _species_sum(counts, eps_table, sig_table, r_cut):
    counts = counts.to(eps_table.dtype)
    sc3 = (sig_table / r_cut) ** 3
    sc9 = sc3**3
    nn = counts[:, None] * counts[None, :]
    base = nn * eps_table * sig_table**3
    return (base * (sc9 / 3.0 - sc3)).sum(), \
        (base * (2.0 * sc9 / 3.0 - sc3)).sum()


def lrc_energy(counts, eps_table, sig_table, r_cut, volume):
    """Tail energy; counts (T,) atoms of each LJ type (tensors)."""
    e_term, _ = _species_sum(counts, eps_table, sig_table, r_cut)
    return (8.0 * math.pi / (3.0 * volume)) * e_term


def lrc_pressure(counts, eps_table, sig_table, r_cut, volume):
    """Tail pressure (energy/volume units)."""
    _, p_term = _species_sum(counts, eps_table, sig_table, r_cut)
    return (16.0 * math.pi / (3.0 * volume**2)) * p_term


def impulsive_pressure(counts, eps_table, sig_table, r_cut, volume):
    """Impulsive (truncation) pressure of cut-unshifted LJ in the
    g(r_cut) ~ 1 approximation,

      P_imp = (2 pi / 3 V^2) r_cut^3 sum_ab N_a N_b u_ab(r_cut):

    a pair crossing the cutoff jumps the energy by -u(r_cut), so the
    mechanical pressure differs from the virial pressure between crossings
    (energy_breakdown's "w") by this term; zero for the linear shift.
    counts (T,) atoms of each type; eps_table, sig_table (T, T) tensors,
    whose dtype the sum takes."""
    sc6 = (sig_table / r_cut) ** 6
    u_rc = 4.0 * eps_table * (sc6 * sc6 - sc6)
    counts = torch.as_tensor(np.asarray(counts), dtype=eps_table.dtype,
                             device=eps_table.device)
    nn = counts[:, None] * counts[None, :]
    return (2.0 * math.pi / (3.0 * volume**2)) * r_cut**3 \
        * torch.sum(nn * u_rc)
