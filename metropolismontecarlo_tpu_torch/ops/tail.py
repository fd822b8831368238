"""LJ long-range tail corrections (counterpart of
metropolismontecarlo_tpu/ops/tail.py, fixed-N part):

  U_lrc = (8 pi / 3V) sum_ab N_a N_b eps sig^3 [(sig/rc)^9/3 - (sig/rc)^3]
  P_lrc = (16 pi / 3V^2) sum_ab N_a N_b eps sig^3 [2(sig/rc)^9/3 - (sig/rc)^3]
"""

import math


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
