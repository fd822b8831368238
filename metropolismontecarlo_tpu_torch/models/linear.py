"""Rigid linear molecules: TraPPE CO2 and N2 system builders (counterpart
of metropolismontecarlo_tpu/models/linear.py).

Published TraPPE values (Potoff & Siepmann, AIChE J. 47, 1676 (2001)):

* CO2 -- 3 LJ sites, C-O bond 1.16 A, linear; eps_C/k 27.0 K sig_C
  2.80 A, eps_O/k 79.0 K sig_O 3.05 A, q_C +0.70 e, q_O -0.35 e,
  Lorentz-Berthelot cross terms.
* N2 -- 2 LJ sites at +-0.55 A, eps_N/k 36.0 K sig_N 3.31 A,
  q_N -0.482 e, plus a massless charge site at the COM with q_M +0.964 e.
"""

import functools

import numpy as np

from metropolismontecarlo_tpu_torch.models.system import System

MASS_C = 12.011
MASS_O = 15.999
MASS_N = 14.007

# TraPPE CO2
CO2_R_CO = 1.16          # Angstrom
CO2_EPS_C = 27.0         # K
CO2_SIG_C = 2.80         # Angstrom
CO2_EPS_O = 79.0
CO2_SIG_O = 3.05
CO2_Q_C = 0.70           # e
CO2_Q_O = -0.35

# TraPPE N2
N2_R_NN = 1.10
N2_EPS_N = 36.0
N2_SIG_N = 3.31
N2_Q_N = -0.482
N2_Q_M = 0.964


def _lb_tables(eps, sig):
    """Lorentz-Berthelot (T, T) pair tables from per-type (eps_i, sig_i).
    Zero-eps entries get sigma 1, so that a distance-floored r^-12 of a
    coincident pad pair stays finite instead of 0 * inf."""
    eps = np.asarray(eps, np.float64)
    sig = np.asarray(sig, np.float64)
    eps_t = np.sqrt(eps[:, None] * eps[None, :])
    sig_t = 0.5 * (sig[:, None] + sig[None, :])
    sig_t = np.where(eps_t > 0.0, sig_t, 1.0)
    return eps_t, sig_t


def co2_body_frame():
    """(3, 3) body template (C, O, O) along z, COM at the origin (the
    carbon, by symmetry)."""
    pts = np.array([[0.0, 0.0, 0.0],
                    [0.0, 0.0, +CO2_R_CO],
                    [0.0, 0.0, -CO2_R_CO]])
    m = np.array([MASS_C, MASS_O, MASS_O])
    com = (pts * m[:, None]).sum(0) / m.sum()
    return pts - com


def n2_body_frame():
    """(3, 3) body template (N, N, M) along z; the massless M charge site
    sits at the COM (the bond midpoint)."""
    return np.array([[0.0, 0.0, +0.5 * N2_R_NN],
                     [0.0, 0.0, -0.5 * N2_R_NN],
                     [0.0, 0.0, 0.0]])


def _rows(v, n, dtype=None):
    return np.broadcast_to(np.asarray(v, dtype), (n,) + np.shape(v))


@functools.lru_cache(maxsize=None)
def co2_system(n_mol):
    """TraPPE CO2: uniform 3-site linear species, two LJ types."""
    eps_t, sig_t = _lb_tables([CO2_EPS_C, CO2_EPS_O, 0.0],
                              [CO2_SIG_C, CO2_SIG_O, 1.0])
    return System(n_mol=n_mol, atoms_per_mol=3,
                  body=_rows(co2_body_frame(), n_mol).copy(),
                  masses=_rows([MASS_C, MASS_O, MASS_O], n_mol).copy(),
                  charges=_rows([CO2_Q_C, CO2_Q_O, CO2_Q_O], n_mol).copy(),
                  type_ids=_rows([0, 1, 1], n_mol, np.int32).copy(),
                  eps_table=eps_t, sig_table=sig_t, name="co2")


@functools.lru_cache(maxsize=None)
def n2_system(n_mol):
    """TraPPE N2: 2 LJ sites + a massless COM charge site (type 1 is the
    zero-eps charge-only type, doubling as the pad type)."""
    eps_t, sig_t = _lb_tables([N2_EPS_N, 0.0], [N2_SIG_N, 1.0])
    return System(n_mol=n_mol, atoms_per_mol=3,
                  body=_rows(n2_body_frame(), n_mol).copy(),
                  masses=_rows([MASS_N, MASS_N, 0.0], n_mol).copy(),
                  charges=_rows([N2_Q_N, N2_Q_N, N2_Q_M], n_mol).copy(),
                  type_ids=_rows([0, 0, 1], n_mol, np.int32).copy(),
                  eps_table=eps_t, sig_table=sig_t, name="n2")


def co2_n2_system(n_co2, n_n2):
    """TraPPE CO2 + N2 mixture in two species blocks (both P = 3), with
    Lorentz-Berthelot cross terms over the type set [C, O(CO2), N,
    charge-site/pad]."""
    body = np.concatenate([_rows(co2_body_frame(), n_co2),
                           _rows(n2_body_frame(), n_n2)])
    masses = np.concatenate([_rows([MASS_C, MASS_O, MASS_O], n_co2),
                             _rows([MASS_N, MASS_N, 0.0], n_n2)])
    charges = np.concatenate([_rows([CO2_Q_C, CO2_Q_O, CO2_Q_O], n_co2),
                              _rows([N2_Q_N, N2_Q_N, N2_Q_M], n_n2)])
    type_ids = np.concatenate([_rows([0, 1, 1], n_co2, np.int32),
                               _rows([2, 2, 3], n_n2, np.int32)])
    eps_t, sig_t = _lb_tables([CO2_EPS_C, CO2_EPS_O, N2_EPS_N, 0.0],
                              [CO2_SIG_C, CO2_SIG_O, N2_SIG_N, 1.0])
    return System(n_mol=n_co2 + n_n2, atoms_per_mol=3, body=body,
                  masses=masses, charges=charges, type_ids=type_ids,
                  eps_table=eps_t, sig_table=sig_t, name="co2+n2",
                  species=(("co2", n_co2, 3), ("n2", n_n2, 3)))
