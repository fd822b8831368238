"""Rigid water builders: SPC/E, TIP3P and the four-site TIP4P family
(TIP4P/2005, TIP4P-Ew, TIP4P/Ice), and the NIST SPC/E sample reader
spce_from_nist (counterpart of metropolismontecarlo_tpu/models/water.py)."""

import functools

import numpy as np

from metropolismontecarlo_tpu_torch.io.configs import read_nist
from metropolismontecarlo_tpu_torch.models.system import System

# SPC/E (Berendsen et al. 1987; NIST SRSW constants)
SPCE_SIGMA_OO = 3.16555789      # Angstrom
SPCE_EPS_OO = 78.19743111       # K
SPCE_Q_O = -0.8476
SPCE_Q_H = 0.4238
SPCE_R_OH = 1.0
SPCE_THETA = 109.47
MASS_O = 15.999
MASS_H = 1.008

# TIP3P (Jorgensen 1983), GROMACS water.top values
TIP3P_SIGMA_OO = 3.15061
TIP3P_EPS_OO = 0.6364 * 120.272236695
TIP3P_Q_O = -0.834
TIP3P_Q_H = 0.417
TIP3P_R_OH = 0.9572
TIP3P_THETA = 104.52


def water_body_frame(r_oh, theta_deg):
    """(O, H, H) template with the COM at the origin; O on the -z side,
    the H's symmetric in the xz-plane."""
    th = np.deg2rad(theta_deg) / 2.0
    pts = np.stack([np.zeros(3),
                    np.array([r_oh * np.sin(th), 0.0, r_oh * np.cos(th)]),
                    np.array([-r_oh * np.sin(th), 0.0, r_oh * np.cos(th)])])
    m = np.array([MASS_O, MASS_H, MASS_H])
    return pts - (pts * m[:, None]).sum(0) / m.sum()


def _water_system(n_mol, sigma, eps, q_o, q_h, r_oh, theta, name):
    def rows(v, dtype=None):
        return np.broadcast_to(np.asarray(v, dtype), (n_mol,)
                               + np.shape(v)).copy()

    return System(
        n_mol=n_mol, atoms_per_mol=3,
        body=rows(water_body_frame(r_oh, theta)),
        masses=rows([MASS_O, MASS_H, MASS_H]),
        charges=rows([q_o, q_h, q_h]),
        type_ids=rows([0, 1, 1], np.int32),
        eps_table=np.array([[eps, 0.0], [0.0, 0.0]]),
        sig_table=np.array([[sigma, 1.0], [1.0, 1.0]]),
        name=name,
    )


@functools.lru_cache(maxsize=None)
def spce_system(n_mol):
    return _water_system(n_mol, SPCE_SIGMA_OO, SPCE_EPS_OO, SPCE_Q_O,
                         SPCE_Q_H, SPCE_R_OH, SPCE_THETA, "spce")


@functools.lru_cache(maxsize=None)
def tip3p_system(n_mol):
    return _water_system(n_mol, TIP3P_SIGMA_OO, TIP3P_EPS_OO, TIP3P_Q_O,
                         TIP3P_Q_H, TIP3P_R_OH, TIP3P_THETA, "tip3p")


# TIP4P/2005 (Abascal & Vega, J. Chem. Phys. 123, 234505 (2005)): the
# negative charge sits on a massless, LJ-free site M on the HOH bisector.
# A zero mass gives M no weight in the centre of mass or the Kabsch fit;
# its charge takes part in every Coulomb sum.
TIP4P2005_SIGMA_OO = 3.1589
TIP4P2005_EPS_OO = 93.2         # K
TIP4P2005_Q_H = 0.5564
TIP4P2005_Q_M = -2.0 * TIP4P2005_Q_H
TIP4P2005_R_OH = 0.9572
TIP4P2005_THETA = 104.52
TIP4P2005_R_OM = 0.1546

# TIP4P-Ew (Horn et al. 2004) and TIP4P/Ice (Abascal et al. 2005): the same
# four sites, refitted for Ewald liquids and for ice (eps in K = kJ/mol x
# 120.272...)
TIP4PEW_SIGMA_OO = 3.16435
TIP4PEW_EPS_OO = 0.680946 * 120.272236695
TIP4PEW_Q_H = 0.52422
TIP4PEW_R_OM = 0.125

TIP4PICE_SIGMA_OO = 3.1668
TIP4PICE_EPS_OO = 0.882169 * 120.272236695
TIP4PICE_Q_H = 0.5897
TIP4PICE_R_OM = 0.1577


def tip4p_body_frame(r_oh, theta_deg, r_om):
    """(O, H, H, M) template with the centre of mass at the origin; M on
    the HOH bisector at r_om from O, on the hydrogens' side."""
    th = np.deg2rad(theta_deg) / 2.0
    pts = np.stack([np.zeros(3),
                    np.array([r_oh * np.sin(th), 0.0, r_oh * np.cos(th)]),
                    np.array([-r_oh * np.sin(th), 0.0, r_oh * np.cos(th)]),
                    np.array([0.0, 0.0, r_om])])
    m = np.array([MASS_O, MASS_H, MASS_H, 0.0])
    return pts - (pts * m[:, None]).sum(0) / m.sum()


def _tip4p_system(n_mol, sigma, eps, q_h, r_om, name):
    def rows(v, dtype=None):
        return np.broadcast_to(np.asarray(v, dtype), (n_mol,)
                               + np.shape(v)).copy()

    return System(
        n_mol=n_mol, atoms_per_mol=4,
        body=rows(tip4p_body_frame(TIP4P2005_R_OH, TIP4P2005_THETA, r_om)),
        masses=rows([MASS_O, MASS_H, MASS_H, 0.0]),
        charges=rows([0.0, q_h, q_h, -2.0 * q_h]),
        type_ids=rows([0, 1, 1, 1], np.int32),
        eps_table=np.array([[eps, 0.0], [0.0, 0.0]]),
        sig_table=np.array([[sigma, 1.0], [1.0, 1.0]]),
        name=name,
    )


@functools.lru_cache(maxsize=None)
def tip4p2005_system(n_mol):
    return _tip4p_system(n_mol, TIP4P2005_SIGMA_OO, TIP4P2005_EPS_OO,
                         TIP4P2005_Q_H, TIP4P2005_R_OM, "tip4p2005")


@functools.lru_cache(maxsize=None)
def tip4pew_system(n_mol):
    return _tip4p_system(n_mol, TIP4PEW_SIGMA_OO, TIP4PEW_EPS_OO,
                         TIP4PEW_Q_H, TIP4PEW_R_OM, "tip4pew")


@functools.lru_cache(maxsize=None)
def tip4pice_system(n_mol):
    return _tip4p_system(n_mol, TIP4PICE_SIGMA_OO, TIP4PICE_EPS_OO,
                         TIP4PICE_Q_H, TIP4PICE_R_OM, "tip4pice")


def spce_from_nist(path):
    """A NIST SPC/E sample configuration as (system, coords, com, box):
    coords (A, 3) and com (M, 3) float64 numpy, the COMs computed after
    healing molecules split by the periodic boundary (minimum image
    relative to each O)."""
    coords, species, box = read_nist(path)
    if species[:2] != ["O", "H"]:
        raise ValueError(f"{path}: expected O, H, H molecules, got "
                         f"{species[:3]}")
    n_mol = len(species) // 3
    mp = coords.reshape(n_mol, 3, 3)
    rel = mp - mp[:, :1, :]
    rel = rel - box * np.round(rel / box)
    m = np.array([MASS_O, MASS_H, MASS_H])
    com = mp[:, 0, :] + (rel * m[None, :, None]).sum(1) / m.sum()
    return spce_system(n_mol), coords, com, box


# TraPPE united-atom methane (Martin & Siepmann 1998)
CH4_EPS = 148.0                 # K
CH4_SIGMA = 3.73                # Angstrom
MASS_CH4 = 16.043


def spce_methane_system(n_w, n_ch4):
    """A ragged mixture: n_w SPC/E waters (P = 3) followed by n_ch4
    one-site TraPPE methanes (P = 1), so the methane block's first atom
    column differs from m_start * P.  Types [O, H, CH4] with
    Lorentz-Berthelot cross terms."""
    w = spce_system(n_w)
    M = n_w + n_ch4
    body, masses, charges = (np.zeros((M, 3, 3)), np.zeros((M, 3)),
                             np.zeros((M, 3)))
    type_ids = np.zeros((M, 3), np.int32)
    body[:n_w], masses[:n_w], charges[:n_w] = w.body, w.masses, w.charges
    type_ids[:n_w] = w.type_ids
    masses[n_w:, 0], type_ids[n_w:, 0] = MASS_CH4, 2
    eps = np.array([SPCE_EPS_OO, 0.0, CH4_EPS])
    sig = np.array([SPCE_SIGMA_OO, 1.0, CH4_SIGMA])
    eps_t = np.sqrt(eps[:, None] * eps[None, :])
    sig_t = np.where(eps_t > 0.0, 0.5 * (sig[:, None] + sig[None, :]), 1.0)
    return System(n_mol=M, atoms_per_mol=3, body=body, masses=masses,
                  charges=charges, type_ids=type_ids, eps_table=eps_t,
                  sig_table=sig_t, name="spce+ch4",
                  species=(("spce", n_w, 3), ("ch4", n_ch4, 1)))


def spce_two_blocks(cap_a, cap_b):
    """SPC/E split into two species blocks of identical molecules, cap_a
    then cap_b slots (the semigrand and binary ensembles' identical-species
    system; bench.py's "semigrand" uses 64 + 64)."""
    w = spce_system(cap_a + cap_b)
    return System(n_mol=cap_a + cap_b, atoms_per_mol=3, body=w.body,
                  masses=w.masses, charges=w.charges, type_ids=w.type_ids,
                  eps_table=w.eps_table, sig_table=w.sig_table,
                  name="spce2x", species=(("wA", cap_a, 3), ("wB", cap_b, 3)))
