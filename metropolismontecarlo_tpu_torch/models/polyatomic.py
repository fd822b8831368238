"""Rigid bent triatomic LJ molecules (counterpart of
metropolismontecarlo_tpu/models/polyatomic.py): unit bonds at 75 deg,
cut-and-force-shifted LJ (Mossa et al., PRE 65 041205), reduced units."""

import functools

import numpy as np

from metropolismontecarlo_tpu_torch.models.system import RunParams, System


def bent_triatomic_body(alpha_deg=75.0, bond=1.0):
    """Sites at (-s, 0, -c/3), (0, 0, 2c/3), (s, 0, -c/3) with
    s = bond sin(alpha/2), c = bond cos(alpha/2); COM at the origin."""
    a2 = np.deg2rad(alpha_deg) / 2.0
    s, c = bond * np.sin(a2), bond * np.cos(a2)
    return np.array([[-s, 0.0, -c / 3.0],
                     [0.0, 0.0, 2.0 * c / 3.0],
                     [s, 0.0, -c / 3.0]])


@functools.lru_cache(maxsize=None)
def triatomic_system(n_mol, alpha_deg=75.0, eps=1.0, sigma=1.0):
    return System(
        n_mol=n_mol,
        atoms_per_mol=3,
        body=np.broadcast_to(bent_triatomic_body(alpha_deg),
                             (n_mol, 3, 3)).copy(),
        masses=np.ones((n_mol, 3)),
        charges=np.zeros((n_mol, 3)),
        type_ids=np.zeros((n_mol, 3), np.int32),
        eps_table=np.array([[eps]]),
        sig_table=np.array([[sigma]]),
        name="triatomic",
    )


def mossa_params(temperature=0.6, **kw):
    """RunParams of the Poly state point: T*=0.6, cut-and-shifted LJ at
    r_cut = 2.612, split translate/rotate moves."""
    defaults = dict(
        temperature=temperature, r_cut=2.612, cutoff_mode="site",
        lj_shift="linear", use_lrc=False, coulomb="none",
        p_translate=0.5, dr_max=0.1, dphi_max=0.1,
    )
    defaults.update(kw)
    return RunParams(**defaults)


def lj_trimer_blocks(cap_a, cap_b, eps_a=1.0, eps_b=1.0, eps_ab=None,
                     sigma=1.0):
    """Two species blocks of unequal widths: cap_a one-site LJ molecules
    (type 0) then cap_b bent triatomics (type 1), cross eps
    sqrt(eps_a eps_b) unless given (the semigrand and binary ensembles'
    ragged system)."""
    M, P = cap_a + cap_b, 3
    body = np.zeros((M, P, 3))
    body[cap_a:] = bent_triatomic_body()
    masses = np.zeros((M, P))
    masses[:cap_a, 0] = 1.0
    masses[cap_a:] = 1.0
    type_ids = np.zeros((M, P), np.int32)
    type_ids[cap_a:] = 1
    ab = np.sqrt(eps_a * eps_b) if eps_ab is None else eps_ab
    return System(n_mol=M, atoms_per_mol=P, body=body, masses=masses,
                  charges=np.zeros((M, P)), type_ids=type_ids,
                  eps_table=np.array([[eps_a, ab], [ab, eps_b]]),
                  sig_table=np.full((2, 2), sigma), name="lj+trimer",
                  species=(("A", cap_a, 1), ("B", cap_b, 3)))
