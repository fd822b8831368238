"""Monatomic Lennard-Jones fluid in reduced units (counterpart of
metropolismontecarlo_tpu/models/monatomic.py): the P=1 molecule with a
zero body frame and no charges."""

import functools

import numpy as np

from metropolismontecarlo_tpu_torch.models.system import System


@functools.lru_cache(maxsize=None)
def lj_system(n_atoms, eps=1.0, sigma=1.0):
    return System(
        n_mol=n_atoms,
        atoms_per_mol=1,
        body=np.zeros((n_atoms, 1, 3)),
        masses=np.ones((n_atoms, 1)),
        charges=np.zeros((n_atoms, 1)),
        type_ids=np.zeros((n_atoms, 1), np.int32),
        eps_table=np.array([[eps]]),
        sig_table=np.array([[sigma]]),
        name="lj_fluid",
    )


def lj_box_for_density(n_atoms, rho):
    return (n_atoms / rho) ** (1.0 / 3.0)
