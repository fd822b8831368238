"""System description, run parameters and simulation state (counterpart
of metropolismontecarlo_tpu/models/system.py).

* `System`: static structure and force field as host numpy arrays, with
  the same fields and derived properties as the JAX System.
* `RunParams`: static run configuration, same fields and defaults.
* `SimState`: the per-chain dynamic state as a dataclass of tensors with
  the JAX SimState's field names and shapes (leading chains axis C;
  atoms in the transposed, padded layout coords (C, 3, A_pad) with pad
  columns at mol_id -1).  The JAX `key` field has no counterpart: random
  draws come from the torch.Generator the driver holds.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class System:
    """Static structure + force field (host numpy arrays).

    `species` lists contiguous blocks of identical molecules as
    (name, count, p) tuples; None means one uniform-width block.
    Per-molecule arrays are padded to the widest species (P_max); the
    atom axis is ragged (molecule m owns mol_p[m] columns from mol_a0[m]).
    """

    n_mol: int                 # M
    atoms_per_mol: int         # P_max
    body: np.ndarray           # (M, P, 3) body-fixed coords (COM at origin)
    masses: np.ndarray         # (M, P); 0.0 marks padding slots
    charges: np.ndarray        # (M, P)
    type_ids: np.ndarray       # (M, P) int32 LJ-type index
    eps_table: np.ndarray      # (T, T) epsilon_ij in K (pre-mixed)
    sig_table: np.ndarray      # (T, T) sigma_ij in Angstrom
    name: str = "system"
    species: Optional[tuple] = None   # ((name, count, p), ...) or None

    def __post_init__(self):
        # Systems are shared (lru_cached builders), so freeze the arrays:
        # an in-place write raises instead of leaking into other holders.
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v.setflags(write=False)

    @property
    def species_slices(self):
        """((name, m0, m1, p, a0), ...) per species block."""
        if self.species is None:
            return (("all", 0, self.n_mol, self.atoms_per_mol, 0),)
        out, m0, a0 = [], 0, 0
        for name, count, p in self.species:
            out.append((name, m0, m0 + count, p, a0))
            m0 += count
            a0 += count * p
        if m0 != self.n_mol:
            raise ValueError("species counts disagree with n_mol")
        return tuple(out)

    @property
    def mol_p(self):
        """(M,) true atoms per molecule."""
        out = np.empty(self.n_mol, np.int32)
        for _, m0, m1, p, _ in self.species_slices:
            out[m0:m1] = p
        return out

    @property
    def mol_a0(self):
        """(M,) first atom column of each molecule."""
        p = self.mol_p
        return np.concatenate([[0], np.cumsum(p)[:-1]]).astype(np.int32)

    @property
    def uniform_width(self):
        return self.species is None or all(
            p == self.atoms_per_mol for _, _, p in self.species)

    @property
    def n_atoms(self):
        if self.species is None:
            return self.n_mol * self.atoms_per_mol
        return int(sum(count * p for _, count, p in self.species))

    @property
    def n_atoms_padded(self):
        """Atom-axis storage width, as in the JAX package (n_atoms rounded
        up to 128, or 256 from 256 atoms), so that states convert between
        the two packages without reshaping."""
        gran = 256 if self.n_atoms >= 256 else 128
        return -(-self.n_atoms // gran) * gran

    @property
    def atom_mol_slot(self):
        """((A,) molecule index, (A,) slot index) per atom column."""
        mol = np.repeat(np.arange(self.n_mol, dtype=np.int32), self.mol_p)
        slot = np.arange(self.n_atoms, dtype=np.int32) \
            - np.repeat(self.mol_a0, self.mol_p)
        return mol, slot

    @property
    def mol_of_atom_padded(self):
        """(A_pad,) molecule index per atom column; -1 marks padding."""
        out = np.full(self.n_atoms_padded, -1, np.int32)
        out[: self.n_atoms] = self.atom_mol_slot[0]
        return out

    @property
    def is_uniform(self):
        if not self.uniform_width:
            return False
        t, q, b = self.type_ids, self.charges, self.body
        return bool((t == t[0]).all() and (q == q[0]).all()
                    and np.allclose(b, b[0]))

    @property
    def species_uniform(self):
        """True when every species block shares one body/charge/type
        template (the whole-sweep kernel's requirement)."""
        t, q, b = self.type_ids, self.charges, self.body
        for _, m0, m1, p, _ in self.species_slices:
            if not ((t[m0:m1, :p] == t[m0, :p]).all()
                    and (q[m0:m1, :p] == q[m0, :p]).all()
                    and np.allclose(b[m0:m1, :p], b[m0, :p])):
                return False
        return True

    @property
    def tid_row_padded(self):
        """(A_pad,) per-atom LJ type id; -1 marks lane padding."""
        out = np.full(self.n_atoms_padded, -1, np.int64)
        out[: self.n_atoms] = self.flat(self.type_ids)
        return out

    @property
    def type_counts(self):
        t = np.zeros(self.eps_table.shape[0])
        np.add.at(t, self.flat(np.asarray(self.type_ids)), 1.0)
        return t

    def flat(self, arr):
        """(M, P_max, ...) -> (A, ...): drop per-molecule padding slots."""
        if self.uniform_width:
            return arr.reshape((self.n_atoms,) + arr.shape[2:])
        mol, slot = self.atom_mol_slot
        return arr[mol, slot]


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Static run configuration; fields and defaults as in the JAX
    RunParams (see its docstrings for each field's meaning)."""

    temperature: float = 298.15
    r_cut: float = 10.0
    qq_r_cut: Optional[float] = None
    cutoff_mode: str = "site"         # "site" | "com" | "first"
    lj_shift: str = "none"            # "none" | "linear"
    use_lrc: bool = True
    coulomb: str = "none"             # "none" | "ewald" | "wolf" | "bare"
    wolf_style: str = "pairwise"      # "pairwise" | "ref"
    ewald_surface: bool = False
    kappa_L: float = 5.6
    nk: int = 5
    ksq_max: int = 27
    p_translate: float = 0.5
    dr_max: float = 0.3
    dphi_max: float = 0.05
    move_accept: float = 0.5
    d2_overlap: float = 0.5
    pressure: Optional[float] = None
    p_volume: float = 0.0
    dv_max: float = 0.05
    nlist_width: int = 0
    nlist_skin: float = 2.0
    slab_mode: str = "auto"
    slab_skin: float = 1.0
    strict_min_image: bool = True

    @property
    def qq_cut(self):
        return self.r_cut if self.qq_r_cut is None else self.qq_r_cut


@dataclasses.dataclass
class SimState:
    """Per-chain dynamic MC state; every tensor leads with the chains axis
    C except `step`.  Replace fields with dataclasses.replace."""

    com: torch.Tensor         # (C, M, 3) molecular centres of mass
    quat: torch.Tensor        # (C, M, 4) orientations (w, x, y, z)
    coords: torch.Tensor      # (C, 3, A_pad) atom positions, pads zero
    box: torch.Tensor         # (C,) box edge
    sfac: torch.Tensor        # (C, K, 2) Ewald S(k) [re, im]; else (C, 1, 2)
    energy: torch.Tensor      # (C,) running total potential energy (K)
    virial: torch.Tensor      # (C,) molecular virial from the last recompute
    temp: torch.Tensor        # (C,) per-chain temperature
    step: torch.Tensor        # () int32 global molecule-move counter
    dr_max: torch.Tensor      # (C,) adaptive max translation
    dphi_max: torch.Tensor    # (C,) adaptive max rotation
    dv_max: torch.Tensor      # (C,) adaptive max volume step
    acc: torch.Tensor         # (C, 3) int32 accepted [trans, rot, vol]
    att: torch.Tensor         # (C, 3) int32 attempted [trans, rot, vol]
    nbr: torch.Tensor         # (C, 1, 1) int32 (neighbour lists not ported)
    nbr_needed: torch.Tensor  # (C,) int32
