"""Systems from GROMACS topologies and PDB templates (counterpart of
metropolismontecarlo_tpu/models/from_topology.py; the reference's setup,
`Ewald/main.jl:158-186`: ReadTopFile -> ReadPDB -> BodyFixed ->
MakeAtomArrays -> MakeTables).

Units go from kJ/mol to K and from nm to Angstrom; the LJ tables are
Lorentz-Berthelot mixed (comb-rule 2, or geometric with comb-rule 3).
Mixed species are padded per molecule to the widest species (P_max)
with zero-mass, zero-charge slots of the `__pad__` type, which
interacts with nothing; the atom axis stays ragged (System.species:
each molecule owns only its own p atom columns).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from metropolismontecarlo_tpu_torch.io.topology import (
    FFTopology,
    lorentz_berthelot,
)
from metropolismontecarlo_tpu_torch.models.system import System
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    body_frame_from_template,
)
from metropolismontecarlo_tpu_torch.utils.constants import (
    KJ_PER_MOL_TO_K,
    NM_TO_ANGSTROM,
)

PAD_TYPE = "__pad__"

__all__ = ["PAD_TYPE", "body_frame_from_template", "system_from_topology",
           "templates_from_pdbs"]


def system_from_topology(
    top: FFTopology,
    templates: Dict[str, np.ndarray],
    molecules: Optional[List[Tuple[str, int]]] = None,
    name: str = "topology",
) -> System:
    """A System of the topology's molecules.

    templates: moltype name -> (P_i, 3) template coordinates in Angstrom
    (templates_from_pdbs).  molecules: [(moltype, count)] in place of the
    topology's [molecules] section; moltypes with count 0 are left out."""
    molecules = molecules or top.molecules
    used = [nm for nm, cnt in molecules if cnt > 0]

    # the LJ types the used moltypes name, in order of first use, and the
    # padding type last
    type_names: List[str] = []
    for nm in used:
        for t, _q, _m, _an in top.mol_types[nm].atoms:
            if t not in type_names:
                type_names.append(t)
    type_names.append(PAD_TYPE)
    t_index = {t: i for i, t in enumerate(type_names)}
    T = len(type_names)

    sig_a = np.ones(T)      # Angstrom; the pad's sigma 1 avoids 0 / 0
    eps_k = np.zeros(T)     # K
    for t, i in t_index.items():
        if t != PAD_TYPE:
            at = top.atom_types[t]
            sig_a[i] = at.sigma_nm * NM_TO_ANGSTROM
            eps_k[i] = at.epsilon_kj * KJ_PER_MOL_TO_K
    comb = int(top.defaults.get("comb_rule", 2))
    eps_table, sig_table = np.zeros((T, T)), np.ones((T, T))
    for i in range(T):
        for j in range(T):
            sig_table[i, j], eps_table[i, j] = lorentz_berthelot(
                sig_a[i], eps_k[i], sig_a[j], eps_k[j], comb)
    pad = t_index[PAD_TYPE]
    eps_table[pad, :] = 0.0
    eps_table[:, pad] = 0.0

    p_max = max(len(top.mol_types[nm].atoms) for nm in used)
    bodies, masses, charges, type_ids, species = [], [], [], [], []
    for mol_name, count in molecules:
        if count <= 0:
            continue
        mt = top.mol_types[mol_name]
        p = len(mt.atoms)
        tmpl = np.asarray(templates[mol_name], float)
        if tmpl.shape != (p, 3):
            raise ValueError(f"template for {mol_name} has shape "
                             f"{tmpl.shape}, topology expects ({p}, 3)")
        m = np.array([a[2] for a in mt.atoms])
        bp = np.zeros((p_max, 3))
        bp[:p] = body_frame_from_template(tmpl, m)
        mp = np.zeros(p_max)
        mp[:p] = m
        qp = np.zeros(p_max)
        qp[:p] = [a[1] for a in mt.atoms]
        tp = np.full(p_max, pad, np.int32)
        tp[:p] = [t_index[a[0]] for a in mt.atoms]
        bodies += [bp] * count
        masses += [mp] * count
        charges += [qp] * count
        type_ids += [tp] * count
        species.append((mol_name, count, p))

    return System(
        n_mol=len(bodies), atoms_per_mol=p_max, body=np.asarray(bodies),
        masses=np.asarray(masses), charges=np.asarray(charges),
        type_ids=np.asarray(type_ids, np.int32), eps_table=eps_table,
        sig_table=sig_table, name=name, species=tuple(species))


def templates_from_pdbs(top: FFTopology, pdb_by_mol: Dict[str, str]):
    """moltype name -> (P, 3) template: the first P atoms of each PDB
    file, P the moltype's atom count."""
    from metropolismontecarlo_tpu_torch.io.pdb import read_pdb

    return {mol: read_pdb(path)["coords"][:len(top.mol_types[mol].atoms)]
            for mol, path in pdb_by_mol.items()}
