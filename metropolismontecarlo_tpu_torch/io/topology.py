"""GROMACS .top/.itp topology and force-field reader, host-side Python
(counterpart of metropolismontecarlo_tpu/io/topology.py; the reference's
ReadTopFile, `Ewald/setup.jl:89-390`).

Reads the sections [defaults] [atomtypes] [moleculetype] [atoms] [bonds]
[pairs] [angles] [dihedrals] [settles] [exclusions] [system] [molecules],
`;` comments, `#include` files (relative to the including file) and
`#ifdef/#ifndef/#else/#endif` blocks against a set of defined symbols
(none by default, as GROMACS without -D flags: that is what selects the
rigid [settles] branch of a water .itp).  The result is a plain
FFTopology of Python data; models/from_topology.py builds a System from
it.
"""

import dataclasses
import math
import os
from typing import Dict, List, Tuple


@dataclasses.dataclass
class AtomType:
    name: str
    mass: float
    charge: float
    sigma_nm: float
    epsilon_kj: float


@dataclasses.dataclass
class MolType:
    name: str
    nrexcl: int
    # per atom: (type_name, charge, mass, atom_name)
    atoms: List[Tuple[str, float, float, str]] = dataclasses.field(
        default_factory=list)
    bonds: List[Tuple[int, int, int, List[float]]] = dataclasses.field(
        default_factory=list)
    pairs: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    angles: List[Tuple[int, int, int, int, List[float]]] = \
        dataclasses.field(default_factory=list)
    dihedrals: List[Tuple[int, int, int, int, int, List[float]]] = \
        dataclasses.field(default_factory=list)
    settles: List[Tuple[int, int, float, float]] = dataclasses.field(
        default_factory=list)
    exclusions: List[List[int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FFTopology:
    defaults: Dict[str, float]
    atom_types: Dict[str, AtomType]
    mol_types: Dict[str, MolType]
    system_name: str
    molecules: List[Tuple[str, int]]  # (moltype name, count), in order


def _preprocess(path, defines):
    """The logical lines of `path`: comments stripped, #include expanded
    and #ifdef/#ifndef/#else/#endif resolved against `defines` (a set,
    which #define adds to)."""
    out, stack = [], []       # stack: is each open block's branch taken

    with open(path) as f:
        for raw in f:
            line = raw.split(";")[0].strip()
            if not line:
                continue
            live = all(stack)
            if line.startswith("#"):
                parts = line.split()
                tag = parts[0]
                if tag == "#include" and live:
                    inc = parts[1].strip('"<>')
                    out.extend(_preprocess(
                        os.path.join(os.path.dirname(path), inc), defines))
                elif tag == "#ifdef":
                    stack.append(parts[1] in defines)
                elif tag == "#ifndef":
                    stack.append(parts[1] not in defines)
                elif tag == "#else":
                    stack[-1] = not stack[-1]
                elif tag == "#endif":
                    stack.pop()
                elif tag == "#define" and live:
                    defines.add(parts[1])
                continue
            if live:
                out.append(line)
    return out


def read_top(path, defines=()):
    """FFTopology of a GROMACS topology file."""
    lines = _preprocess(path, set(defines))
    defaults = {"nbfunc": 1, "comb_rule": 2, "gen_pairs": True,
                "fudge_lj": 1.0, "fudge_qq": 1.0}
    atom_types: Dict[str, AtomType] = {}
    mol_types: Dict[str, MolType] = {}
    system_name = ""
    molecules: List[Tuple[str, int]] = []
    section, cur = None, None

    for line in lines:
        if line.startswith("["):
            section = line.strip("[] \t").lower()
            continue
        parts = line.split()
        if section == "defaults":
            defaults["nbfunc"] = int(parts[0])
            defaults["comb_rule"] = int(parts[1])
            if len(parts) > 2:
                defaults["gen_pairs"] = parts[2].lower() in ("yes", "true",
                                                             "1")
            if len(parts) > 3:
                defaults["fudge_lj"] = float(parts[3])
            if len(parts) > 4:
                defaults["fudge_qq"] = float(parts[4])
        elif section == "atomtypes":
            # name [btype] [at.num] mass charge ptype sigma epsilon: find
            # the ptype column, so both layouts read
            pidx = next(i for i, p in enumerate(parts)
                        if p in ("A", "D", "S", "V") and i >= 2)
            atom_types[parts[0]] = AtomType(
                name=parts[0], mass=float(parts[pidx - 2]),
                charge=float(parts[pidx - 1]),
                sigma_nm=float(parts[pidx + 1]),
                epsilon_kj=float(parts[pidx + 2]))
        elif section == "moleculetype":
            cur = MolType(name=parts[0], nrexcl=int(parts[1]))
            mol_types[parts[0]] = cur
        elif section == "atoms":
            # nr type resnr residue atom cgnr [charge [mass]]
            t = parts[1]
            charge = float(parts[6]) if len(parts) > 6 \
                else atom_types[t].charge
            mass = float(parts[7]) if len(parts) > 7 else atom_types[t].mass
            cur.atoms.append((t, charge, mass, parts[4]))
        elif section == "bonds":
            cur.bonds.append((int(parts[0]), int(parts[1]), int(parts[2]),
                              [float(x) for x in parts[3:]]))
        elif section == "pairs":
            cur.pairs.append((int(parts[0]), int(parts[1])))
        elif section == "angles":
            cur.angles.append((int(parts[0]), int(parts[1]), int(parts[2]),
                               int(parts[3]), [float(x) for x in parts[4:]]))
        elif section == "dihedrals":
            cur.dihedrals.append((int(parts[0]), int(parts[1]),
                                  int(parts[2]), int(parts[3]),
                                  int(parts[4]),
                                  [float(x) for x in parts[5:]]))
        elif section == "settles":
            cur.settles.append((int(parts[0]), int(parts[1]),
                                float(parts[2]), float(parts[3])))
        elif section == "exclusions":
            cur.exclusions.append([int(x) for x in parts])
        elif section == "system":
            system_name = line
        elif section == "molecules":
            molecules.append((parts[0], int(parts[1])))

    return FFTopology(defaults=defaults, atom_types=atom_types,
                      mol_types=mol_types, system_name=system_name,
                      molecules=molecules)


def lorentz_berthelot(sig_i, eps_i, sig_j, eps_j, comb_rule=2):
    """Pair mixing: comb-rule 2 the arithmetic sigma and geometric
    epsilon (Lorentz-Berthelot, the reference's Tables,
    `Ewald/structs.jl:337-347`), comb-rule 3 both geometric."""
    if comb_rule == 3:
        return math.sqrt(sig_i * sig_j), math.sqrt(eps_i * eps_j)
    return 0.5 * (sig_i + sig_j), math.sqrt(eps_i * eps_j)
