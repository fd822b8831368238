"""PDB read and write, host-side numpy (counterpart of
metropolismontecarlo_tpu/io/pdb.py): template molecules in, frames out."""

import numpy as np


def read_pdb(path):
    """ATOM/HETATM records.  Returns a dict of coords (A, 3) float64
    Angstrom, atom_names, res_names, res_ids, elements, and box (3,) from
    CRYST1 (None without one)."""
    coords, atom_names, res_names, res_ids, elements = [], [], [], [], []
    box = None
    with open(path) as f:
        for line in f:
            rec = line[:6].strip()
            if rec == "CRYST1":
                box = np.array([float(line[6:15]), float(line[15:24]),
                                float(line[24:33])])
            elif rec in ("ATOM", "HETATM"):
                # the strict PDB columns first, else whitespace fields
                try:
                    x, y, z = (float(line[30:38]), float(line[38:46]),
                               float(line[46:54]))
                    name = line[12:16].strip()
                    res = line[17:21].strip()
                    rid = int(line[22:26])
                except ValueError:
                    parts = line.split()
                    name, res, rid = parts[2], parts[3], int(parts[4])
                    x, y, z = (float(v) for v in parts[5:8])
                coords.append([x, y, z])
                atom_names.append(name)
                res_names.append(res)
                res_ids.append(rid)
                tail = line.rstrip().split()
                elements.append(tail[-1] if tail and tail[-1].isalpha()
                                else name[0])
    return dict(coords=np.asarray(coords, np.float64), atom_names=atom_names,
                res_names=res_names, res_ids=np.asarray(res_ids),
                elements=elements, box=box)


def write_pdb(path, coords, atom_names, res_names, res_ids, box=None,
              model=1, mode="w"):
    """Write one MODEL frame; coords (A, 3) (numpy or a CPU tensor)."""
    coords = np.asarray(coords)
    with open(path, mode) as f:
        if box is not None:
            b = np.broadcast_to(np.asarray(box, float).reshape(-1), (3,))
            f.write(f"CRYST1{b[0]:9.3f}{b[1]:9.3f}{b[2]:9.3f}"
                    "  90.00  90.00  90.00 P 1           1\n")
        f.write(f"MODEL     {model:4d}\n")
        for i, (xyz, an, rn, ri) in enumerate(
                zip(coords, atom_names, res_names, res_ids), start=1):
            f.write(f"ATOM  {i:5d} {an:<4s}{rn:<4s} {int(ri):4d}    "
                    f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00\n")
        f.write("TER\nENDMDL\n")
