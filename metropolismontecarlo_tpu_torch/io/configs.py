"""Starting configurations, host-side numpy (counterpart of
metropolismontecarlo_tpu/io/configs.py):

  * read_nist: NIST SPC/E sample configurations;
  * read_cnf / write_cnf: the Allen & Tildesley CNF format (COM +
    quaternion);
  * cubic_lattice: lattice starts.

Readers return float64 numpy; the models and the driver pick device and
dtype.
"""

import numpy as np


def _lines(path):
    with open(path) as f:
        return [ln for ln in (raw.strip() for raw in f) if ln]


def read_nist(path):
    """A NIST SPC/E sample configuration: line 1 the box lengths (cubic),
    line 2 the number of molecules, then one line per atom "index x y z
    species", molecules grouped O, H, H.  Returns (coords (A, 3) float64
    Angstrom, species list of str, box float)."""
    lines = _lines(path)
    box = float(lines[0].split()[0])
    n_mol = int(lines[1].split()[0])
    coords, species = [], []
    for ln in lines[2:2 + 3 * n_mol]:
        parts = ln.split()
        coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
        species.append(parts[4])
    return np.asarray(coords, dtype=np.float64), species, box


def read_cnf(path):
    """An Allen & Tildesley CNF configuration: line 1 the number of
    molecules, line 2 the box edge, then per molecule "x y z qw qx qy qz".
    Returns (com (M, 3), quat (M, 4), box) float64."""
    lines = _lines(path)
    n = int(lines[0].split()[0])
    box = float(lines[1].split()[0])
    rows = np.asarray([[float(x) for x in lines[2 + i].split()]
                       for i in range(n)], dtype=np.float64)
    return rows[:, 0:3], rows[:, 3:7], box


def write_cnf(path, com, quat, box):
    """Write the CNF configuration that read_cnf reads back."""
    com = np.asarray(com)
    quat = np.asarray(quat)
    with open(path, "w") as f:
        f.write(f"{com.shape[0]:>13d}\n")
        f.write(f"{float(box):>15.8f}\n")
        for c, q in zip(com, quat):
            f.write("".join(f"{v:>15.10f}" for v in (*c, *q)) + "\n")


def cubic_lattice(n_mol, box, jitter=0.0, rng=None):
    """Simple-cubic lattice of n_mol sites in a cubic box, (n_mol, 3)
    float64 numpy."""
    n_side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    spacing = box / n_side
    idx = np.arange(n_side)
    grid = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    pts = (grid[:n_mol] + 0.5) * spacing
    if jitter:
        rng = rng or np.random.default_rng(0)
        pts = pts + rng.uniform(-jitter, jitter, size=pts.shape)
    return pts.astype(np.float64)
