"""Starting configurations (counterpart of
metropolismontecarlo_tpu/io/configs.py; the file readers are not ported
yet)."""

import numpy as np


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
