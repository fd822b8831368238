"""Pair masks and distance grids (counterpart of
metropolismontecarlo_tpu/ops/pairs.py, full-system part).

Cutoff modes: "site" (atom-atom spherical cutoff), "com" / "first" (all
atom pairs of a molecule pair kept iff the COM / first-atom distance is
inside the cutoff).  Excluded pairs contribute exactly zero.
"""

import torch

from metropolismontecarlo_tpu_torch.ops.pbc import (
    batch_view,
    min_image,
    min_image_dist2,
)


def full_pair_mask(coords, com, n_mol, box, r_cut, mode, mol_id=None):
    """(..., A, A) include-mask: inter-molecular pairs inside the cutoff.

    coords (..., A, 3); com (..., M, 3) molecular key points for the
    molecular modes; box of the batch shape (...); mol_id (A,) (derived
    for uniform width when omitted)."""
    A = coords.shape[-2]
    if mol_id is None:
        mol_id = torch.arange(n_mol, device=coords.device) \
            .repeat_interleave(A // n_mol)
    inter = mol_id[:, None] != mol_id[None, :]
    box = batch_view(box, 3)
    if mode == "site":
        d2 = min_image_dist2(coords[..., :, None, :], coords[..., None, :, :],
                             box)
        return inter & (d2 < r_cut * r_cut)
    d2m = min_image_dist2(com[..., :, None, :], com[..., None, :, :], box)
    mcut = d2m < r_cut * r_cut
    mid = mol_id.long()
    return inter & mcut[..., mid, :][..., :, mid]


def pair_dist2(ra, rb, box):
    """Squared minimum-image distances (..., P, A) between ra (..., P, 3)
    and rb (..., A, 3), floored at 1e-4 A^2 like every move path, plus
    the displacements (..., P, A, 3); box of the batch shape (...)."""
    dr = min_image(ra[..., :, None, :] - rb[..., None, :, :],
                   batch_view(box, 3))
    d2 = torch.sum(dr * dr, dim=-1)
    return torch.clamp_min(d2, 1e-4), dr
