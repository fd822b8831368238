"""Pair masks and distance grids (counterpart of
metropolismontecarlo_tpu/ops/pairs.py).

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


def molecule_key_points(coords_mpa, com, mode):
    """Per-molecule cutoff key point: coords_mpa (..., M, P, 3), com (...,
    M, 3) -> (..., M, 3), the COM ("com") or the first atom ("first")."""
    if mode == "com":
        return com
    if mode == "first":
        return coords_mpa[..., :, 0, :]
    raise ValueError(f"no molecular key point for cutoff mode {mode!r}")


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


def moved_pair_mask(ra_key, coords, com, mol_index, n_mol, box, r_cut,
                    mode):
    """(A,) include-mask of one moved molecule against the system (uniform
    width, A = n_mol * P): the molecular cutoff on its key point ra_key
    (3,) against every molecule's key point com (M, 3), the molecule's own
    (stale) atoms excluded.  The same for every atom of the moved
    molecule, so it broadcasts over the moved-atom axis."""
    A = coords.shape[0]
    P = A // n_mol
    mol_id = torch.arange(n_mol, device=coords.device).repeat_interleave(P)
    other = mol_id != mol_index
    if mode == "site":
        raise NotImplementedError(
            "per-move site cutoff requires the moved atom coords; "
            "use moved_pair_mask_site"
        )
    d2m = min_image_dist2(ra_key[None, :], com, box)          # (M,)
    return other & (d2m < r_cut * r_cut)[mol_id]


def moved_pair_mask_site(ra, coords, mol_index, n_mol, box, r_cut):
    """(P, A) site-cutoff include-mask of the moved atoms ra (P, 3) against
    coords (A, 3) (uniform width), the molecule's own atoms excluded."""
    A = coords.shape[0]
    P = A // n_mol
    mol_id = torch.arange(n_mol, device=coords.device).repeat_interleave(P)
    other = mol_id != mol_index
    d2 = min_image_dist2(ra[:, None, :], coords[None, :, :], box)
    return other[None, :] & (d2 < r_cut * r_cut)


def pair_dist2(ra, rb, box):
    """Squared minimum-image distances (..., P, A) between ra (..., P, 3)
    and rb (..., A, 3), floored at 1e-4 A^2 like every move path, plus
    the displacements (..., P, A, 3); box of the batch shape (...)."""
    dr = min_image(ra[..., :, None, :] - rb[..., None, :, :],
                   batch_view(box, 3))
    d2 = torch.sum(dr * dr, dim=-1)
    return torch.clamp_min(d2, 1e-4), dr
