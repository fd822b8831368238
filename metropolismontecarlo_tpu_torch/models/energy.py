"""Full-system energy with component breakdown (counterpart of
metropolismontecarlo_tpu/models/energy.py, dense route).

One function over dense masked (A, A) pair grids, batched over a leading
chain axis written out (the JAX version is single-configuration and
vmapped).  Used at initialisation and for the block-end drift check and
resync.  Systems above 4096 atoms need the row-tiled route, which is not
ported yet.
"""

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.ops import coulomb as coulomb_ops
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops import lj as lj_ops
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.ops import wolf as wolf_ops
from metropolismontecarlo_tpu_torch.ops.pairs import full_pair_mask, pair_dist2
from metropolismontecarlo_tpu_torch.ops.pbc import batch_view, min_image

DENSE_MAX_ATOMS = 4096


def _intra_terms(system, coords, kappa, box):
    """(E_intra, W_intra_kappa) summed over species blocks."""
    e = w = torch.zeros(coords.shape[:-2], dtype=coords.dtype,
                        device=coords.device)
    for _, m0, m1, p, a0 in system.species_slices:
        if p < 2:
            continue
        c = coords[..., a0:a0 + (m1 - m0) * p, :].reshape(
            coords.shape[:-2] + (m1 - m0, p, 3))
        q = torch.tensor(np.array(system.charges[m0:m1, :p]),
                         dtype=coords.dtype, device=coords.device)
        e = e + ewald_ops.ewald_intra(c, q, kappa, box)
        w = w + ewald_ops.ewald_intra_kappa(c, q, kappa, box)
    return e, w


def energy_breakdown(system, params, coords, com, box, kvecs=None,
                     kweights=None):
    """Total potential energy by component.

    coords (..., A, 3), com (..., M, 3), box of the batch shape (...)
    (float or tensor); kvecs/kweights numpy (from ewald.make_kvectors)
    when coulomb == "ewald".  Returns a dict of (...) tensors: disp, lrc,
    coul_real, coul_fourier, coul_self, coul_intra, total, w (exact
    molecular virial), w_ref (reference convention), and sfac (..., K, 2)
    ((..., 1, 2) zeros without Ewald) -- the keys of the JAX version.
    """
    if system.n_atoms > DENSE_MAX_ATOMS:
        raise NotImplementedError(
            "systems above 4096 atoms need the row-tiled energy route, "
            "which is not ported yet")
    dtype, dev = coords.dtype, coords.device
    batch = coords.shape[:-2]
    box = torch.as_tensor(box, dtype=dtype, device=dev)
    box = torch.broadcast_to(box, batch)

    def t(x, dt=dtype):   # System arrays are read-only numpy: copy
        return torch.tensor(np.array(x), dtype=dt, device=dev)

    M = system.n_mol
    tid = t(system.flat(system.type_ids), torch.long)
    charges = t(system.flat(system.charges))
    eps_t, sig_t = t(system.eps_table), t(system.sig_table)
    eps_pair = eps_t[tid[:, None], tid[None, :]]
    sig_pair = sig_t[tid[:, None], tid[None, :]]
    mol_id = t(system.mol_of_atom_padded[: system.n_atoms], torch.long)
    key = com if params.cutoff_mode != "first" \
        else coords[..., t(system.mol_a0, torch.long), :]

    d2, dr_ab = pair_dist2(coords, coords, box)
    # molecular displacement in the image consistent with each atom pair:
    # r_ij = r_ab - (d_a - d_b), d the rigid atom-from-COM offsets
    delta = min_image(coords - com[..., mol_id, :], batch_view(box, 2))
    dr_ij = dr_ab - delta[..., :, None, :] + delta[..., None, :, :]

    site = params.cutoff_mode == "site"
    mask_lj = full_pair_mask(coords, key, M, box, params.r_cut,
                             "site" if site else params.cutoff_mode,
                             mol_id=mol_id)
    pot, w = lj_ops.lj_masked_sum(d2, dr_ab, dr_ij, mask_lj, eps_pair,
                                  sig_pair, params.r_cut, params.lj_shift,
                                  site_cutoff=False)
    out = {"disp": 0.5 * pot}
    w_total = 0.5 * w

    counts = t(system.type_counts)
    vol = box**3
    zero = torch.zeros(batch, dtype=dtype, device=dev)
    w_lrc = w_lrc_ref = zero
    if params.use_lrc and params.lj_shift == "none":
        out["lrc"] = tail_ops.lrc_energy(counts, eps_t, sig_t, params.r_cut,
                                         vol)
        # exact dU/dV of U_lrc = C/V is -U_lrc/V, i.e. w_lrc = 3 U_lrc;
        # w_ref keeps the textbook virial-integral form
        w_lrc = 3.0 * out["lrc"]
        w_lrc_ref = 3.0 * vol * tail_ops.lrc_pressure(
            counts, eps_t, sig_t, params.r_cut, vol)
    else:
        out["lrc"] = zero

    e_real = e_four = e_self = e_intra = zero
    w_ref = w_coul = zero
    sfac = torch.zeros(batch + (1, 2), dtype=dtype, device=dev)
    if params.coulomb != "none":
        kappa = params.kappa_L / box
        qq = charges[:, None] * charges[None, :]
        if params.qq_r_cut is None and params.cutoff_mode != "site":
            mask_qq = mask_lj
        else:
            mask_qq = full_pair_mask(coords, key, M, box, params.qq_cut,
                                     params.cutoff_mode, mol_id=mol_id)
        dot = torch.sum(dr_ij * dr_ab, dim=-1)
        if params.coulomb == "ewald":
            kv, kw = t(kvecs, torch.int32), t(kweights)
            e_real = 0.5 * ewald_ops.real_space_sum(d2, qq, mask_qq, kappa)
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box)
            sfac = ewald_ops.structure_factor(coords, charges, kv, box)
            e_four = ewald_ops.recip_energy(sfac, cf)
            e_self = ewald_ops.ewald_self(charges, kappa)
            e_intra, w_intra = _intra_terms(system, coords, kappa, box)
            com_atom = com[..., mol_id, :]
            w_coul = (
                0.5 * ewald_ops.real_space_virial(d2, qq, dot, mask_qq,
                                                  kappa, "ewald")
                + ewald_ops.recip_virial(sfac, cf, coords, com_atom,
                                         charges, kv, box)
                + e_self + w_intra)
            if params.ewald_surface:
                e_surf = ewald_ops.surface_term(coords, com_atom, charges,
                                                box)
                e_four = e_four + e_surf
                w_coul = w_coul + 3.0 * e_surf
        elif params.coulomb == "wolf":
            shifted = params.wolf_style == "pairwise"
            e_real = 0.5 * wolf_ops.wolf_pair_sum(
                d2, qq, mask_qq, kappa, params.qq_cut, shifted=shifted)
            e_self = wolf_ops.wolf_self(charges, kappa, params.qq_cut)
            # the virial sums the same pair set the energy keeps
            keep_w = mask_qq & (d2 < params.qq_cut ** 2)
            w_coul = (
                0.5 * ewald_ops.real_space_virial(
                    d2, qq, dot, keep_w, kappa,
                    "wolf" if shifted else "ewald", qq_cut=params.qq_cut)
                + wolf_ops.wolf_self_kappa(charges, kappa, params.qq_cut))
            if not shifted:
                e_self = e_self + wolf_ops.wolf_ref_const(
                    charges, kappa, params.qq_cut)
                w_coul = w_coul + wolf_ops.wolf_ref_const_kappa(
                    charges, kappa, params.qq_cut)
        elif params.coulomb == "bare":
            e_real = 0.5 * coulomb_ops.bare_pair_sum(d2, qq, mask_qq)
            w_coul = 0.5 * ewald_ops.real_space_virial(
                d2, qq, dot, mask_qq, kappa, "bare")
        else:
            raise ValueError(f"unknown coulomb style {params.coulomb!r}")
        w_ref = e_real + e_four + e_self + e_intra

    out["coul_real"] = e_real
    out["coul_fourier"] = e_four
    out["coul_self"] = e_self
    out["coul_intra"] = e_intra
    out["total"] = out["disp"] + out["lrc"] + e_real + e_four + e_self \
        + e_intra
    out["w"] = w_total + w_lrc + w_coul
    out["w_ref"] = w_total + w_lrc_ref + w_ref
    out["sfac"] = sfac
    return out
