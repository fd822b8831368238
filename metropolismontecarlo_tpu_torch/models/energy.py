"""Full-system energy with component breakdown (counterpart of
metropolismontecarlo_tpu/models/energy.py).

Batched over a leading chain axis written out (the JAX version is
single-configuration and vmapped).  Up to DENSE_MAX_ATOMS atoms one
function over dense masked (A, A) pair grids; above it a row-tiled scan
of (B, A) tiles (site cutoff only), so peak memory is O(C B A); the
tiled route also splits its rows over the ranks of a process group
(row_shard, the tensor-parallel recompute of parallel/tp.py).  Used at
initialisation, for the block-end drift check and resync, and by the NPT
volume move and pressure_fd.
"""

import numpy as np
import torch
import torch.distributed as dist

from metropolismontecarlo_tpu_torch.ops import coulomb as coulomb_ops
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops import lj as lj_ops
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.ops import wolf as wolf_ops
from metropolismontecarlo_tpu_torch.ops.pairs import full_pair_mask, pair_dist2
from metropolismontecarlo_tpu_torch.ops.pbc import batch_view, min_image
from metropolismontecarlo_tpu_torch.utils import profiling
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

DENSE_MAX_ATOMS = 4096
ROW_BLOCK = 256


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
    The dense route runs in three spans (utils/profiling.py):
    energy.setup (the tables' uploads), energy.real (the pair grids and
    masks, LJ and its tail, the real-space Coulomb sum) and, with Ewald,
    energy.kspace (S(k), the reciprocal energy, the self and intramolecular
    terms and the Coulomb virial, its real-space part included).  The
    spans follow the arithmetic's order, which stays: putting the masks
    and uploads first made the flagship recompute 3.6% slower on an H100.
    """
    if system.n_atoms > DENSE_MAX_ATOMS:
        return energy_breakdown_tiled(system, params, coords, com, box,
                                      kvecs, kweights)
    dtype, dev = coords.dtype, coords.device
    batch = coords.shape[:-2]
    box = torch.as_tensor(box, dtype=dtype, device=dev)
    box = torch.broadcast_to(box, batch)

    def t(x, dt=dtype):   # System arrays are read-only numpy: copy
        return torch.tensor(np.array(x), dtype=dt, device=dev)

    M = system.n_mol
    with profiling.span("energy.setup", sync=False):
        tid = t(system.flat(system.type_ids), torch.long)
        charges = t(system.flat(system.charges))
        eps_t, sig_t = t(system.eps_table), t(system.sig_table)
        eps_pair = eps_t[tid[:, None], tid[None, :]]
        sig_pair = sig_t[tid[:, None], tid[None, :]]
        mol_id = t(system.mol_of_atom_padded[: system.n_atoms], torch.long)
        key = com if params.cutoff_mode != "first" \
            else coords[..., t(system.mol_a0, torch.long), :]

    with profiling.span("energy.real", sync=False):
        d2, dr_ab = pair_dist2(coords, coords, box)
        # molecular displacement in the image consistent with each atom
        # pair: r_ij = r_ab - (d_a - d_b), d the rigid atom-from-COM offsets
        delta = min_image(coords - com[..., mol_id, :], batch_view(box, 2))
        dr_ij = dr_ab - delta[..., :, None, :] + delta[..., None, :, :]

        site = params.cutoff_mode == "site"
        mask_lj = full_pair_mask(coords, key, M, box, params.r_cut,
                                 "site" if site else params.cutoff_mode,
                                 mol_id=mol_id)
        pot, w = lj_ops.lj_masked_sum(d2, dr_ab, dr_ij, mask_lj, eps_pair,
                                      sig_pair, params.r_cut,
                                      params.lj_shift, site_cutoff=False)
        out = {"disp": 0.5 * pot}
        w_total = 0.5 * w

        zero = torch.zeros(batch, dtype=dtype, device=dev)
        out["lrc"], w_lrc, w_lrc_ref = _lrc_terms(system, params, box)

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
        elif params.coulomb != "none":
            raise ValueError(f"unknown coulomb style {params.coulomb!r}")

    if params.coulomb == "ewald":
        with profiling.span("energy.kspace", sync=False):
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box)
            sfac = ewald_ops.structure_factor(coords, charges, kv, box,
                                              ewald_ops.k_bounds(kvecs))
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
    if params.coulomb != "none":
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


def _lrc_terms(system, params, box):
    """(E_lrc, W_lrc, W_lrc reference convention) of the batch shape of
    box; zeros without the tail correction.  The exact dU/dV of
    U_lrc = C/V is -U_lrc/V, so W_lrc = 3 U_lrc; the reference keeps the
    textbook virial-integral form."""
    dtype, dev = box.dtype, box.device
    zero = torch.zeros(box.shape, dtype=dtype, device=dev)
    if not (params.use_lrc and params.lj_shift == "none"):
        return zero, zero, zero
    counts = torch.tensor(np.array(system.type_counts), dtype=dtype,
                          device=dev)
    eps_t = torch.tensor(np.array(system.eps_table), dtype=dtype, device=dev)
    sig_t = torch.tensor(np.array(system.sig_table), dtype=dtype, device=dev)
    vol = box**3
    e = tail_ops.lrc_energy(counts, eps_t, sig_t, params.r_cut, vol)
    return e, 3.0 * e, 3.0 * vol * tail_ops.lrc_pressure(
        counts, eps_t, sig_t, params.r_cut, vol)


def energy_breakdown_tiled(system, params, coords, com, box, kvecs=None,
                           kweights=None, row_block=ROW_BLOCK, row_shard=None):
    """energy_breakdown's row-tiled route (the JAX
    _energy_breakdown_tiled): the pair sums scan row blocks of `row_block`
    atoms against all A atoms, (..., B, A) tiles, with per-pair LJ
    parameters gathered from the (T, T) tables; the structure factor is
    structure_factor's form at this K over the whole batch (the caller
    bounds the batch).  Site cutoff only; same arguments and keys as
    energy_breakdown.

    row_shard=(group, n_shards): the tensor-parallel mode, called by every
    rank of the torch.distributed process group `group` (n_shards ranks,
    parallel/tp.py) on the same configurations.  The rows, padded to a
    multiple of row_block * n_shards so every rank scans as many blocks,
    are split in rank order: each rank scans its own row blocks and takes
    the S(k) and reciprocal-virial contractions over its own atom slice
    (the O(A^2) and O(K A) work); the pair sums and the partial S(k) are
    summed over the group by one all_reduce, the virial's T-contraction
    by a second; the O(A) terms (self, intra, tail, surface) are computed
    on every rank.  Every rank returns the whole breakdown."""
    if params.cutoff_mode != "site":
        raise NotImplementedError("the row-tiled recompute supports site "
                                  "cutoff only")
    dtype, dev = coords.dtype, coords.device
    batch = coords.shape[:-2]
    box = torch.broadcast_to(torch.as_tensor(box, dtype=dtype, device=dev),
                             batch)

    def t(x, dt=dtype):   # System arrays are read-only numpy: copy
        return torch.tensor(np.array(x), dtype=dt, device=dev)

    A = system.n_atoms
    tid = t(system.flat(system.type_ids), torch.long)
    mol = t(system.atom_mol_slot[0], torch.long)
    charges = t(system.flat(system.charges))
    eps_t, sig2_t = t(system.eps_table), t(system.sig_table) ** 2
    com_of_col = com[..., mol, :]
    # rigid atom-from-COM offsets for the pair-consistent molecular image
    delta = min_image(coords - com_of_col, batch_view(box, 2))   # (..., A, 3)
    rc2, qrc2 = params.r_cut ** 2, params.qq_cut ** 2
    kappa = params.kappa_L / box
    kappa2 = batch_view(kappa, 2)
    box3 = batch_view(box, 3)
    use_coul = params.coulomb != "none"
    wolf_ref = params.coulomb == "wolf" and params.wolf_style != "pairwise"
    c2 = ewald_ops._TWO_OVER_RTPI

    # this rank's rows [lo, hi) (all of them unsharded): a span of whole
    # blocks of the rows padded to row_block * n_shards, as the JAX
    # route's per-shard block range
    group, lo, hi = None, 0, A
    if row_shard is not None:
        group, n_sh = row_shard
        if dist.get_world_size(group) != n_sh:
            raise ValueError(f"row_shard names {n_sh} shards of a group of "
                             f"{dist.get_world_size(group)} ranks")
        span = -(-A // (row_block * n_sh)) * row_block
        lo = dist.get_rank(group) * span
        hi = min(A, lo + span)
    zero = torch.zeros(batch, dtype=dtype, device=dev)
    pot = w = e_real_raw = w_coul_raw = zero
    for i0 in range(lo, hi, row_block):
        rows = slice(i0, min(hi, i0 + row_block))
        dr = min_image(coords[..., rows, None, :] - coords[..., None, :, :],
                       box3)                                   # (..., B, A, 3)
        d2 = torch.clamp_min(torch.sum(dr * dr, dim=-1), 1e-4)
        valid = mol[rows, None] != mol[None, :]
        mask_lj = valid & (d2 < rc2)
        mask_qq = valid & (d2 < qrc2)
        d2s = torch.where(mask_lj | mask_qq, d2, torch.ones((), dtype=dtype,
                                                            device=dev))
        eps_pa = eps_t[tid[rows]][:, tid]                      # (B, A)
        sig2_pa = sig2_t[tid[rows]][:, tid]
        s2 = sig2_pa / d2s
        s6 = s2 * s2 * s2
        pair_pot = 4.0 * eps_pa * (s6 * s6 - s6)
        wvir = 24.0 * eps_pa * (2.0 * s6 * s6 - s6)
        if params.lj_shift == "linear":
            # the shift's force term too, as ops/lj.py lj_pair_terms (the
            # JAX tiled route leaves it out of the virial)
            sig_pa = torch.sqrt(sig2_pa)
            lam1, lam2 = lj_ops._shift_coeffs(params.r_cut / sig_pa)
            r_sig = torch.sqrt(d2s) / sig_pa
            pair_pot = pair_pot + eps_pa * (lam1 + lam2 * r_sig)
            wvir = wvir - eps_pa * lam2 * r_sig
        pot = pot + torch.sum(torch.where(mask_lj, pair_pot, 0.0),
                              dim=(-1, -2))
        # molecular virial with the pair-consistent COM image
        # r_ij = r_ab - (d_a - d_b)
        mol_dr = dr - delta[..., rows, None, :] + delta[..., None, :, :]
        dot = torch.sum(mol_dr * dr, dim=-1)
        w = w + torch.sum(torch.where(mask_lj, wvir * (dot / d2s), 0.0),
                          dim=(-1, -2))
        if use_coul:
            qq = charges[rows, None] * charges[None, :]
            r = torch.sqrt(d2s)
            if params.coulomb == "bare":
                cp = qq / r
                wv = qq * dot / (d2s * r)
            else:
                erfc = torch.special.erfc(kappa2 * r)
                cp = qq * erfc / r
                if params.coulomb == "wolf" and not wolf_ref:
                    cp = qq * (erfc / r - torch.special.erfc(
                        kappa2 * params.qq_cut) / params.qq_cut)
                gauss = torch.exp(-(kappa2 * kappa2) * d2s)
                wv = qq * (dot * (erfc / (d2s * r) + kappa2 * c2 * gauss
                                  / d2s) - kappa2 * c2 * gauss)
                if params.coulomb == "wolf" and not wolf_ref:
                    wv = wv + qq * kappa2 * c2 * torch.exp(
                        -(kappa2 * params.qq_cut) ** 2)
            e_real_raw = e_real_raw + torch.sum(
                torch.where(mask_qq, cp, 0.0), dim=(-1, -2))
            w_coul_raw = w_coul_raw + torch.sum(
                torch.where(mask_qq, wv, 0.0), dim=(-1, -2))

    sfac = torch.zeros(batch + (1, 2), dtype=dtype, device=dev)
    ewald = params.coulomb == "ewald"
    if ewald:
        # S(k) of this rank's atom slice, the same rows its tiles scanned
        kv, kw = t(kvecs, torch.int32), t(kweights)
        sfac = ewald_ops.structure_factor(
            coords[..., lo:hi, :], charges[lo:hi], kv, box,
            ewald_ops.k_bounds(kvecs)) if hi > lo \
            else torch.zeros(batch + (kv.shape[0], 2), dtype=dtype,
                             device=dev)
    if group is not None:
        pot, w, e_real_raw, w_coul_raw, sfac = _group_sum(
            group, pot, w, e_real_raw, w_coul_raw, sfac)

    out = {"disp": 0.5 * pot}
    out["lrc"], w_lrc, w_lrc_ref = _lrc_terms(system, params, box)
    e_real = e_four = e_self = e_intra = zero
    w_ref = w_coul = zero
    if use_coul:
        e_real = 0.5 * COULOMB_FACTOR * e_real_raw
        w_coul = 0.5 * COULOMB_FACTOR * w_coul_raw
        if ewald:
            cf = ewald_ops.cfac_coeffs(kv, kw, kappa, box)
            e_four = ewald_ops.recip_energy(sfac, cf)
            w_recip = ewald_ops.recip_virial(
                sfac, cf, coords[..., lo:hi, :], com_of_col[..., lo:hi, :],
                charges[lo:hi], kv, box)
            if group is not None:
                # recip_virial = E_recip (from the whole S(k), the same on
                # every rank) minus the T-contraction over this rank's
                # atoms: sum only the latter
                w_recip = e_four + _group_sum(group, w_recip - e_four)[0]
            e_self = ewald_ops.ewald_self(charges, kappa)
            e_intra, w_intra = _intra_terms(system, coords, kappa, box)
            w_coul = w_coul + w_recip + e_self + w_intra
            if params.ewald_surface:
                e_surf = ewald_ops.surface_term(coords, com_of_col, charges,
                                                box)
                e_four = e_four + e_surf
                w_coul = w_coul + 3.0 * e_surf
        elif params.coulomb == "wolf":
            e_self = wolf_ops.wolf_self(charges, kappa, params.qq_cut)
            w_coul = w_coul + wolf_ops.wolf_self_kappa(charges, kappa,
                                                       params.qq_cut)
            if wolf_ref:
                e_self = e_self + wolf_ops.wolf_ref_const(
                    charges, kappa, params.qq_cut)
                w_coul = w_coul + wolf_ops.wolf_ref_const_kappa(
                    charges, kappa, params.qq_cut)
        w_ref = e_real + e_four + e_self + e_intra

    out["coul_real"] = e_real
    out["coul_fourier"] = e_four
    out["coul_self"] = e_self
    out["coul_intra"] = e_intra
    out["total"] = out["disp"] + out["lrc"] + e_real + e_four + e_self \
        + e_intra
    out["w"] = 0.5 * w + w_lrc + w_coul
    out["w_ref"] = 0.5 * w + w_lrc_ref + w_ref
    out["sfac"] = sfac
    return out


def _group_sum(group, *parts):
    """The parts summed over the ranks of `group` in one all_reduce."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for p in parts:
        out.append(flat[i:i + p.numel()].reshape(p.shape))
        i += p.numel()
    return out


def pressure(params, n_mol, volume, w):
    """P / kB = rho T + w / (3 V), the tail folded into w by
    energy_breakdown (the reference's `Pressure`)."""
    return n_mol / volume * params.temperature + w / (3.0 * volume)
