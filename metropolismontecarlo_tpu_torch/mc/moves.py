"""Whole-sweep move path (counterpart of the single-species-block part of
metropolismontecarlo_tpu/mc/moves.py make_mega_sweep_fn).

Builds the sweep's constant tables from a System (per-site LJ rows,
charges, body frame, the shared per-atom rows, k-vectors), draws the
sweep's uniforms from the driver's torch.Generator, calls the sweep op
(ops/cuda/sweep_kernel.py), and folds its statistics into the state:
energy, acc/att [trans, rot] and the move counter.

Not ported yet, and refused rather than skipped: several species blocks
(one kernel call per block) and the sorted-slab windows.  `slab_config`
is ported so that a configuration the JAX package would run with slabs
raises NotImplementedError here.
"""

import dataclasses
import os

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.ops.lj import _shift_coeffs


def _round_up(x, m):
    return -(-x // m) * m


def kernel_coulomb(params):
    """Coulomb style of the kernel ('wolf_ref': the reference convention's
    unshifted erfc pair form, whose global constant cancels in deltas)."""
    if params.coulomb == "wolf" and params.wolf_style != "pairwise":
        return "wolf_ref"
    return params.coulomb


def slab_config(system, params, box_hint, z_hint=None):
    """The JAX package's sorted-slab decision (mc/moves.py slab_config):
    the window configuration dict when it would enable slabs, else None.
    Same inputs, the same environment overrides, the same result."""
    if params.slab_mode == "off" or os.environ.get("MMC_SLABS") == "0":
        return None
    if box_hint is None or params.p_volume > 0.0:
        return None
    force = params.slab_mode == "force" or os.environ.get("MMC_SLABS") == "1"
    slices = system.species_slices
    _, m0, m1, P_w, a0_w = slices[-1]
    M_w = m1 - m0
    A_blk = M_w * P_w
    A = system.n_atoms
    if M_w < 2:
        return None
    r_body = [float(np.max(np.linalg.norm(system.body[b0:b1, :p], axis=-1)))
              for _, b0, b1, p, _ in slices]
    r_half = (max(params.r_cut, params.qq_cut) + r_body[-1] + max(r_body)
              + params.slab_skin)
    frac = 2.0 * r_half / float(box_hint)
    if frac >= 1.0:
        return None
    env_w = int(os.environ.get("MMC_SLAB_W", "0"))
    if env_w:
        W = _round_up(env_w, 128)
    else:
        one_sided = frac * M_w / 2.0 * 1.12
        if z_hint is not None:
            L = float(box_hint)
            zq = np.asarray(z_hint, np.float64) % L
            zb = np.sort(zq[m0:m1])
            mid = np.searchsorted(zb, zq)
            lo = np.where(zq - r_half < 0,
                          np.searchsorted(zb, zq - r_half + L) - M_w,
                          np.searchsorted(zb, zq - r_half))
            hi = np.where(zq + r_half >= L,
                          np.searchsorted(zb, zq + r_half - L) + M_w,
                          np.searchsorted(zb, zq + r_half))
            one_sided = max(one_sided, 1.15 * float(
                np.max(np.maximum(mid - lo, hi - mid))))
        W = _round_up(2 * int(np.ceil(one_sided + 2)) * P_w + 256, 128)
        W = min(W, _round_up(A_blk, 128) - 128 if A_blk % 128 else A_blk)
    if W > A_blk or (not force and W > 0.7 * A_blk):
        return None
    if params.dr_max > params.slab_skin:
        if force:
            raise ValueError(
                f"sorted slabs require dr_max <= slab_skin "
                f"({params.dr_max} > {params.slab_skin})")
        return None
    return dict(m0=m0, m1=m1, P=P_w, a0=a0_w, A_blk=A_blk, W=W,
                r_half=float(r_half), A=A, A_store=_round_up(A + W, 128))


def check_mega_supported(system, params, box_hint=None, z_hint=None):
    """Raise unless the ported whole-sweep path runs this configuration."""
    if not system.species_uniform or params.cutoff_mode != "site" \
            or params.lj_shift not in ("none", "linear") \
            or params.ewald_surface:
        raise ValueError("the whole-sweep path requires a species-uniform "
                         "system, site cutoff, none/linear LJ shift and no "
                         "Ewald surface term")
    if len(system.species_slices) > 1:
        raise NotImplementedError(
            "species-blocked (ragged mixture) sweeps are not ported yet")
    if slab_config(system, params, box_hint, z_hint) is not None:
        raise NotImplementedError(
            "this configuration would run with sorted-slab windows, which "
            "are not ported yet (set slab_mode='off' to run it dense)")


def sweep_tables(system, params, kvecs, kweights, device):
    """SweepTables of the single species block, on `device`."""
    (_, m0, m1, P, _), = system.species_slices
    n_types = system.eps_table.shape[0]
    et = np.asarray(system.eps_table, np.float32)
    st = np.asarray(system.sig_table, np.float32)
    tids = np.asarray(system.type_ids)[m0, :P]
    eps_pt, sig2_pt = et[tids], st[tids] ** 2                     # (P, T)
    lam1_pt = np.zeros((P, n_types), np.float32)
    lam2_pt = np.zeros((P, n_types), np.float32)
    if params.lj_shift == "linear":
        l1, l2 = _shift_coeffs(params.r_cut / st[tids])
        # pre-scaled: the in-kernel shift is eps * (l1 + l2 * r / sigma)
        lam1_pt = et[tids] * l1
        lam2_pt = et[tids] * l2 / st[tids]
    qs = np.asarray(system.charges)[m0, :P]
    A_pad = system.n_atoms_padded
    tid_row = np.full(A_pad, -1, np.int32)
    tid_row[:system.n_atoms] = system.flat(system.type_ids)
    q_row = np.zeros(A_pad, np.float32)
    q_row[:system.n_atoms] = system.flat(system.charges)
    if kvecs is not None:
        kvec, kw = np.asarray(kvecs, np.float32), np.asarray(kweights)
    else:
        kvec, kw = np.zeros((1, 3), np.float32), np.zeros(1)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return sweep_op.SweepTables(
        M=m1 - m0, P=P, coulomb=kernel_coulomb(params),
        lj_shift=params.lj_shift,
        use_rot=bool(P > 1 and params.p_translate < 1.0),
        rc2=float(params.r_cut ** 2), qrc2=float(params.qq_cut ** 2),
        kappa_l=float(params.kappa_L), d2_overlap=float(params.d2_overlap),
        p_translate=float(params.p_translate),
        body=f32(system.body[m0, :P]), qp=f32(qs), eps=f32(eps_pt),
        sig2=f32(sig2_pt), lam1=f32(lam1_pt), lam2=f32(lam2_pt),
        has_lj=i32([np.any(et[t] != 0.0) for t in tids]),
        has_q=i32(qs != 0.0), tid_row=i32(tid_row),
        molid_row=i32(system.mol_of_atom_padded), q_row=f32(q_row),
        kvec=f32(kvec), kw=f32(kw))


def draw_uniforms(n_chains, n_moves, generator, device):
    """The sweep's uniforms, (C, M, 10) f32 in [0, 1)."""
    return torch.rand((n_chains, n_moves, sweep_op.N_UNIFORMS),
                      generator=generator, dtype=torch.float32,
                      device=device)


def make_mega_sweep_fn(system, params, kvecs, kweights, device,
                       box_hint=None, z_hint=None):
    """Returns sweep_full(state, generator) -> state: one whole-sweep
    kernel call.  sweep_full.tables holds the SweepTables."""
    check_mega_supported(system, params, box_hint, z_hint)
    tables = sweep_tables(system, params, kvecs, kweights, device)
    M = system.n_mol
    ewald = params.coulomb == "ewald"

    def sweep_full(state, generator):
        C = state.com.shape[0]
        u = draw_uniforms(C, M, generator, state.com.device)
        f32 = torch.float32
        coords, com, quat, sfac, stats = sweep_op.sweep(
            state.coords.to(f32).contiguous(), state.com.to(f32).contiguous(),
            state.quat.to(f32).contiguous(), state.sfac.to(f32).contiguous(),
            state.box.to(f32).contiguous(), state.temp.to(f32).contiguous(),
            state.dr_max.to(f32).contiguous(),
            state.dphi_max.to(f32).contiguous(), u, tables)
        zero = torch.zeros_like(stats[:, 1])
        acc_d = torch.stack([stats[:, 1], stats[:, 2], zero], 1).to(
            torch.int32)
        att_d = torch.stack([stats[:, 3], stats[:, 4], zero], 1).to(
            torch.int32)
        dtype = state.com.dtype
        return dataclasses.replace(
            state, coords=coords.to(dtype), com=com.to(dtype),
            quat=quat.to(dtype),
            sfac=sfac.to(dtype) if ewald else state.sfac,
            energy=state.energy + stats[:, 0].to(dtype),
            step=state.step + M, acc=state.acc + acc_d,
            att=state.att + att_d)

    sweep_full.tables = tables
    return sweep_full
