"""Move paths (counterpart of metropolismontecarlo_tpu/mc/moves.py).

* The whole-sweep route, `make_mega_sweep_fn`: builds each species
  block's constant tables (per-site LJ rows, charges, body frame) and the
  shared per-atom rows and k-vectors, draws the sweep's uniforms once as
  (C, M, 10), and launches the sweep op once per block in storage order,
  threading coordinates, COM, quaternions and S(k) from launch to launch
  and summing the statistics.  Given a box (and z) hint where
  `slab_config` finds sorted slabs profitable, each sweep first z-sorts
  every block per chain (`make_slab_resort_fn`, which also checks the
  windows' coverage into state.nbr_needed) and the planes carry a ghost
  halo of the sorted block's first W columns, so each move scans the
  other blocks and one W-wide window of the sorted block
  (`slab_window_starts`).  With with_activity it returns the
  fluctuating-N variants on the MolGCMCState layout instead: `sweep_act`
  (activity-masked moves) or, with n_exch / n_widom, `sweep_x` (moves,
  then in-kernel exchange attempts and Widom ghosts per block; with
  tmmc_exch also the transition-matrix deposits).
* The Gibbs cycle, `make_mega_gibbs_fn`: one launch of the two-box Gibbs
  op (ops/cuda/gibbs_kernel.py) per cycle on the MolGibbsState layout,
  2 cap moves and n_exch transfer attempts.
* The semigrand flips, `make_mega_flip_fn`: one launch of the flip op
  (ops/cuda/flip_kernel.py) of n_flip identity flips on the
  SemigrandState layout.
* The per-move route, `make_sweep_fn`: one molecule move of every chain
  per call, for one species block.  Its proposal reads the same 10
  uniform columns with the same formulas as the sweep kernel, so both
  routes follow one trajectory on one set of uniforms.  The pair energy
  comes from the delta-energy op (kernel branch: site cutoff, unshifted
  LJ, f32, no Ewald surface term) or from plain tensor code
  (`pair_energy_rows`: every cutoff mode, the linear shift, the surface
  term, float64; with Verlet neighbour lists, `pair_energy_nlist`: the
  moved molecule against its listed neighbours' atoms only).
  `run_moves` runs a sweep's moves through the bodies; `MoveSweepGraph`
  runs them as one captured CUDA graph on the card.
* Verlet neighbour lists, `nlist_radius` and `rebuild_nlist`: for every
  molecule the nlist_width nearest other molecules within the list
  radius, rebuilt by the driver at every sweep.
"""

import dataclasses
import math
import os

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.models.energy import DENSE_MAX_ATOMS
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as delta_op
from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as flip_op
from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gibbs_op
from metropolismontecarlo_tpu_torch.ops.cuda import (
    recompute_kernel as recompute_op,
)
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.ops.lj import _shift_coeffs
from metropolismontecarlo_tpu_torch.ops.pbc import min_image
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR
from metropolismontecarlo_tpu_torch.utils.shard import (
    chain_offset,
    rand_chains,
)


def _round_up(x, m):
    return -(-x // m) * m


def kernel_coulomb(params):
    """Coulomb style of the kernels ('wolf_ref': the reference convention's
    unshifted erfc pair form, whose global constant cancels in deltas)."""
    if params.coulomb == "wolf" and params.wolf_style != "pairwise":
        return "wolf_ref"
    return params.coulomb


def slab_config(system, params, box_hint, z_hint=None):
    """The JAX package's sorted-slab decision (mc/moves.py slab_config):
    the window configuration dict when it would enable slabs, else None.
    Same inputs, the same environment overrides, the same result, except
    that a zero-width window (a sorted block under 128 atoms) is None."""
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
    # W = 0 (a sorted block under 128 atoms) would scan no window at all:
    # refused here, where the JAX function returns it
    if W == 0 or W > A_blk or (not force and W > 0.7 * A_blk):
        return None
    if params.dr_max > params.slab_skin:
        if force:
            raise ValueError(
                f"sorted slabs require dr_max <= slab_skin "
                f"({params.dr_max} > {params.slab_skin})")
        return None
    return dict(m0=m0, m1=m1, P=P_w, a0=a0_w, A_blk=A_blk, W=W,
                r_half=float(r_half), A=A, A_store=_round_up(A + W, 128))


def mega_supported(system, params, dtype=torch.float32):
    """Whether the whole-sweep kernel route runs these conventions."""
    return (system.species_uniform and params.cutoff_mode == "site"
            and params.lj_shift in ("none", "linear")
            and dtype == torch.float32 and not params.ewald_surface)


def recompute_kernel_supported(system, params, dtype=torch.float32,
                               device="cuda", tp_mesh=None):
    """Whether the full-energy recompute runs as the CUDA kernel
    (ops/cuda/recompute_kernel.py): on the card in float32, site cutoff,
    none/linear LJ shift, Ewald (without the surface term) or no Coulomb,
    the dense route's atom counts (n_atoms <= DENSE_MAX_ATOMS), no
    tensor-parallel mesh, and within the kernel's tables (at most
    MAX_TYPES LJ types, k indices within MAX_NK).  Every other run keeps
    models/energy.py energy_breakdown, the kernel's plain twin."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and params.cutoff_mode == "site"
            and params.lj_shift in ("none", "linear")
            and params.coulomb in ("ewald", "none")
            and not params.ewald_surface
            and system.n_atoms <= DENSE_MAX_ATOMS and tp_mesh is None
            and system.eps_table.shape[0] <= recompute_op.MAX_TYPES
            and (params.coulomb != "ewald"
                 or params.nk <= recompute_op.MAX_NK))


def check_mega_supported(system, params):
    """Raise unless the whole-sweep route runs this configuration."""
    if not mega_supported(system, params):
        raise ValueError("the whole-sweep route requires a species-uniform "
                         "system, site cutoff, none/linear LJ shift, "
                         "float32 and no Ewald surface term")


def slab_window_starts(system, cfg):
    """(M,) int32 numpy: each molecule's static, 128-aligned window start
    (a global column) into the sorted block (the JAX function of this
    name).  Molecules of the sorted block centre on their own sorted
    slot; other (also z-sorted) blocks map their slot proportionally.
    Read by the kernel per move and by the resort's coverage check."""
    m0_w, P_w, a0_w = cfg["m0"], cfg["P"], cfg["a0"]
    M_w = cfg["m1"] - m0_w
    A_blk, W, A_store = cfg["A_blk"], cfg["W"], cfg["A_store"]
    out = np.zeros(system.n_mol, np.int32)
    for _, b0, b1, _, _ in system.species_slices:
        for m in range(b0, b1):
            if b0 == m0_w:
                c = (m - m0_w) * P_w
            else:
                c = int((m - b0 + 0.5) / (b1 - b0) * M_w) * P_w
            start_rel = (c + P_w // 2 - W // 2) % A_blk
            g = a0_w + start_rel
            out[m] = min((g // 128) * 128, A_store - W)
    return out


def make_slab_resort_fn(system, params, cfg):
    """resort(state) -> state (the JAX make_slab_resort_fn): a per-chain
    stable z-sort of every species block of >= 2 molecules (COM,
    quaternion and atom columns permuted together: an energy-invariant
    relabelling of identical molecules), and the windows' coverage check
    folded into state.nbr_needed: the most columns any molecule's
    z-neighbourhood (within r_half) needs from its window start, which the
    driver holds against W at block ends."""
    m0_w, m1_w, P_w = cfg["m0"], cfg["m1"], cfg["P"]
    M_w = m1_w - m0_w
    A_blk, r_half = cfg["A_blk"], cfg["r_half"]
    wstart_rel = slab_window_starts(system, cfg) - cfg["a0"]
    sortable = [(b0, b1, p, a0) for _, b0, b1, p, a0
                in system.species_slices if b1 - b0 >= 2]

    def resort(state):
        C = state.com.shape[0]
        box = state.box[:, None]                                 # (C, 1)
        com, quat, coords = state.com.clone(), state.quat.clone(), \
            state.coords.clone()
        dev = com.device
        z_s_w = None
        for b0, b1, p, a0 in sortable:
            z = com[:, b0:b1, 2]
            z = z - box * torch.floor(z / box)                   # [0, box)
            perm = torch.argsort(z, dim=1, stable=True)          # (C, Mb)
            idx_m = b0 + perm
            com[:, b0:b1] = com.gather(1, idx_m[:, :, None].expand(-1, -1,
                                                                  3))
            quat[:, b0:b1] = quat.gather(1, idx_m[:, :, None].expand(-1, -1,
                                                                    4))
            cols = (a0 + perm[:, :, None] * p
                    + torch.arange(p, device=dev)[None, None, :]
                    ).reshape(C, 1, (b1 - b0) * p).expand(-1, 3, -1)
            coords[:, :, a0:a0 + (b1 - b0) * p] = coords.gather(2, cols)
            if b0 == m0_w:
                z_s_w = z.gather(1, perm)                        # sorted

        # coverage: every molecule's z-neighbourhood in the sorted block
        # must fit its static window (circular, in columns)
        z_all = com[:, :, 2]
        z_all = z_all - box * torch.floor(z_all / box)
        lo_v = z_all - r_half
        wl = lo_v < 0.0
        lo = torch.searchsorted(z_s_w, torch.where(wl, lo_v + box, lo_v)) \
            - torch.where(wl, M_w, 0)
        hi_v = z_all + r_half
        wh = hi_v >= box
        hi = torch.searchsorted(z_s_w, torch.where(wh, hi_v - box, hi_v)) \
            + torch.where(wh, M_w, 0)
        rel = torch.as_tensor(wstart_rel, dtype=lo.dtype, device=dev)
        offset = torch.remainder(lo * P_w - rel[None, :], A_blk)
        needed = torch.where(hi > lo, offset + (hi - lo) * P_w, 0)
        needed = needed.max(dim=1).values.to(torch.int32)       # (C,)
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords,
            nbr_needed=torch.maximum(state.nbr_needed, needed))

    return resort


def with_halo(coords, system, cfg):
    """The sweep op's slab planes of coords (C, 3, A_pad): widened to
    A_store, the ghost halo [A, A + W) filled with the sorted block's
    first W columns."""
    A, a0, W = system.n_atoms, cfg["a0"], cfg["W"]
    out = torch.nn.functional.pad(coords[:, :, :A], (0, cfg["A_store"] - A))
    out[:, :, A:A + W] = out[:, :, a0:a0 + W]
    return out


def without_halo(coords, system):
    """(C, 3, A_pad) planes of slab planes: the halo dropped and the lane
    pads [A, A_pad) it overlapped zero again."""
    A = system.n_atoms
    return torch.nn.functional.pad(coords[:, :, :A],
                                   (0, system.n_atoms_padded - A))


def _shared_rows(system, cfg=None):
    """(A_row,) int32 type ids and molecule ids (pads -1) and f32 charges
    (pads 0), numpy; A_row is A_pad, or A_store with sorted slabs (cfg),
    whose ghost halo [A, A + W) copies the sorted block's first W types
    and charges and keeps molecule -1."""
    A = system.n_atoms
    A_row = system.n_atoms_padded if cfg is None else cfg["A_store"]
    tid_row = np.full(A_row, -1, np.int32)
    tid_row[:A] = system.flat(system.type_ids)
    q_row = np.zeros(A_row, np.float32)
    q_row[:A] = system.flat(system.charges)
    molid_row = np.full(A_row, -1, np.int32)
    molid_row[:A] = system.atom_mol_slot[0]
    if cfg is not None:
        a0, W = cfg["a0"], cfg["W"]
        tid_row[A:A + W] = tid_row[a0:a0 + W]
        q_row[A:A + W] = q_row[a0:a0 + W]
    return tid_row, molid_row, q_row


def sweep_tables(system, params, kvecs, kweights, device, cfg=None):
    """One SweepTables per species block (its template is the block's
    first molecule), on `device`; the shared rows and k-vectors are one
    set of tensors.  cfg (slab_config's dict) adds the slab windows: the
    window starts, the other blocks' column segments and A_store-wide
    rows."""
    n_types = system.eps_table.shape[0]
    et = np.asarray(system.eps_table, np.float32)
    st = np.asarray(system.sig_table, np.float32)
    if kvecs is not None:
        kvec, kw = np.asarray(kvecs, np.float32), np.asarray(kweights)
    else:
        kvec, kw = np.zeros((1, 3), np.float32), np.zeros(1)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    tid_row, molid_row, q_row = _shared_rows(system, cfg)
    shared = dict(tid_row=i32(tid_row), molid_row=i32(molid_row),
                  q_row=f32(q_row), kvec=f32(kvec), kw=f32(kw),
                  nk=int(np.rint(np.abs(kvec)).max()))
    if cfg is not None:
        segs = [(a0, (m1 - m0) * p)
                for _, m0, m1, p, a0 in system.species_slices[:-1]]
        shared.update(a0_w=cfg["a0"], A_blk=cfg["A_blk"], W=cfg["W"],
                      wst=i32(slab_window_starts(system, cfg)),
                      segs=i32(np.reshape(segs, (-1, 2))))
    out = []
    for _, m0, m1, P, a0 in system.species_slices:
        tids = np.asarray(system.type_ids)[m0, :P]
        eps_pt, sig2_pt = et[tids], st[tids] ** 2                 # (P, T)
        lam1_pt = np.zeros((P, n_types), np.float32)
        lam2_pt = np.zeros((P, n_types), np.float32)
        if params.lj_shift == "linear":
            l1, l2 = _shift_coeffs(params.r_cut / st[tids])
            # pre-scaled: the in-kernel shift is eps * (l1 + l2 * r / sigma)
            lam1_pt = et[tids] * l1
            lam2_pt = et[tids] * l2 / st[tids]
        qs = np.asarray(system.charges)[m0, :P]
        out.append(sweep_op.SweepTables(
            M=m1 - m0, m_start=m0, a_start=a0, P=P,
            coulomb=kernel_coulomb(params), lj_shift=params.lj_shift,
            use_rot=bool(P > 1 and params.p_translate < 1.0),
            rc2=float(params.r_cut ** 2), qrc2=float(params.qq_cut ** 2),
            kappa_l=float(params.kappa_L),
            d2_overlap=float(params.d2_overlap),
            p_translate=float(params.p_translate),
            body=f32(system.body[m0, :P]), qp=f32(qs), eps=f32(eps_pt),
            sig2=f32(sig2_pt), lam1=f32(lam1_pt), lam2=f32(lam2_pt),
            has_lj=i32([np.any(et[t] != 0.0) for t in tids]),
            has_q=i32(qs != 0.0), **shared))
    return tuple(out)


def draw_uniforms(n_chains, n_moves, generator, device):
    """The sweep's uniforms, (C, M, 10) f32 in [0, 1); under a shard
    context (utils/shard.py) the rows of this process's chains of the
    chain-global draw."""
    return rand_chains((n_chains, n_moves, sweep_op.N_UNIFORMS), generator,
                       torch.float32, device)


def sweep_blocks(op, coords, com, quat, sfac, box, temp, dr_max, dphi_max,
                 u, tables):
    """One sweep over every species block: `op` (sweep_op.sweep or
    sweep_op.sweep_plain) once per block in storage order, each launch
    taking the state the previous one left; the stats (C, 6) summed."""
    stats = None
    for t in tables:
        coords, com, quat, sfac, st = op(coords, com, quat, sfac, box, temp,
                                         dr_max, dphi_max, u, t)
        stats = st if stats is None else stats + st
    return coords, com, quat, sfac, stats


def draw_exchange_uniforms(n_chains, n_attempts, generator, device):
    """The exchange attempts' and ghosts' uniforms, (C, n, 8) f32 in
    [0, 1), chain-global under a shard context as draw_uniforms."""
    return rand_chains((n_chains, n_attempts, sweep_op.N_EXCH_UNIFORMS),
                       generator, torch.float32, device)


def activity_planes(system, active):
    """The sweep op's f32 activity planes of a (C, M) bool slot mask: act
    (C, A_pad), 1 on the atoms of active slots and 0 on inactive slots
    and lane pads, and actm (C, M)."""
    actm = active.to(torch.float32).contiguous()
    act = torch.zeros((active.shape[0], system.n_atoms_padded),
                      dtype=torch.float32, device=active.device)
    act[:, :system.n_atoms] = torch.cat(
        [actm[:, m0:m1].repeat_interleave(p, dim=1)
         for _, m0, m1, p, _ in system.species_slices], dim=1)
    return act, actm


def make_mega_sweep_fn(system, params, kvecs, kweights, device,
                       box_hint=None, z_hint=None, with_activity=False,
                       n_exch=0, tmmc_exch=False, n_widom=0):
    """Returns sweep_full(state, generator) -> state: one sweep-kernel
    launch per species block.  sweep_full.tables holds the SweepTables,
    sweep_full.slab the sorted-slab configuration (slab_config of box_hint
    and z_hint; None: dense scans).

    with_activity=True returns instead the fluctuating-N variant
    `sweep_act(com, quat, coords, active, box, sfac, generator) -> (com,
    quat, coords, sfac, d_e, acc, att)` on the molecular-GCMC state layout
    (mc/gcmc_mol.MolGCMCState fields): inactive slots neither move nor
    add to any pair energy, so one call is a valid fixed-N sweep between
    exchange steps.  The sweep runs at params.temperature / dr_max /
    dphi_max.

    With n_exch or n_widom (an int, or one count per species block) the
    callable is `sweep_x` with three more arguments (see there): when
    every count is 0 it is the 7-argument sweep_act, so a caller passing
    computed counts branches on any(counts).  tmmc_exch (a single species
    block) makes the exchange attempts deposit the collection matrix:
    sweep_x then takes energy= (C,) and eta= (cap + 1,) and returns cmat
    and uhist as well.  The activity variants run dense (no slabs)."""
    check_mega_supported(system, params)
    cfg = slab_config(system, params, box_hint, z_hint)
    if with_activity and cfg is not None:
        raise ValueError("activity-masked sweeps do not support the "
                         "sorted-slab window path")
    slices = system.species_slices
    nb = len(slices)
    n_exchs = (n_exch,) * nb if isinstance(n_exch, int) else tuple(n_exch)
    n_widoms = (n_widom,) * nb if isinstance(n_widom, int) \
        else tuple(n_widom)
    if any(n_exchs) or any(n_widoms):
        if not with_activity:
            raise ValueError("in-kernel exchanges/Widom require "
                             "with_activity")
        if len(n_exchs) != nb or len(n_widoms) != nb:
            raise ValueError("n_exch/n_widom must be an int or one count "
                             "per species block")
        if tmmc_exch and nb != 1:
            raise ValueError("in-kernel TMMC deposits support a single "
                             "species block")
        if nb > 1:
            # the in-kernel exchange constant tracks only the own block's
            # count; a charged species' reference-Wolf global term couples
            # the counts
            qs_tot = [float(np.sum(np.asarray(system.charges)[m0]))
                      for _, m0, _, _, _ in slices]
            if params.coulomb == "wolf" and any(abs(q) > 1e-5
                                                for q in qs_tot):
                raise ValueError("multi-block in-kernel exchanges need "
                                 "charge-neutral species under wolf")
    tables = sweep_tables(system, params, kvecs, kweights, device, cfg)
    M = system.n_mol
    ewald = params.coulomb == "ewald"
    f32 = torch.float32
    resort = None if cfg is None else make_slab_resort_fn(system, params,
                                                          cfg)

    def sweep_full(state, generator):
        if resort is not None:
            state = resort(state)
        C = state.com.shape[0]
        u = draw_uniforms(C, M, generator, state.com.device)
        coords = state.coords.to(f32)
        if cfg is not None:
            coords = with_halo(coords, system, cfg)
        coords, com, quat, sfac, stats = sweep_blocks(
            sweep_op.sweep, *(x.to(f32).contiguous() for x in (
                coords, state.com, state.quat, state.sfac, state.box,
                state.temp, state.dr_max, state.dphi_max)), u, tables)
        if cfg is not None:
            coords = without_halo(coords, system)
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
    sweep_full.slab = cfg
    if not with_activity:
        return sweep_full

    def planes(com, quat, coords, active, box, sfac):
        """The kernel's f32 arguments of a MolGCMCState's fields, with
        the activity planes per atom (C, A_pad) and per slot (C, M)."""
        act, actm = activity_planes(system, active)
        ones = torch.ones((com.shape[0],), dtype=f32, device=com.device)
        return [x.to(f32).contiguous() for x in (coords, com, quat, sfac,
                                                 box)] + [
            params.temperature * ones, params.dr_max * ones,
            params.dphi_max * ones], act, actm

    def sweep_act(com, quat, coords, active, box, sfac, generator):
        """One activity-masked sweep: com (C, M, 3), quat (C, M, 4),
        coords (C, 3, A_pad), active (C, M) bool, box (C,), sfac
        (C, K, 2); one launch per species block.  Returns (com, quat,
        coords, sfac, d_e, acc, att) in f32: d_e (C,) the summed
        accepted energy delta, acc/att (C, 2) accepted/attempted
        [translate, rotate] (attempts count active slots only)."""
        args, act, actm = planes(com, quat, coords, active, box, sfac)
        u = draw_uniforms(com.shape[0], M, generator, com.device)
        stats = None
        for t in tables:
            out = sweep_op.sweep(*args, u, t, act=act, actm=actm)
            args[:4], (st, act, actm, _) = out[:4], out[4:]
            stats = st if stats is None else stats + st
        coords_o, com_o, quat_o, sfac_o = args[:4]
        return (com_o, quat_o, coords_o, sfac_o, stats[:, 0], stats[:, 1:3],
                stats[:, 3:5])

    sweep_act.tables = tables
    if not any(n_exchs) and not any(n_widoms):
        return sweep_act

    launch = [0]

    def sweep_x(com, quat, coords, active, box, sfac, generator, zact, si,
                wc, lrc_cross=None, energy=None, eta=None):
        """One launch per species block = [the block's activity-masked
        moves + n_exchs[b] exchange attempts of that species + n_widoms[b]
        ghost insertions].  zact/si/wc: per-chain (C,) activity, self +
        intra exchange constant and quadratic-in-N coefficient (reference
        Wolf c Q^2 and the LJ tail), plain tensors for one block, one per
        block (tuple/list) otherwise; lrc_cross[b] (C,): the cross-species
        tail coefficient 2 g_bo N_o folded into si from the live counts.
        With tmmc_exch, energy (C,) the carried energies and eta (cap + 1,)
        the bias.
        Returns (com, quat, coords, active, sfac, d_e, acc, att[, cmat,
        uhist][, wid]): active the updated (C, M) bool mask, acc/att
        (C, 2 + 2 n_blocks) f32 [translate, rotate, then per block insert,
        delete]; with tmmc_exch this call's collection matrix [stay, up,
        down] and energy moments [count, sum E, sum E^2], each
        (C, cap + 1, 3) f32; with any n_widom, wid (C, n_blocks, 2) = each
        block's [sum w, sum w^2]."""
        C = com.shape[0]
        z_b, si_b, wc_b = ((x,) if nb == 1 and not isinstance(
            x, (tuple, list)) else tuple(x) for x in (zact, si, wc))
        args, act, actm = planes(com, quat, coords, active, box, sfac)
        u = draw_uniforms(C, M, generator, com.device)
        stats = torch.zeros((C, sweep_op.N_STATS), dtype=f32,
                            device=com.device)
        xacc, xatt, wids = [], [], []
        for b, t in enumerate(tables):
            extra = {}
            if n_exchs[b] or n_widoms[b]:
                si_eff = si_b[b].to(f32)
                if lrc_cross is not None and nb > 1:
                    _, m0, m1, _, _ = slices[b]
                    n_oth = actm.sum(1) - actm[:, m0:m1].sum(1)
                    si_eff = si_eff + 2.0 * lrc_cross[b].to(f32) * n_oth
                # the deletion scores' stream: one seed per launch
                seed = (generator.initial_seed() * 0x9E3779B1
                        + launch[0]) & 0xFFFFFFFF
                launch[0] += 1
                extra = dict(
                    n_exch=n_exchs[b], n_widom=n_widoms[b], seed=seed,
                    chain0=chain_offset(),
                    ux=draw_exchange_uniforms(C, n_exchs[b] + n_widoms[b],
                                              generator, com.device),
                    z=z_b[b].to(f32).contiguous(),
                    si=si_eff.contiguous(),
                    wc=wc_b[b].to(f32).contiguous())
                if tmmc_exch:
                    extra.update(tmmc=True,
                                 eta=torch.as_tensor(eta).to(
                                     device=com.device, dtype=f32)
                                 .contiguous(),
                                 e_in=energy.to(f32).contiguous())
            out = sweep_op.sweep(*args, u, t, act=act, actm=actm, **extra)
            args[:4], (st, act, actm, wid) = out[:4], out[4:8]
            cm_uh = out[8:10]
            # per-species exchange counters: each launch's own columns
            xacc += [st[:, 5], st[:, 6]]
            xatt += [st[:, 7], float(n_exchs[b]) - st[:, 7]]
            wids.append(wid)
            stats = stats + st
        coords_o, com_o, quat_o, sfac_o = args[:4]
        res = (com_o, quat_o, coords_o, actm > 0.5, sfac_o, stats[:, 0],
               torch.stack([stats[:, 1], stats[:, 2]] + xacc, dim=1),
               torch.stack([stats[:, 3], stats[:, 4]] + xatt, dim=1))
        if tmmc_exch:
            res = res + tuple(cm_uh)
        if any(n_widoms):
            res = res + (torch.stack(wids, dim=1),)
        return res

    sweep_x.tables = tables
    return sweep_x


def _gibbs_block_launches(system, params, tables, n_exchs):
    """launch(com, quat, coords, active, box, sfac, generator, si2s, wc2s,
    lrc_cross=None): one Gibbs-op launch per species block of `tables` on
    the two-box layout (com (C, 2, M, 3), quat (C, 2, M, 4), coords (C, 2,
    3, A_pad), active (C, 2, M) bool, box (C, 2), sfac (C, 2, K, 2)), each
    = [2 M_b moves + n_exchs[b] transfer attempts of block b], the state
    and activity planes of one launch feeding the next; si2s / wc2s per
    block the (C, 2) per-box exchange constants, lrc_cross per block the
    (C, 2) cross-species tail coefficient g_bo, folded into si as 2 g_bo
    N_o from the live other-block counts.  Uniforms come from the
    generator, the deletion scores from one seed per launch.  Returns
    (com, quat, coords, active, sfac, d_e (C, 2), acc (C, 2 + n_blocks)
    [trans, rot, transfers of each block], att likewise), in f32; each
    block's transfer counters are its own launch's stats column."""
    M = system.n_mol
    f32 = torch.float32
    launch = [0]

    def run(com, quat, coords, active, box, sfac, generator, si2s, wc2s,
            lrc_cross=None):
        C = com.shape[0]
        dev = com.device
        act, actm = activity_planes(system, active.reshape(2 * C, M))
        act, actm = act.reshape(C, 2, -1), actm.reshape(C, 2, M)
        ones = torch.ones((C,), dtype=f32, device=dev)
        args = [x.to(f32).contiguous() for x in (coords, com, quat, sfac,
                                                 box)]
        d_e = torch.zeros((C, 2), dtype=f32, device=dev)
        acc, att, xacc = 0.0, 0.0, []
        for b, t in enumerate(tables):
            si_eff = si2s[b].to(f32)
            if lrc_cross is not None:
                n_oth = actm.sum(2) - actm[:, :, t.m_start:t.m_start
                                           + t.M].sum(2)
                si_eff = si_eff + 2.0 * lrc_cross[b].to(f32) * n_oth
            # the deletion scores' stream: one seed per launch
            seed = (generator.initial_seed() * 0x9E3779B1 + launch[0]) \
                & 0xFFFFFFFF
            launch[0] += 1
            u = draw_uniforms(C, 2 * t.M, generator, dev)
            ux = draw_exchange_uniforms(C, n_exchs[b], generator, dev)
            out = gibbs_op.sweep_gibbs(
                *args, params.temperature * ones, params.dr_max * ones,
                params.dphi_max * ones, u, t, act, actm, n_exch=n_exchs[b],
                ux=ux, si2=si_eff.contiguous(),
                wc2=wc2s[b].to(f32).contiguous(), seed=seed,
                chain0=chain_offset())
            args[:4], (st, act, actm) = list(out[:4]), out[4:]
            d_e = d_e + st[:, 0:2]
            acc = acc + st[:, 2:4]
            att = att + st[:, 4:6]
            xacc.append(st[:, 6])
        coords_o, com_o, quat_o, sfac_o = args[:4]
        return (com_o, quat_o, coords_o, actm > 0.5, sfac_o, d_e,
                torch.cat([acc, torch.stack(xacc, 1)], 1),
                torch.cat([att, torch.tensor([n_exchs], dtype=f32,
                                             device=dev).expand(C, -1)], 1))

    run.tables = tables
    return run


def make_mega_gibbs_fn(system, params, kvecs, kweights, device, n_exch=1):
    """The in-kernel Gibbs cycle: returns `sweep_gibbs(com, quat, coords,
    active, box, sfac, generator, si2, wc2)` running [2 cap moves + n_exch
    transfer attempts] in one Gibbs-op launch on the MolGibbsState layout
    (mc/gibbs_mol.py): com (C, 2, cap, 3), quat (C, 2, cap, 4), coords
    (C, 2, 3, A_pad), active (C, 2, cap) bool, box (C, 2), sfac (C, 2, K,
    2); si2/wc2 (C, 2) per box the self + intra constant and the
    quadratic-in-N coefficient (reference Wolf c Q^2 plus the LJ tail).
    The moves run at params.temperature / dr_max / dphi_max; uniforms come
    from the generator, the deletion scores from a per-launch seed.
    Volume exchanges are not part of it.  Requires a uniform single-
    species system, site cutoff and lj_shift none or linear; computes in
    f32.

    Returns (com, quat, coords, active, sfac, d_e (C, 2) per-box accepted
    energy deltas, acc (C, 3) [trans, rot, transfer], att (C, 3))."""
    if not system.is_uniform or params.cutoff_mode != "site" \
            or params.lj_shift not in ("none", "linear"):
        raise ValueError("mega Gibbs requires a uniform single-species "
                         "system and site cutoff")
    launch = _gibbs_block_launches(
        system, params, sweep_tables(system, params, kvecs, kweights,
                                     device), (n_exch,))

    def sweep_gibbs(com, quat, coords, active, box, sfac, generator, si2,
                    wc2):
        return launch(com, quat, coords, active, box, sfac, generator,
                      (si2,), (wc2,))

    return sweep_gibbs


def make_mega_gibbs_binary_fn(system, params, kvecs, kweights, device,
                              n_exch=(1, 1)):
    """The in-kernel binary Gibbs cycle: returns `sweep_gibbs_b(com, quat,
    coords, active0, active1, box, sfac, generator, si2s, wc2s,
    lrc_cross=None)` on the BinaryGibbsState layout (mc/gibbs_binary.py):
    com (C, 2, M, 3) with M = cap0 + cap1 slots per box, quat (C, 2, M,
    4), coords (C, 2, 3, A_pad), active0 (C, 2, cap0), active1 (C, 2,
    cap1) bool, box (C, 2), sfac (C, 2, K, 2); si2s / wc2s per species a
    (C, 2) per-box self + intra constant and quadratic-in-N coefficient;
    lrc_cross per species the (C, 2) cross-species tail coefficient g_so,
    folded into si as 2 g_so N_o from the live other-species counts.

    One Gibbs-op launch per species block (its SweepTables address the
    block through m_start / a_start / M) = [2 cap_s moves + n_exch[s]
    transfer attempts of species s]; the state and the activity planes
    of one launch feed the next.  Requires two internally uniform species
    blocks, site cutoff and lj_shift none; computes in f32.

    Returns (com, quat, coords, active0, active1, sfac, d_e (C, 2), acc
    (C, 4) [trans, rot, transfer0, transfer1], att (C, 4)); each
    species' transfer counters are its own launch's stats column."""
    slices = system.species_slices
    if len(slices) != 2 or not system.species_uniform:
        raise ValueError("mega binary Gibbs requires exactly two internally "
                         "uniform species blocks")
    if params.cutoff_mode != "site" or params.lj_shift != "none":
        raise ValueError("mega binary Gibbs requires site cutoff and "
                         "lj_shift='none'")
    tables = sweep_tables(system, params, kvecs, kweights, device)
    launch = _gibbs_block_launches(system, params, tables,
                                   tuple(int(x) for x in n_exch))
    cap0 = tables[0].M

    def sweep_gibbs_b(com, quat, coords, active0, active1, box, sfac,
                      generator, si2s, wc2s, lrc_cross=None):
        out = launch(com, quat, coords, torch.cat([active0, active1], dim=2),
                     box, sfac, generator, si2s, wc2s, lrc_cross)
        on = out[3]
        return out[:3] + (on[:, :, :cap0], on[:, :, cap0:]) + out[4:]

    sweep_gibbs_b.tables = tables
    return sweep_gibbs_b


def make_mega_flip_fn(system, params, kvecs, kweights, device,
                      fugacity_ratio, n_flip=1):
    """In-kernel semigrand identity flips: returns `flips(com, quat, coords,
    active, box, sfac, generator, si2, lrc3=None)` running n_flip flip
    attempts in one flip-op launch (ops/cuda/flip_kernel.py) on the
    SemigrandState layout (mc/semigrand.py): com (C, M, 3), quat (C, M, 4),
    coords (C, 3, A_pad), active (C, M) bool, box (C,), sfac (C, K, 2);
    si2 (C, 2) each species' self + intra constant; lrc3 (C, 3) the LJ
    tail's [g c00, g c01, g c11] or None.  The displacement and rotation
    budget composes through the per-block sweep_act launches
    (make_mega_sweep_fn).  Uniforms come from the generator, the pick scores
    from a per-launch seed.  Requires exactly two internally uniform species
    blocks, site cutoff and lj_shift='none'; computes in f32.

    Returns (com, quat, coords, active, sfac, d_e (C,), acc (C, 2) [flip
    A->B, flip B->A], att (C, 2))."""
    slices = system.species_slices
    if len(slices) != 2 or not system.species_uniform:
        raise ValueError("mega flips require exactly two internally "
                         "uniform species blocks")
    if params.cutoff_mode != "site" or params.lj_shift != "none":
        raise ValueError("mega flips require site cutoff and "
                         "lj_shift='none'")
    t_a, t_b = sweep_tables(system, params, kvecs, kweights, device)
    tables = flip_op.FlipTables(a=t_a, b=t_b,
                                ln_xi=float(np.log(fugacity_ratio)))
    f32 = torch.float32
    launch = [0]

    def flips(com, quat, coords, active, box, sfac, generator, si2,
              lrc3=None):
        C = com.shape[0]
        dev = com.device
        act, actm = activity_planes(system, active)
        # the pick scores' stream: one seed per launch
        seed = (generator.initial_seed() * 0x9E3779B1 + launch[0]) \
            & 0xFFFFFFFF
        launch[0] += 1
        ux = draw_exchange_uniforms(C, n_flip, generator, dev)
        out = flip_op.flip(
            *(x.to(f32).contiguous() for x in (coords, com, quat, sfac,
                                               box)),
            params.temperature * torch.ones((C,), dtype=f32, device=dev),
            act, actm, ux, tables, si2.to(f32).contiguous(),
            None if lrc3 is None else lrc3.to(f32).contiguous(), seed=seed,
            chain0=chain_offset())
        coords_o, com_o, quat_o, sfac_o, stats, _, actm_o = out
        return (com_o, quat_o, coords_o, actm_o > 0.5, sfac_o, stats[:, 0],
                stats[:, 1:3], stats[:, 3:5])

    flips.tables = tables
    return flips


# ---------------- per-move route ----------------------------------------


def nlist_radius(system, params):
    """The COM-based list radius: the larger cutoff, plus the skin, plus
    twice the largest atom-to-COM distance (atoms of two molecules can be
    closer than their COMs by up to 2 r_body)."""
    r_body = float(np.max(np.linalg.norm(np.asarray(system.body), axis=-1)))
    return max(params.r_cut, params.qq_cut) + params.nlist_skin \
        + 2.0 * r_body


def rebuild_nlist(com, box, params, r_list, chunk=8):
    """Molecule-level Verlet lists: for every molecule the indices of its
    params.nlist_width nearest other molecules, kept where within r_list
    (nlist_radius); the out-of-range and padding slots hold the
    molecule's own index, which every pair mask excludes.

    com (C, M, 3), box (C,) -> (lists (C, M, NB) int32, needed (C,)
    int32: the most molecules any molecule has within r_list), from the
    (M, M) minimum-image distances of `chunk` chains at a time (torch.topk
    of the negated squared distances; nlist_width <= M).  Exact while no
    molecule pair closes in by more than nlist_skin between rebuilds."""
    C, M, _ = com.shape
    nb = params.nlist_width
    r2 = r_list * r_list
    self_idx = torch.arange(M, dtype=torch.int32, device=com.device)
    eye = torch.eye(M, dtype=com.dtype, device=com.device) * 1e12
    lists = torch.empty((C, M, nb), dtype=torch.int32, device=com.device)
    needed = torch.empty(C, dtype=torch.int32, device=com.device)
    for c0 in range(0, C, chunk):
        c1 = min(c0 + chunk, C)
        dr = min_image(com[c0:c1, :, None, :] - com[c0:c1, None, :, :],
                       box[c0:c1, None, None, None])
        d2 = torch.sum(dr * dr, dim=-1) + eye       # self excluded
        needed[c0:c1] = torch.sum(d2 < r2, dim=-1).max(dim=-1).values.to(
            torch.int32)
        neg, idx = torch.topk(-d2, nb, dim=-1)
        lists[c0:c1] = torch.where(-neg < r2, idx.to(torch.int32),
                                   self_idx[:, None])
    return lists, needed


def _coulomb_pair(qq, r, kappa, params):
    """Per-pair Coulomb energies of the plain branch (the reference Wolf
    convention's global constant cancels in per-move deltas)."""
    if params.coulomb == "ewald":
        return qq * torch.special.erfc(kappa * r) / r
    if params.coulomb == "wolf":
        if params.wolf_style == "pairwise":
            shift = torch.special.erfc(kappa * params.qq_cut) / params.qq_cut
            return qq * (torch.special.erfc(kappa * r) / r - shift)
        return qq * torch.special.erfc(kappa * r) / r
    if params.coulomb == "bare":
        return qq / r
    raise ValueError(params.coulomb)


def delta_kernel_supported(params, dtype):
    """Whether the delta-energy kernel branch runs these conventions."""
    return (params.cutoff_mode == "site" and params.lj_shift == "none"
            and dtype == torch.float32 and not params.ewald_surface)


class _MoveBody:
    """One molecule move of every chain, for one species block (see
    make_sweep_fn).  Tensors are (C, ...) batched over chains."""

    def __init__(self, system, params, kvecs, kweights, device, dtype,
                 use_kernel, species):
        M, A, A_pad = system.n_mol, system.n_atoms, system.n_atoms_padded
        if species is None:
            if not system.uniform_width:
                raise ValueError("ragged systems need per-species bodies")
            species = ("all", 0, M, system.atoms_per_mol, 0)
        _, m0, m1, P, a0 = species
        if use_kernel and not delta_kernel_supported(params, dtype):
            raise ValueError("the delta-energy kernel requires site cutoff, "
                             "unshifted LJ, float32 and no Ewald surface "
                             "term")
        self.use_nlist = params.nlist_width > 0
        if self.use_nlist and use_kernel:
            raise ValueError("neighbour lists run on the plain branch only")
        if self.use_nlist and params.cutoff_mode != "site":
            raise NotImplementedError("neighbor lists require site cutoff")
        self.params, self.dtype, self.use_kernel = params, dtype, use_kernel
        self.M, self.m0, self.m1, self.P = M, m0, m1, P
        self.off0 = a0 - m0 * P       # first atom of molecule m: off0 + m P

        def t(x, dt=dtype):   # System arrays are read-only numpy: copy
            return torch.tensor(np.array(x), dtype=dt, device=device)

        self.body = t(np.asarray(system.body)[:, :P])              # (M, P, 3)
        self.charges_mp = t(np.asarray(system.charges)[:, :P])     # (M, P)
        tid_row, molid_row, q_row = _shared_rows(system)
        q_flat = np.zeros(A_pad)
        q_flat[:A] = system.flat(system.charges)
        self.charges_flat = t(q_flat)                              # (A_pad,)
        self.mol_of_atom = t(molid_row, torch.long)
        self.first_atom = t(system.mol_a0, torch.long)             # (M,)
        self.tid_safe = t(np.maximum(tid_row, 0), torch.long)
        self.eps_t = t(system.eps_table)
        self.sig2_t = t(system.sig_table) ** 2
        self.tid_mp = t(np.asarray(system.type_ids)[:, :P], torch.long)
        # the neighbour gather: molecule j owns mol_p[j] atom columns from
        # mol_a0[j]; the gather is P_max wide, the slots past mol_p[j]
        # masked
        self.nl_p = system.atoms_per_mol
        self.mol_p = t(system.mol_p, torch.long)
        self.kv = None if kvecs is None else t(kvecs, torch.int32)
        self.kw = None if kweights is None else t(kweights)
        self.use_rot = P > 1 and params.p_translate < 1.0
        if use_kernel:
            self._kernel_tables(system, device, tid_row, molid_row, q_row)

    def _kernel_tables(self, system, device, tid_row, molid_row, q_row):
        """Per-molecule (R, T) LJ rows, (R,) charges and row flags of this
        block's molecules (rows [P old; P new; pad], R = round_up(2P, 8)),
        and the shared rows, for the delta-energy op."""
        P, m0, m1 = self.P, self.m0, self.m1
        R = _round_up(2 * P, delta_op.ROW_GROUP)
        et = np.asarray(system.eps_table, np.float32)
        st2 = np.asarray(system.sig_table, np.float32) ** 2
        tids = np.asarray(system.type_ids)[m0:m1, :P]
        qs = np.asarray(system.charges, np.float32)[m0:m1, :P]
        eps = np.zeros((m1 - m0, R, et.shape[0]), np.float32)
        sig2 = np.zeros_like(eps)
        q8 = np.zeros((m1 - m0, R), np.float32)
        has_lj = np.zeros((m1 - m0, R), np.int32)
        has_q = np.zeros((m1 - m0, R), np.int32)
        for half in (slice(0, P), slice(P, 2 * P)):
            eps[:, half] = et[tids]
            sig2[:, half] = st2[tids]
            q8[:, half] = qs
            has_lj[:, half] = np.any(et[tids] != 0.0, axis=-1)
            has_q[:, half] = qs != 0.0

        def dev(x):
            return torch.tensor(x, device=device)

        self.n_rows = R
        self.eps_rows, self.sig2_rows, self.q8_rows = dev(eps), dev(sig2), \
            dev(q8)
        self.has_lj_rows, self.has_q_rows = dev(has_lj), dev(has_q)
        self.tid_row, self.molid_row, self.q_row = dev(tid_row), \
            dev(molid_row), dev(q_row)
        p = self.params
        self.delta_params = delta_op.DeltaParams(
            coulomb=kernel_coulomb(p), rc2=float(p.r_cut ** 2),
            qrc2=float(p.qq_cut ** 2), kappa_l=float(p.kappa_L),
            d2_overlap=float(p.d2_overlap), wolf_rc=float(p.qq_cut))

    def propose(self, com, quat, coords, box, u, dr_max, dphi_max, m):
        """The move of molecule m on uniforms u (C, 10), read as the sweep
        kernel reads them: u0 < p_translate translates by (u1..3 - 0.5)
        dr_max, else rotates (sweep_kernel.propose_rotation); u4 is the
        acceptance draw.  Returns the proposal dict (the JAX
        propose_full's keys, with u_acc in place of its key)."""
        P = self.P
        com_m, quat_m = com[:, m].clone(), quat[:, m].clone()
        a = self.off0 + m * P
        ra_old = coords[:, :, a:a + P].transpose(1, 2).clone()     # (C, P, 3)
        if self.use_rot:
            tsel = (u[:, 0:1] < self.params.p_translate).to(com.dtype)
            rot_q = sweep_op.propose_rotation(*quat_m.split(1, -1), u,
                                              dphi_max)
            quat_new = torch.where(tsel > 0.0, quat_m, torch.cat(rot_q, 1))
        else:
            tsel = torch.ones_like(u[:, 0:1])
            quat_new = quat_m
        box_c = box[:, None]
        com_new = com_m + tsel * (u[:, 1:4] - 0.5) * dr_max[:, None]
        com_new = com_new - box_c * torch.floor(com_new * (1.0 / box_c))
        if P > 1:
            b = self.body[m]
            rot = sweep_op.rot_apply(*quat_new.split(1, -1), b[:, 0], b[:, 1],
                                     b[:, 2])
            ra_new = com_new[:, None, :] + torch.stack(rot, dim=-1)
        else:
            ra_new = com_new[:, None, :]
        return dict(com_m=com_m, quat_m=quat_m, ra_old=ra_old,
                    is_trans=tsel[:, 0] > 0.0, com_new=com_new,
                    quat_new=quat_new, ra_new=ra_new, u_acc=u[:, 4])

    def pair_energy_rows(self, ra2p, key_old, key_new, com, coords, m, box,
                         kappa):
        """Plain branch: stacked old/new pair energies.  ra2p (C, 2P, 3),
        key_old/key_new (C, 3) cutoff keys (COM or first atom), com
        (C, M, 3), coords (C, 3, A_pad), box/kappa (C,).  Returns
        (d_e (C,), overlap (C,) bool)."""
        p, P = self.params, self.P
        dtype = coords.dtype
        b4 = box[:, None, None, None]
        dr = min_image(ra2p.transpose(1, 2)[:, :, :, None]
                       - coords[:, :, None, :], b4)            # (C, 3, 2P, A)
        d2 = torch.clamp_min(torch.sum(dr * dr, dim=1), 1e-4)  # (C, 2P, A)
        other = (self.mol_of_atom != m) & (self.mol_of_atom >= 0)
        rc2, qrc2 = p.r_cut ** 2, p.qq_cut ** 2
        if p.cutoff_mode == "site":
            mask_lj = other & (d2 < rc2)
            mask_qq = mask_lj if p.qq_r_cut is None else other & (d2 < qrc2)
        else:
            keys = com if p.cutoff_mode == "com" \
                else coords[:, :, self.first_atom].transpose(1, 2)
            kpts = torch.stack([key_old, key_new], dim=1)          # (C, 2, 3)
            d2m = torch.sum(min_image(kpts[:, :, None, :] - keys[:, None],
                                      b4) ** 2, dim=-1)            # (C, 2, M)
            halves = torch.arange(2, device=d2.device).repeat_interleave(P)
            mol = self.mol_of_atom.clamp(min=0)
            mask_lj = other & (d2m < rc2)[:, :, mol][:, halves]
            mask_qq = mask_lj if p.qq_r_cut is None \
                else other & (d2m < qrc2)[:, :, mol][:, halves]
        d2s = torch.where(mask_lj | mask_qq, d2, torch.ones((), dtype=dtype,
                                                            device=d2.device))
        tm = self.tid_mp[m]                                        # (P,)
        eps2 = self.eps_t[tm][:, self.tid_safe].repeat(2, 1)       # (2P, A)
        sig2 = self.sig2_t[tm][:, self.tid_safe].repeat(2, 1)
        s2 = sig2 / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps2 * (s6 * s6 - s6)
        if p.lj_shift == "linear":
            sig = torch.sqrt(sig2)
            lam1, lam2 = _shift_coeffs(p.r_cut / sig)
            pot = pot + eps2 * (lam1 + lam2 * torch.sqrt(d2s) / sig)
        e_lj = torch.sum(torch.where(mask_lj, pot, 0.0), dim=-1)   # (C, 2P)
        d_e = e_lj[:, P:].sum(-1) - e_lj[:, :P].sum(-1)
        overlap = torch.zeros_like(d_e, dtype=torch.bool)
        if p.coulomb != "none":
            qq2 = (self.charges_mp[m][:, None]
                   * self.charges_flat[None, :]).repeat(2, 1)      # (2P, A)
            cpair = _coulomb_pair(qq2, torch.sqrt(d2s), kappa[:, None, None],
                                  p)
            e_coul = COULOMB_FACTOR * torch.sum(
                torch.where(mask_qq, cpair, 0.0), dim=-1)
            d_e = d_e + e_coul[:, P:].sum(-1) - e_coul[:, :P].sum(-1)
            bad = (d2 < p.d2_overlap) & (qq2 < 0.0) & mask_qq
            overlap = bad[:, P:].flatten(1).any(-1)
        return d_e, overlap

    def pair_energy_nlist(self, ra2p, nbr_row, coords, m, box, kappa):
        """Plain branch with neighbour lists: the stacked old/new pair
        energies against the listed molecules' atoms only.  ra2p
        (C, 2P, 3), nbr_row (C, NB) neighbour molecule indices (padded
        with m itself), coords (C, 3, A_pad), box/kappa (C,).  Returns
        (d_e (C,), overlap (C,) bool), as pair_energy_rows."""
        p, P = self.params, self.P
        C = ra2p.shape[0]
        slots = torch.arange(self.nl_p, device=nbr_row.device)
        nbr = nbr_row.long()
        valid = (slots < self.mol_p[nbr][..., None]).reshape(C, -1)
        atom = torch.where(
            valid, (self.first_atom[nbr][..., None] + slots).reshape(C, -1),
            0)                                                 # (C, G)
        g = torch.gather(coords, 2, atom[:, None, :].expand(C, 3, -1))
        mol_g = nbr.repeat_interleave(self.nl_p, dim=1)         # (C, G)
        dr = min_image(ra2p.transpose(1, 2)[:, :, :, None]
                       - g[:, :, None, :], box[:, None, None, None])
        d2 = torch.clamp_min(torch.sum(dr * dr, dim=1), 1e-4)  # (C, 2P, G)
        other = ((mol_g != m) & valid)[:, None, :]
        mask_lj = other & (d2 < p.r_cut ** 2)
        mask_qq = mask_lj if p.qq_r_cut is None \
            else other & (d2 < p.qq_cut ** 2)
        d2s = torch.where(mask_lj | mask_qq, d2, torch.ones(
            (), dtype=d2.dtype, device=d2.device))
        tid_g = self.tid_safe[atom]                             # (C, G)
        tm = self.tid_mp[m]
        eps2 = self.eps_t[tm][:, tid_g].transpose(0, 1).repeat(1, 2, 1)
        sig2 = self.sig2_t[tm][:, tid_g].transpose(0, 1).repeat(1, 2, 1)
        s2 = sig2 / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps2 * (s6 * s6 - s6)
        if p.lj_shift == "linear":
            sig = torch.sqrt(sig2)
            lam1, lam2 = _shift_coeffs(p.r_cut / sig)
            pot = pot + eps2 * (lam1 + lam2 * torch.sqrt(d2s) / sig)
        e_lj = torch.sum(torch.where(mask_lj, pot, 0.0), dim=-1)   # (C, 2P)
        d_e = e_lj[:, P:].sum(-1) - e_lj[:, :P].sum(-1)
        overlap = torch.zeros_like(d_e, dtype=torch.bool)
        if p.coulomb != "none":
            qq2 = (self.charges_mp[m][None, :, None]
                   * self.charges_flat[atom][:, None, :]).repeat(1, 2, 1)
            cpair = _coulomb_pair(qq2, torch.sqrt(d2s), kappa[:, None, None],
                                  p)
            e_coul = COULOMB_FACTOR * torch.sum(
                torch.where(mask_qq, cpair, 0.0), dim=-1)
            d_e = d_e + e_coul[:, P:].sum(-1) - e_coul[:, :P].sum(-1)
            bad = (d2 < p.d2_overlap) & (qq2 < 0.0) & mask_qq
            overlap = bad[:, P:].flatten(1).any(-1)
        return d_e, overlap

    def delta_args(self, pr, coords, box, m):
        """The delta-energy op's arguments for the move of molecule m:
        rows [P old; P new; pad] of the proposal as (C, R) planes, the
        molecule's tables and the shared rows."""
        P, R = self.P, self.n_rows
        ra = torch.cat([pr["ra_old"], pr["ra_new"]], dim=1)        # (C, 2P, 3)
        if R > 2 * P:
            # pad rows have zero flags and tables; any position does
            ra = torch.cat([ra, ra[:, :1].expand(-1, R - 2 * P, -1)], dim=1)
        mx, my, mz = (ra[..., d].contiguous() for d in range(3))
        i = m - self.m0
        return (coords[:, 0], coords[:, 1], coords[:, 2], mx, my, mz, box, m,
                self.eps_rows[i], self.sig2_rows[i], self.q8_rows[i],
                self.has_lj_rows[i], self.has_q_rows[i], self.tid_row,
                self.molid_row, self.q_row, self.delta_params)

    def kernel_delta(self, pr, coords, box, m):
        """Kernel branch: the proposal's rows through the delta-energy op.
        Returns (d_e (C,), overlap (C,) bool)."""
        P = self.P
        e_lj, e_coul, ovr = delta_op.delta_energy(
            *self.delta_args(pr, coords, box, m))
        new, old = slice(P, 2 * P), slice(0, P)
        d_e = e_lj[:, new].sum(-1) - e_lj[:, old].sum(-1)
        if self.params.coulomb != "none":
            d_e = d_e + COULOMB_FACTOR * (e_coul[:, new].sum(-1)
                                          - e_coul[:, old].sum(-1))
        return d_e, ovr[:, new].sum(-1) > 0.0

    def finalize(self, com, quat, coords, box, sfac, energy, temp, pr, d_e,
                 ovr, m):
        """Ewald reciprocal (and surface) delta, the Metropolis test and
        the state update.  pr is a proposal dict from `propose` or made
        elsewhere with its keys.  Writes the accepted move into com, quat
        and coords IN PLACE (the caller owns copies); returns (com, quat,
        coords, sfac, energy, is_trans, accept)."""
        p = self.params
        if p.coulomb == "ewald":
            q_m = self.charges_mp[m]
            dsfac = ewald_ops.delta_structure_factor(
                pr["ra_old"], pr["ra_new"], q_m, self.kv, box)     # (C, K, 2)
            cf = ewald_ops.cfac_coeffs(self.kv, self.kw, p.kappa_L / box, box)
            d_e = d_e + ewald_ops.recip_energy_delta(sfac, dsfac, cf)
            if p.ewald_surface:
                # dipole delta: E = c |M|^2, c = factor 2 pi / (3 V); M from
                # the state, the moved molecule's dipole swapped old -> new
                com_all = com[:, self.mol_of_atom.clamp(0, self.M - 1)]
                m_tot = ewald_ops.surface_dipole(
                    coords.transpose(1, 2), com_all, self.charges_flat, box)
                mu_old = ewald_ops.surface_dipole(
                    pr["ra_old"], pr["com_m"][:, None, :], q_m, box)
                mu_new = ewald_ops.surface_dipole(
                    pr["ra_new"], pr["com_new"][:, None, :], q_m, box)
                m_new = m_tot - mu_old + mu_new
                c_surf = COULOMB_FACTOR * 2.0 * math.pi / (3.0 * box ** 3)
                d_e = d_e + c_surf * (torch.sum(m_new * m_new, -1)
                                      - torch.sum(m_tot * m_tot, -1))
        else:
            dsfac = None
        beta_de = d_e / temp
        accept = ((beta_de < 0.0) | (pr["u_acc"] < torch.exp(-beta_de))) \
            & ~ovr
        acc = accept[:, None]
        com[:, m] = torch.where(acc, pr["com_new"], pr["com_m"])
        quat[:, m] = torch.where(acc, pr["quat_new"], pr["quat_m"])
        a = self.off0 + m * self.P
        coords[:, :, a:a + self.P] = torch.where(
            acc[:, :, None], pr["ra_new"], pr["ra_old"]).transpose(1, 2)
        if dsfac is not None:
            sfac = torch.where(acc[:, :, None], sfac + dsfac, sfac)
        energy = torch.where(accept, energy + d_e, energy)
        return com, quat, coords, sfac, energy, pr["is_trans"], accept

    def __call__(self, state, m, u):
        """Move molecule m (global index, in this block) of every chain on
        uniforms u (C, 10).  Updates state.com/quat/coords in place; returns
        (state, accept (C,) bool)."""
        pr = self.propose(state.com, state.quat, state.coords, state.box, u,
                          state.dr_max, state.dphi_max, m)
        if self.use_kernel:
            d_e, ovr = self.kernel_delta(pr, state.coords, state.box, m)
        elif self.use_nlist:
            d_e, ovr = self.pair_energy_nlist(
                torch.cat([pr["ra_old"], pr["ra_new"]], dim=1),
                state.nbr[:, m], state.coords, m, state.box,
                self.params.kappa_L / state.box)
        else:
            first = self.params.cutoff_mode == "first"
            key_old = pr["ra_old"][:, 0] if first else pr["com_m"]
            key_new = pr["ra_new"][:, 0] if first else pr["com_new"]
            d_e, ovr = self.pair_energy_rows(
                torch.cat([pr["ra_old"], pr["ra_new"]], dim=1), key_old,
                key_new, state.com, state.coords, m, state.box,
                self.params.kappa_L / state.box)
        com, quat, coords, sfac, energy, is_trans, accept = self.finalize(
            state.com, state.quat, state.coords, state.box, state.sfac,
            state.energy, state.temp, pr, d_e.to(self.dtype), ovr, m)
        it, ac = is_trans.to(torch.int32), accept.to(torch.int32)
        zero = torch.zeros_like(it)
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords, sfac=sfac,
            energy=energy, step=state.step + 1,
            att=state.att + torch.stack([it, 1 - it, zero], 1),
            acc=state.acc + torch.stack([it * ac, (1 - it) * ac, zero], 1)
        ), accept


def make_sweep_fn(system, params, kvecs, kweights, device,
                  dtype=torch.float32, use_kernel=False, species=None):
    """The per-move route of one species block (a System.species_slices
    entry; None: the whole uniform-width system as one block), called as
    body(state, m, u_m) -> (state, accept) for m in [m0, m1); its methods
    propose, delta_args, kernel_delta, pair_energy_rows, pair_energy_nlist
    and finalize are the steps of a move.
    use_kernel takes the delta-energy op for the pair sums (raising where
    delta_kernel_supported is false), else the plain pair_energy_rows, or
    with params.nlist_width > 0 pair_energy_nlist on state.nbr."""
    return _MoveBody(system, params, kvecs, kweights, device, dtype,
                     use_kernel, species)


# ---------------- the per-move route's sweep ----------------------------

# The SimState fields the move bodies read or write: a sweep's graph holds
# a static buffer of each (MoveSweepGraph); with neighbour lists they also
# read the sweep's lists, NLIST_FIELDS.
MOVE_FIELDS = ("com", "quat", "coords", "sfac", "energy", "box", "temp",
               "dr_max", "dphi_max", "step", "att", "acc")
NLIST_FIELDS = ("nbr",)


def run_moves(bodies, state, u):
    """One sweep's moves: body(state, m, u[:, m]) for every (m0, m1, body)
    of `bodies` in order and m in [m0, m1), on uniforms u (C, M, 10).  The
    bodies update state.com/quat/coords IN PLACE; returns the last
    state."""
    for m0, m1, body in bodies:
        for m in range(m0, m1):
            state, _ = body(state, m, u[:, m])
    return state


def move_graph_key(state):
    """The shapes and dtypes of the fields a sweep's graph holds."""
    return tuple((f, tuple(getattr(state, f).shape), getattr(state, f).dtype)
                 for f in MOVE_FIELDS)


class MoveSweepGraph:
    """run_moves over `bodies` on static buffers, for states shaped like
    `state`: one buffer per MOVE_FIELDS field (and NLIST_FIELDS field,
    with nlist) and one for the uniforms.
    A call copies the state and u (C, M, 10) into them, runs the moves and
    returns the state with those fields cloned out of them.

    With graph=True (CUDA tensors) the moves are captured once, here, as
    one CUDA graph that each call replays.  The capture needs warm-up work
    first: one move per body on scratch copies of the buffers (real
    launches, counted as such; nothing is drawn from any generator).  A
    failed capture or replay raises.  The capture itself launches nothing,
    so it leaves delta_energy.launches as it found it; a replay adds the
    launches the capture recorded (self.launches), so the count after n
    replays is the captured count times n.  With graph=False every call
    runs the bodies on the buffers (run_moves)."""

    def __init__(self, bodies, state, u, graph, nlist=False):
        self.bodies = bodies
        self.fields = MOVE_FIELDS + (NLIST_FIELDS if nlist else ())
        self.static = {f: getattr(state, f).clone() for f in self.fields}
        self.u = u.clone()
        # the moves read the buffers, and the state's other fields as they
        # are now (the moves neither read nor write those)
        self._state_in = dataclasses.replace(state, **self.static)
        self.graph, self._out, self.launches = None, None, 0
        if graph:
            self._capture()

    def _capture(self):
        dev = self.u.device
        scratch = dataclasses.replace(
            self._state_in, **{f: t.clone() for f, t in self.static.items()})
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for m0, _, body in self.bodies:
                scratch, _ = body(scratch, m0, self.u[:, m0])
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del scratch
        n0 = delta_op.delta_energy.launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._out = run_moves(self.bodies, self._state_in, self.u)
        self.launches = delta_op.delta_energy.launches - n0
        delta_op.delta_energy.launches = n0

    def __call__(self, state, u):
        for f, t in self.static.items():
            t.copy_(getattr(state, f))
        self.u.copy_(u)
        if self.graph is None:
            out = run_moves(self.bodies, self._state_in, self.u)
        else:
            self.graph.replay()
            delta_op.delta_energy.launches += self.launches
            out = self._out
        return dataclasses.replace(
            state, **{f: getattr(out, f).clone() for f in self.fields})
