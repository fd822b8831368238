"""Gibbs-ensemble MC for rigid molecular species: two-box coexistence with
orientational transfers and full electrostatics (counterpart of
metropolismontecarlo_tpu/mc/gibbs_mol.py; Panagiotopoulos 1987, Frenkel
& Smit ch. 8).

Every chain carries two boxes that exchange molecules and volume at fixed
total N and V, so that they settle into coexisting phases.  Built on the
slot machinery of the molecular muVT app (`mc/gcmc_mol.make_mol_slots`:
pose energies with activity masks, carried per-box S(k), the
box-dependent per-molecule self + intra constants).  Moves:

    displace / rotate (the non-transfer share, split by p_translate):
        Metropolis in a random box;
    volume (every round(1/p_volume) steps, a deterministic cycle as in
        mc/npt.py): a volume dV moves from one box to the other, COMs
        rescaled with orientations fixed, both boxes recomputed (energies
        and S(k); kappa = kappa_L / box changes with each box),
        min[1, (V1'/V1)^N1 (V2'/V2)^N2 exp(-beta dU)];
    transfer: a uniform active molecule of box s leaves, a molecule
        enters box d at a uniform position and orientation,
        min[1, N_s V_d / ((N_d + 1) V_s) exp(-beta dU)], dU with both
        boxes' pair and reciprocal deltas and const(box_d) - const(box_s)
        (the constants do not cancel between boxes of different sizes).

Three routes, chosen by `mega`:
  None    one attempt of every chain per step in plain tensor code
          (every convention, float64, Rosenbluth-biased transfers);
  True    cycles of one activity-masked sweep-kernel sweep over both
          boxes (folded over the chain axis) plus x_per transfer-only
          plain steps, whose volume share keeps the volume cadence;
  "full"  cycles of one Gibbs-kernel launch (ops/cuda/gibbs_kernel.py:
          2 cap moves + x_per transfer attempts), with the volume moves
          on a deterministic cadence between launches.
On CPU tensors the kernel routes run the kernels' plain versions.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.gcmc import check_device
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import make_mol_slots
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops.pbc import cube_root
from metropolismontecarlo_tpu_torch.ops.quaternions import rotate_quaternion
from metropolismontecarlo_tpu_torch.utils.activity import (
    clear_slot2,
    set_slot2,
    zero_empty,
)
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.profiling import span
from metropolismontecarlo_tpu_torch.utils.shard import (
    rand_chains,
    randn_chains,
)


@dataclasses.dataclass
class MolGibbsState:
    """Per-chain two-box state; every tensor leads with the chains axis C,
    then the box axis.  The JAX state's `key` has no counterpart: draws
    come from the torch.Generator that make_gibbs_mol holds."""

    com: torch.Tensor      # (C, 2, cap, 3)
    quat: torch.Tensor     # (C, 2, cap, 4)
    coords: torch.Tensor   # (C, 2, 3, A_pad)
    active: torch.Tensor   # (C, 2, cap) bool
    box: torch.Tensor      # (C, 2)
    sfac: torch.Tensor     # (C, 2, K, 2) ((C, 2, 1, 2) without Ewald)
    energy: torch.Tensor   # (C, 2) carried per-box energies
    acc: torch.Tensor      # (C, 4) int32 accepted [disp, rot, vol, transfer]
    att: torch.Tensor      # (C, 4) int32 attempted


def _fold(x):
    """(C, 2, ...) -> (2 C, ...), box fastest."""
    return x.reshape((2 * x.shape[0],) + tuple(x.shape[2:]))


def _unfold(x):
    return x.reshape((x.shape[0] // 2, 2) + tuple(x.shape[1:]))


def ewald_consistency_check(params, use_ewald):
    """check_ewald_consistency(boxes, tol=5e-3) of a two-box ensemble.

    Transfers need both boxes to sample the same model, which for Ewald
    means converged truncation tails: under kappa = kappa_L / box,
    erfc(kappa qq_cut) differs between boxes, and a truncated model that
    is merely self-consistent drains molecules into the box whose
    electrostatics are softer.  The check raises when the real-space tail
    erfc(kappa qq_cut) of the largest box exceeds tol; set kappa_L / nk /
    ksq_max from ops.ewald.tune_parameters(max_box, r_cut, tol)."""

    def check_ewald_consistency(boxes, tol=5e-3):
        if not use_ewald:
            return
        boxes = np.asarray(boxes, np.float64)
        worst = float(np.max(torch.special.erfc(torch.as_tensor(
            params.kappa_L / boxes * params.qq_cut)).numpy()))
        if worst > tol:
            raise ValueError(
                f"Ewald real-space truncation erfc(kappa*qq_cut) = "
                f"{worst:.2e} in the {float(np.max(boxes)):.1f} A box "
                f"exceeds {tol:g}: the two boxes would sample different "
                "truncated models and transfers drain into the softer one. "
                "Set kappa_L/nk/ksq_max from ops.ewald.tune_parameters("
                "max_box, r_cut, tol) for the largest box this run can "
                "reach")

    return check_ewald_consistency


def volume_step(state, u_dv, u_acc, nf, rebuild, full_energy, dv_max, beta,
                wall, npt_pressure=None, bit=None):
    """One volume attempt of every chain of a two-box state on the uniforms
    u_dv, u_acc (C,): the COMs rescaled with the orientations fixed, the
    atoms rebuilt (rebuild(com, quat) -> coords), both boxes recomputed
    (full_energy(state) -> (energy (C, 2), sfac)); nf (C, 2) the molecules
    per box.  The state needs the fields com, quat, box, sfac, energy, acc
    and att (column 2 counts volume moves).

    npt_pressure None (Gibbs at fixed total volume): dV = (2 u_dv - 1)
    dv_max (V_0 + V_1) moves from box 1 to box 0, and the rule is
    min[1, prod_b (V_b'/V_b)^N_b exp(-beta dU)].  npt_pressure P (K/A^3):
    the box `bit` (C,) bool (True: box 1) takes ln V' = ln V + (2 u_dv -
    1) dv_max against the bath, min[1, (V'/V)^(N + 1) exp(-beta dU -
    beta P dV)].  A proposal that shrinks a box below `wall` or to V <= 0
    is refused.  Inside a `volume_move` span (utils/profiling.py)."""
    with span("volume_move"):
        box, e = state.box, state.energy
        tiny = torch.finfo(box.dtype).tiny
        v = box ** 3
        if npt_pressure is None:
            dv = (u_dv - 0.5) * 2.0 * dv_max * v.sum(1)
            v_new = v + torch.stack([dv, -dv], 1)
            bath = torch.zeros_like(dv)
        else:
            pick = torch.stack([~bit, bit], 1)
            dlnv = (2.0 * u_dv - 1.0) * dv_max
            v_b = torch.where(bit, v[:, 1], v[:, 0])
            v_b_new = v_b * torch.exp(dlnv)
            v_new = torch.where(pick, v_b_new[:, None], v)
            bath = beta * npt_pressure * (v_b_new - v_b) - dlnv
        box_new = cube_root(v_new)             # batch-invariant (ops/pbc.py)
        legal = ((box_new > wall) & (v_new > 0.0)).all(1)
        box_t = torch.where(legal[:, None], box_new, box)
        scale = torch.where(legal[:, None], box_new / box, 1.0)
        com_v = state.com * scale[:, :, None, None]
        coords_v = rebuild(com_v, state.quat)
        e_v, sf_v = full_energy(dataclasses.replace(
            state, com=com_v, coords=coords_v, box=box_t))
        log_a = (nf * torch.log(torch.where(legal[:, None], v_new / v,
                                            1.0))).sum(1) \
            - beta * (e_v - e).sum(1) - torch.where(legal, bath, 0.0)
        ok = legal & (torch.log(torch.clamp_min(u_acc, tiny)) < log_a)
        okc = ok[:, None]
        acc, att = state.acc.clone(), state.att.clone()
        acc[:, 2] += ok.to(torch.int32)
        att[:, 2] += 1
        return dataclasses.replace(
            state, com=torch.where(okc[..., None, None], com_v, state.com),
            coords=torch.where(okc[..., None, None], coords_v, state.coords),
            box=torch.where(okc, box_new, box),
            sfac=torch.where(okc[..., None, None], sf_v, state.sfac),
            energy=torch.where(okc, e_v, e), acc=acc, att=att)


def make_gibbs_mol(system, params, dv_max=0.05, p_transfer=0.3,
                   dtype=torch.float64, n_orient=1, chunk=8, mega=None,
                   device="cuda", generator=None):
    """Build the molecular Gibbs-ensemble functions.

    system: a uniform single-species System whose n_mol is the per-box
    slot capacity.  dv_max: the volume move's half-width as a fraction of
    the total volume.  Returns (init, run_steps, full_energy,
    widom_boltzmann, check_ewald_consistency, pressure_fd, widom_works):
    init(boxes, n_init, n_chains) -> MolGibbsState; run_steps(state,
    n_steps) -> state; full_energy(state) -> (energy (C, 2), sfac (C, 2,
    K, 2)).  The plain route's run_steps also carries its two steps with
    their draws given: run_steps.cheap_step(state, draws) (draws: see
    run_steps.draw_cheap(C)) and run_steps.volume_step(state, u_dv, u_acc).

    n_orient > 1: orientational-bias transfers (Rosenbluth k-trial
    insertion into the destination, the existing orientation + k - 1
    trials at the molecule's COM in the source).  Exact for every k.

    mega=True: the displacement/rotation share runs through the
    activity-masked whole-sweep kernel with the two boxes folded over the
    chain axis; transfers and volume moves stay plain (a p_transfer = 1
    build whose p_volume keeps the volume cadence).  Needs float32 and
    p_transfer > 0 unless p_volume = 0.  mega="full": the transfers run
    in the Gibbs kernel too (mc/moves.make_mega_gibbs_fn), one launch per
    cycle of 2 cap moves + x_per attempts, volume moves between launches
    on a deterministic cadence keeping params.p_volume; needs n_orient =
    1, 0 < p_transfer < 1 and float32.  device: the card unless the
    caller passes "cpu"; generator: the torch.Generator behind every
    draw, seeded 0 when None."""
    device, generator = check_device(device, generator)
    ms = make_mol_slots(system, params, device, dtype)
    ev, P, cap, K = ms.ev, ms.P, ms.cap, ms.K
    use_ewald = ms.use_ewald
    beta = 1.0 / params.temperature
    p_v = float(params.p_volume)
    px = float(p_transfer)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    # the cheap steps' budget (volume rides its own cycle): transfer px,
    # the rest displace / rotate by p_translate
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    move_on = p_disp + p_rot > 0.0
    wall = 2.0 * max(params.r_cut, params.qq_cut) \
        if params.strict_min_image else 0.0
    tiny = torch.finfo(dtype).tiny

    check_ewald_consistency = ewald_consistency_check(params, use_ewald)

    def rand(*shape, fold=1):
        return rand_chains(shape, generator, dtype, device, fold)

    def cfac_of(box):
        return ewald_ops.cfac_coeffs(ms.kv, ms.kw, params.kappa_L / box, box)

    def full_energy(state):
        with span("recompute", 2 * state.com.shape[0]):
            e, sf = chunked_map(ms.full_one, chunk, _fold(state.com),
                                _fold(state.quat), _fold(state.coords),
                                _fold(state.active), _fold(state.box))
            return _unfold(e), _unfold(sf)

    def draw_cheap(C):
        """The draws of one cheap step of C chains, as the JAX step takes
        them from its key: the move type, the box bit, the slot pick, one
        position draw (the displacement and the insertion position), the
        rotation's axis and angle draws, the trial orientations, the trial
        pick and the acceptance."""
        axis = randn_chains((C, 3), generator, dtype, device)
        return SimpleNamespace(
            u_move=rand(C), bit=rand(C) < 0.5, u_sel=rand(C),
            u_pos=rand(C, 3),
            axis=axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
            u_rot=rand(C), quats_in=ms.trial_quats(generator, (C, n_or)),
            quats_del=ms.trial_quats(generator, (C, n_or - 1)),
            u_pick=rand(C), u_acc=rand(C))

    def _cheap_step(state, dr):
        """One displacement, rotation or transfer attempt of every chain
        on the draws dr (draw_cheap); where-selects only."""
        com, quat, coords, active = (state.com, state.quat, state.coords,
                                     state.active)
        box, sfac, e = state.box, state.sfac, state.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        n = active.sum(2)                                        # (C, 2)
        nf = n.to(dtype)
        v = box ** 3
        # 0 displace, 1 rotate, 3 transfer (2: volume, on its own cycle)
        mt = torch.where(dr.u_move < p_disp, 0,
                         torch.where(dr.u_move < p_disp + p_rot, 1, 3))
        b = dr.bit.to(torch.int64)                               # the box
        d = 1 - b
        act_b, act_d = active[ar, b], active[ar, d]
        com_b, quat_b, coords_b = com[ar, b], quat[ar, b], coords[ar, b]
        com_d, coords_d = com[ar, d], coords[ar, d]
        box_b, box_d = box[ar, b], box[ar, d]
        sfac_b, sfac_d = sfac[ar, b], sfac[ar, d]
        n_b, n_d = n[ar, b], n[ar, d]
        nf_b, nf_d = nf[ar, b], nf[ar, d]

        # the slot picked among box b's actives (move and transfer source)
        csum = torch.cumsum(act_b.to(torch.int64), dim=1)
        target = torch.floor(dr.u_sel * nf_b).to(torch.int64) + 1
        idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
        a_ok_b = ms.atom_ok_of(act_b)
        com_i, quat_i = com_b[ar, idx], quat_b[ar, idx]
        ra_old = ev.pose_atoms(com_i, quat_i)                     # (C, P, 3)
        cf_b = cfac_of(box_b) if use_ewald else None
        zero_s = torch.zeros((C, K, 2), dtype=dtype, device=device)
        s_old = ev.pose_sfac(ra_old, box_b) if use_ewald else zero_s

        # the displaced / rotated pose in box b (skipped in transfer-only
        # builds; e_old and s_old serve the transfer source as well)
        if move_on:
            com_new = torch.where(
                (mt == 0)[:, None],
                torch.remainder(com_i + (dr.u_pos - 0.5) * params.dr_max,
                                box_b[:, None]), com_i)
            quat_new = torch.where(
                (mt == 1)[:, None],
                rotate_quaternion(quat_i, dr.axis, dr.u_rot,
                                  params.dphi_max), quat_i)
            ra_new = ev.pose_atoms(com_new, quat_new)
            e2, o2 = ev.pair_energy(
                torch.stack([com_i, com_new], 1),
                torch.stack([ra_old, ra_new], 1), coords_b, com_b, box_b,
                a_ok_b, idx)
            e_old, e_new, ovr_new = e2[:, 0], e2[:, 1], o2[:, 1]
            s_new = ev.pose_sfac(ra_new, box_b) if use_ewald else zero_s
            du_move = e_new - e_old
            if use_ewald:
                du_move = du_move + ewald_ops.recip_energy_delta(
                    sfac_b, s_new - s_old, cf_b)
            ok_m = (mt <= 1) & (n_b > 0) & ~ovr_new \
                & (dr.u_acc < torch.exp(-beta * du_move))
        else:
            e1, _ = ev.pair_energy(com_i[:, None], ra_old[:, None], coords_b,
                                   com_b, box_b, a_ok_b, idx)
            e_old = e1[:, 0]
            ok_m = torch.zeros((C,), dtype=torch.bool, device=device)

        # transfer b -> d: n_or trial orientations in the destination, the
        # existing orientation + n_or - 1 trials in the source (n_or = 1:
        # the unbiased rule)
        cf_d = cfac_of(box_d) if use_ewald else None
        pos_d = dr.u_pos * box_d[:, None]
        u_in_j, ovr_in_j, s_in_j = ms.pose_batch(
            pos_d, dr.quats_in, coords_d, com_d, box_d, ms.atom_ok_of(act_d),
            -1, sfac_d, cf_d)
        neg_inf = torch.full_like(u_in_j, -math.inf)
        m_n, w_n = ms.rosenbluth(torch.where(ovr_in_j, neg_inf,
                                             -beta * u_in_j))
        w_sum_n = w_n.sum(1)
        j_sel = (torch.cumsum(w_n, 1) > (dr.u_pick * w_sum_n)[:, None]) \
            .to(torch.int64).argmax(dim=1)
        quat_in = dr.quats_in[ar, j_sel]
        ra_in = ev.pose_atoms(pos_d, quat_in)
        s_in = s_in_j[ar, j_sel]
        slot_d = (~act_d).to(torch.int64).argmax(dim=1)

        sfac_wo = sfac_b - s_old if use_ewald else sfac_b
        u_exist = e_old
        if use_ewald:
            u_exist = u_exist + ewald_ops.recip_energy_delta(sfac_wo, s_old,
                                                             cf_b)
        neg_o = (-beta * u_exist)[:, None]
        if n_or > 1:
            u_o, ovr_o, _ = ms.pose_batch(com_i, dr.quats_del, coords_b,
                                          com_b, box_b, a_ok_b, idx, sfac_wo,
                                          cf_b)
            neg_o = torch.cat([neg_o, torch.where(
                ovr_o, torch.full_like(u_o, -math.inf), -beta * u_o)], 1)
        m_o, w_o = ms.rosenbluth(neg_o)
        w_sum_o = w_o.sum(1)

        ec_d = ms.exchange_const(box_d, n_d, +1.0)
        ec_s = ms.exchange_const(box_b, n_b, -1.0)
        du_d = u_in_j[ar, j_sel] + ec_d
        du_s = -u_exist + ec_s
        ln_u = torch.log(torch.clamp_min(dr.u_acc, tiny))
        ln_acc_x = torch.log(torch.clamp_min(nf_b, 1.0) * v[ar, d]
                             / ((nf_d + 1.0) * v[ar, b])) \
            + m_n + torch.log(torch.clamp_min(w_sum_n, tiny)) \
            - m_o - torch.log(torch.clamp_min(w_sum_o, tiny)) \
            - beta * (ec_d + ec_s)
        ok_x = (mt == 3) & (n_b > 0) & (n_d < cap) & (w_sum_n > 0.0) \
            & (ln_u < ln_acc_x)

        # apply (the branches exclude each other)
        com, quat, coords = com.clone(), quat.clone(), coords.clone()
        if move_on:
            com[ar, b, idx] = torch.where(ok_m[:, None], com_new, com_i)
            quat[ar, b, idx] = torch.where(ok_m[:, None], quat_new, quat_i)
            coords[ar, b] = ms.write_pose(coords_b, idx, ra_new, ok_m)
        com[ar, d, slot_d] = torch.where(ok_x[:, None], pos_d,
                                         com[ar, d, slot_d])
        quat[ar, d, slot_d] = torch.where(ok_x[:, None], quat_in,
                                          quat[ar, d, slot_d])
        coords[ar, d] = ms.write_pose(coords[ar, d], slot_d, ra_in, ok_x)
        active = clear_slot2(set_slot2(active, d, slot_d, ok_x), b, idx,
                             ok_x)
        sfac, e = sfac.clone(), e.clone()
        zero = torch.zeros_like(e_old)
        if use_ewald:
            w_x = ok_x.to(dtype)[:, None, None]
            if move_on:
                sfac[ar, b] = sfac[ar, b] + ok_m.to(dtype)[:, None, None] \
                    * (s_new - s_old)
            sfac[ar, b] = sfac[ar, b] - w_x * s_old
            sfac[ar, d] = sfac[ar, d] + w_x * s_in
        if move_on:
            e[ar, b] = e[ar, b] + torch.where(ok_m, du_move, zero)
        e[ar, b] = e[ar, b] + torch.where(ok_x, du_s, zero)
        e[ar, d] = e[ar, d] + torch.where(ok_x, du_d, zero)
        a_row = torch.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                             torch.zeros_like(ok_x), ok_x], 1)
        t_row = torch.arange(4, device=device)[None, :] == mt[:, None]
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords, active=active,
            sfac=sfac, energy=e, acc=state.acc + a_row.to(torch.int32),
            att=state.att + t_row.to(torch.int32))

    def rebuild_two(com, quat):
        """(C, 2, 3, A_pad) atom planes of both boxes from slot poses."""
        C = com.shape[0]
        ra = ev.pose_atoms(com, quat)                      # (C, 2, cap, P, 3)
        coords = ra.reshape(C, 2, ms.A, 3).transpose(2, 3)
        return torch.nn.functional.pad(coords, (0, ms.A_pad - ms.A))

    def _vol_step(state, u_dv, u_acc):
        """Volume transfer on the uniforms u_dv, u_acc (C,)."""
        return volume_step(state, u_dv, u_acc, state.active.sum(2).to(dtype),
                           rebuild_two, full_energy, dv_max, beta, wall)

    def _vol_state(state):
        u = rand(state.com.shape[0], 2)
        return _vol_step(state, u[:, 0], u[:, 1])

    period = int(round(1.0 / p_v)) if p_v > 0 else 0

    def run_steps(state, n_steps):
        C = state.com.shape[0]
        n_cycles, rem = divmod(int(n_steps), period) if period > 0 \
            else (0, int(n_steps))
        for _ in range(n_cycles):
            for _ in range(period - 1):
                state = _cheap_step(state, draw_cheap(C))
            state = _vol_state(state)
        for _ in range(rem):
            state = _cheap_step(state, draw_cheap(C))
        return state

    run_steps.cheap_step = _cheap_step
    run_steps.draw_cheap = draw_cheap
    run_steps.volume_step = _vol_step

    if mega:
        if dtype != torch.float32:
            raise ValueError("mega Gibbs requires dtype=float32 (the "
                             "kernels are f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        if px >= 1.0:
            raise ValueError("mega Gibbs needs p_transfer < 1 (otherwise "
                             "there is no displacement work for the "
                             "kernel)")
        if px == 0.0 and p_v > 0:
            raise ValueError("mega Gibbs with p_transfer = 0 cannot "
                             "schedule volume moves (set p_volume = 0 for "
                             "a pure-displacement pre-equilibration)")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc import moves

    if mega == "full":
        if not 0.0 < px < 1.0:
            raise ValueError("mega='full' needs 0 < p_transfer < 1")
        if n_or != 1:
            raise ValueError("in-kernel transfers run the unbiased "
                             "algorithm (n_orient=1); use mega=True for "
                             "Rosenbluth-biased transfers")
        x_per = max(1, int(round(2 * cap * px / (1.0 - px))))
        sweep_g = moves.make_mega_gibbs_fn(system, params, ms.kvecs,
                                           ms.kweights, device, n_exch=x_per)
        att_pc = 2 * cap + x_per
        if p_v > 0:
            vol_pc = p_v * att_pc
            if vol_pc >= 1.0:
                k_vol, vol_every = max(1, int(round(vol_pc))), 1
            else:
                k_vol, vol_every = 1, max(1, int(round(1.0 / vol_pc)))
        else:
            k_vol, vol_every = 0, 1

        def exchange_consts(box):
            """Per box (C, 2): the self + intra constant and the quadratic-
            in-N coefficient (reference Wolf c Q^2, plus the LJ tail: wc
            (2 n +- 1) is g ((N + dn)^2 - N^2) for dn = +-1)."""
            si2 = ev.self_intra(box)
            wc2 = ev.wolf_const_coeff(box) * ms.q_t2
            if ev.use_lrc:
                wc2 = wc2 + ev.lrc_self_coeff(box)
            return si2, wc2

        def _cycle_full(state):
            out = sweep_g(state.com, state.quat, state.coords, state.active,
                          state.box, state.sfac, generator,
                          *exchange_consts(state.box))
            com, quat, coords, active, sfac_o, d_e, acc3, att3 = out
            zc = torch.zeros_like(acc3[:, 0])
            acc4 = torch.stack([acc3[:, 0], acc3[:, 1], zc, acc3[:, 2]], 1)
            att4 = torch.stack([att3[:, 0], att3[:, 1], zc, att3[:, 2]], 1)
            energy, sfac_o = zero_empty(
                state.energy + d_e.to(dtype),
                sfac_o.to(dtype) if use_ewald else state.sfac, active)
            return dataclasses.replace(
                state, com=com.to(dtype), quat=quat.to(dtype),
                coords=coords.to(dtype), active=active, sfac=sfac_o,
                energy=energy,
                acc=state.acc + acc4.to(torch.int32),
                att=state.att + att4.to(torch.int32))

        def run_steps(state, n_steps):                # noqa: F811
            n_cyc = max(1, int(round(n_steps / att_pc)))
            n_sup, rem = divmod(n_cyc, vol_every) if k_vol else (0, n_cyc)
            for _ in range(n_sup):
                for _ in range(vol_every):
                    state = _cycle_full(state)
                for _ in range(k_vol):
                    state = _vol_state(state)
            for _ in range(rem):
                state = _cycle_full(state)
            return state

        run_steps.x_per = x_per

    elif mega:
        sweep_act = moves.make_mega_sweep_fn(system, params, ms.kvecs,
                                             ms.kweights, device,
                                             with_activity=True)
        # one sweep = 2 cap displacement/rotation attempts (both boxes);
        # x_per transfers keep the attempt mix at p_transfer, and the
        # transfer-only build's p_volume is rescaled so that volume
        # attempts per plain-equivalent attempt stay at params.p_volume;
        # p_transfer = 0 (with p_volume = 0) runs kernel sweeps alone
        if px > 0.0:
            x_per = max(1, int(round(2 * cap * px / (1.0 - px))))
            params_x = dataclasses.replace(
                params, p_volume=min(1.0, p_v * (2 * cap + x_per) / x_per)
            ) if p_v > 0 else params
            run_x = make_gibbs_mol(system, params_x, dv_max, 1.0, dtype,
                                   n_orient, chunk, device=device,
                                   generator=generator)[1]
        else:
            run_x, x_per = None, 0

        def _sweep_state(state):
            com, quat, coords, sfac, d_e, acc2, att2 = sweep_act(
                _fold(state.com), _fold(state.quat), _fold(state.coords),
                _fold(state.active), _fold(state.box), _fold(state.sfac),
                generator)
            pad = torch.nn.functional.pad
            return dataclasses.replace(
                state, com=_unfold(com), quat=_unfold(quat),
                coords=_unfold(coords),
                sfac=_unfold(sfac) if use_ewald else state.sfac,
                energy=state.energy + _unfold(d_e),
                acc=state.acc + pad(_unfold(acc2).sum(1).to(torch.int32),
                                    (0, 2)),
                att=state.att + pad(_unfold(att2).sum(1).to(torch.int32),
                                    (0, 2)))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (2 * cap + x_per))))):
                state = _sweep_state(state)
                if run_x is not None:
                    state = run_x(state, x_per)
            return state

        run_steps.sweep = _sweep_state

    def init(boxes, n_init, n_chains):
        """boxes (2,) edge lengths; n_init (2,) active molecules per box."""
        n_init = np.asarray(n_init, np.int64)
        if np.any(n_init > cap):
            raise ValueError("n_init exceeds capacity")
        if params.strict_min_image and min(boxes) < wall:
            raise ValueError(
                f"box {min(boxes)} < 2*cutoff ({wall}) violates minimum-"
                "image (set strict_min_image=False to sample the truncated "
                "model); the volume move only walls proposed boxes, so an "
                "illegal start would go uncaught")
        check_ewald_consistency(np.asarray(boxes))
        per_box = [ms.pose_lattice_init(generator, float(bl), n_chains)
                   for bl in np.asarray(boxes)]
        com, quat, coords = (torch.stack([p[i] for p in per_box], 1)
                             for i in range(3))
        active = torch.arange(cap, device=device)[None, :] \
            < torch.as_tensor(n_init, device=device)[:, None]
        state = MolGibbsState(
            com=com, quat=quat, coords=coords,
            active=active[None].expand(n_chains, 2, cap).contiguous(),
            box=torch.tensor(np.asarray(boxes, np.float64), dtype=dtype,
                             device=device)[None].expand(n_chains, 2)
            .contiguous(),
            sfac=torch.zeros((n_chains, 2, K, 2), dtype=dtype,
                             device=device),
            energy=torch.zeros((n_chains, 2), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 4), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 4), dtype=torch.int32, device=device))
        e, sf = full_energy(state)
        return dataclasses.replace(state, energy=e, sfac=sf)

    def _insertion_du(com, quat, coords, active, box, sfac, pos, quats):
        """Ghost insertion energies with the full exchange energetics
        (pair + reciprocal + the box's constants) of poses pos (B, n, 3),
        quats (B, n, 4) into B one-box configurations: (du, overlap)."""
        n_ins = pos.shape[1]
        ra = ev.pose_atoms(pos, quats)
        e_p, ovr = ev.pair_energy(pos, ra, coords, com, box,
                                  ms.atom_ok_of(active), -1)
        if use_ewald:
            s = ev.pose_sfac(ra, box[:, None].expand(-1, n_ins))
            e_p = e_p + ewald_ops.recip_energy_delta(
                sfac[:, None], s, cfac_of(box)[:, None])
        n = active.sum(1)
        return e_p + ms.exchange_const(box, n, +1.0)[:, None], ovr

    def widom_boltzmann(state, n_insertions):
        """(C, 2) mean exp(-beta dU_test) per box, dU with the full
        exchange energetics, so -ln of it is beta mu_ex in the same
        convention for both boxes (the coexistence diagnostic)."""
        C = state.com.shape[0]
        # box-folded rows, two per chain (chain-global under a shard
        # context)
        pos = rand(2 * C, n_insertions, 3, fold=2) \
            * _fold(state.box)[:, None, None]
        quats = ms.trial_quats(generator, (2 * C, n_insertions), fold=2)

        def one(com, quat, coords, active, box, sfac, pos, quats):
            du, ovr = _insertion_du(com, quat, coords, active, box, sfac,
                                    pos, quats)
            return (torch.where(ovr, 0.0, torch.exp(-beta * du)).mean(1),)

        (bw,) = chunked_map(one, chunk, _fold(state.com), _fold(state.quat),
                            _fold(state.coords), _fold(state.active),
                            _fold(state.box), _fold(state.sfac), pos, quats)
        return _unfold(bw)

    def widom_works(state, n_insert, n_delete):
        """Raw per-box exchange works for a two-sided (BAR) chemical
        potential: insertion energies du_ins (C, 2, n_insert) with their
        overlap flags, and deletion energy changes du_del (C, 2,
        n_delete) of removing a uniformly picked active molecule (-u_exist
        + const), both with the full exchange energetics."""
        C = state.com.shape[0]
        pos = rand(2 * C, n_insert, 3, fold=2) \
            * _fold(state.box)[:, None, None]
        quats = ms.trial_quats(generator, (2 * C, n_insert), fold=2)
        us = rand(2 * C, n_delete, fold=2)

        def one(com, quat, coords, active, box, sfac, pos, quats, us):
            du_i, ovr_i = _insertion_du(com, quat, coords, active, box,
                                        sfac, pos, quats)
            B = com.shape[0]
            ar = torch.arange(B, device=device)
            nf = active.sum(1).to(dtype)
            csum = torch.cumsum(active.to(torch.int64), dim=1)
            ec_d = ms.exchange_const(box, active.sum(1), -1.0)
            a_ok = ms.atom_ok_of(active)
            cf = cfac_of(box) if use_ewald else None
            du_d = []
            for k in range(us.shape[1]):
                target = torch.floor(us[:, k] * nf).to(torch.int64) + 1
                idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
                ra = ev.pose_atoms(com[ar, idx], quat[ar, idx])
                e_d, _ = ev.pair_energy(com[ar, idx][:, None], ra[:, None],
                                        coords, com, box, a_ok, idx)
                u_exist = e_d[:, 0]
                if use_ewald:
                    s_d = ev.pose_sfac(ra, box)
                    u_exist = u_exist + ewald_ops.recip_energy_delta(
                        sfac - s_d, s_d, cf)
                du_d.append(-u_exist + ec_d)
            return du_i, ovr_i, torch.stack(du_d, 1)

        out = chunked_map(one, chunk, _fold(state.com), _fold(state.quat),
                          _fold(state.coords), _fold(state.active),
                          _fold(state.box), _fold(state.sfac), pos, quats,
                          us)
        return tuple(_unfold(x) for x in out)

    def pressure_fd(state, rel=1e-4):
        """(C, 2) pressure per box, K/A^3: P = N k T / V - dU/dV by a
        central difference of the COM-rescaled rigid-molecule energy (the
        two boxes agree at coexistence)."""
        v = state.box ** 3

        def e_at(s):
            com_s = state.com * s
            return full_energy(dataclasses.replace(
                state, com=com_s, coords=rebuild_two(com_s, state.quat),
                box=state.box * s))[0]

        dudv = (e_at((1.0 + rel) ** (1.0 / 3.0))
                - e_at((1.0 - rel) ** (1.0 / 3.0))) / (2.0 * rel * v)
        nf = state.active.sum(2).to(dtype)
        return nf * params.temperature / v - dudv

    return (init, run_steps, full_energy, widom_boltzmann,
            check_ewald_consistency, pressure_fd, widom_works)


class MolGibbsEnsemble:
    """The molecular Gibbs app as a class: blocks with the drift invariant
    and phase statistics.

    >>> g = MolGibbsEnsemble(spce_system(48), params, dv_max=0.03)
    >>> st = g.init(boxes=(20.0, 24.0), n_init=(32, 8), n_chains=16)
    >>> st, stats = g.run_block(st, 5000, drift_tol=1e-9)
    """

    def __init__(self, system, params, dv_max=0.05, p_transfer=0.3,
                 dtype=torch.float64, n_orient=1, chunk=8, mega=None,
                 device="cuda", generator=None):
        self.params = params
        self.capacity = system.n_mol
        (self._init, self.run_steps, self.full_energy,
         self.widom_boltzmann, self._check_ewald, self.pressure_fd,
         self.widom_works) = make_gibbs_mol(
            system, params, dv_max, p_transfer, dtype, n_orient, chunk,
            mega=mega, device=device, generator=generator)

    def init(self, boxes, n_init, n_chains):
        return self._init(boxes, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        """run_steps, then the block-end resync: the carried energies and
        S(k) are replaced by a recompute, after the drift between the two
        is measured (scaled by both block endpoints)."""
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        # a volume exchange can grow a box past the Ewald envelope checked
        # at init: checked again at every block end
        self._check_ewald(np.asarray([float(state.box.max())]))
        e, sf = self.full_energy(state)
        scale = torch.clamp_min(torch.maximum(e.abs(), e_start.abs()), 1.0)
        drift = torch.max((e - state.energy).abs() / scale)
        sfac_err = torch.max((sf - state.sfac).abs())
        n = state.active.sum(2).to(torch.float64)                # (C, 2)
        rho = n / state.box.to(torch.float64) ** 3
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "n_mean": [float(x) for x in n.mean(0)],
            "rho_liq": float(rho.max(1).values.mean()),
            "rho_vap": float(rho.min(1).values.mean()),
            "full_frac": float((n >= self.capacity).to(torch.float64)
                               .mean()),
            "acc_disp": float(ratio[:, 0].mean()),
            "acc_rot": float(ratio[:, 1].mean()),
            "acc_vol": float(ratio[:, 2].mean()),
            "acc_transfer": float(ratio[:, 3].mean()),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and bool(torch.isfinite(e).all())):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e, sfac=sf), stats
