"""Gibbs-ensemble MC for binary mixtures: two-box coexistence with
per-species transfers, the composition split of a vapour-liquid
equilibrium without chemical potentials (counterpart of
metropolismontecarlo_tpu/mc/gibbs_binary.py; Panagiotopoulos 1987,
Frenkel & Smit ch. 8.3).

The total N of each species and the total volume are fixed; the boxes
exchange volume and molecules of either species until every species'
chemical potential and the pressure agree between them.  Built from the
two-species slot machinery (`mc/gcmc_binary.make_binary_slots`) and the
two-box parts of `mc/gibbs_mol.py` (the volume step, the Ewald guard).
Moves:

    displace / rotate: a random box, a random active molecule of either
        species (the picked species' pose energies selected);
    volume (a deterministic cycle, as in mc/gibbs_mol.py): dV moves
        between the boxes, COMs rescaled with orientations fixed, both
        boxes recomputed; the rule uses each box's total molecule count;
    transfer of species s: a uniform active s-molecule leaves box b and
        enters box 1 - b at a uniform pose,
        min[1, N_s,src V_dst / ((N_s,dst + 1) V_src) exp(-beta dU)],
        dU with both boxes' pair and reciprocal deltas and the
        box-dependent constants.

npt_pressure P (K/A^3) makes it the constant-pressure Gibbs ensemble of
a mixture: each volume attempt moves one box's ln V against the bath
(dv_max is then the ln V half-width), and the transfers find the
coexisting compositions at (T, P).

Three routes, chosen by `mega`:
  None    one attempt of every chain per step in plain tensor code (every
          convention, float64, Rosenbluth-biased transfers);
  True    cycles of one activity-masked sweep-kernel sweep over both boxes
          (folded over the chain axis, one launch per species block) plus
          x_per transfer-only plain steps that keep the volume cadence;
  "full"  cycles of one Gibbs-kernel launch per species block, each with
          its species' transfer attempts (mc/moves.make_mega_gibbs_binary_fn),
          the volume moves on a deterministic cadence between cycles.
On CPU tensors the kernel routes run the kernels' plain versions.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.gcmc import check_device
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import make_binary_slots
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import (
    _fold,
    _unfold,
    ewald_consistency_check,
    volume_step,
)
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops.quaternions import rotate_quaternion
from metropolismontecarlo_tpu_torch.utils.activity import (
    clear_slot2,
    set_slot2,
    zero_empty,
)
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.shard import (
    rand_chains,
    randn_chains,
)


@dataclasses.dataclass
class BinaryGibbsState:
    """Per-chain two-box binary state; every tensor leads with the chains
    axis C, then the box axis.  The JAX state's `key` has no counterpart:
    draws come from the torch.Generator that make_gibbs_binary holds."""

    com: torch.Tensor      # (C, 2, M, 3)  M = cap0 + cap1 slots per box
    quat: torch.Tensor     # (C, 2, M, 4)
    coords: torch.Tensor   # (C, 2, 3, A_pad)
    active0: torch.Tensor  # (C, 2, cap0) bool
    active1: torch.Tensor  # (C, 2, cap1) bool
    box: torch.Tensor      # (C, 2)
    sfac: torch.Tensor     # (C, 2, K, 2) ((C, 2, 1, 2) without Ewald)
    energy: torch.Tensor   # (C, 2)
    acc: torch.Tensor      # (C, 5) int32 [disp, rot, vol, xfer0, xfer1]
    att: torch.Tensor      # (C, 5) int32


def make_gibbs_binary(system, params, dv_max=0.05, p_transfer=0.3,
                      dtype=torch.float64, n_orient=1, chunk=8, mega=None,
                      npt_pressure=None, device="cuda", generator=None):
    """Build the binary Gibbs-ensemble functions.

    system: a two-species-block System; each block's molecule count is
    that species' per-box slot capacity.  Transfer attempts split
    p_transfer equally between the species.  Returns (init, run_steps,
    full_energy, check_ewald_consistency, pressure_fd, widom_boltzmann):
    init(boxes, n_init (2 species, 2 boxes), n_chains) ->
    BinaryGibbsState; run_steps(state, n_steps) -> state; full_energy(state)
    -> (energy (C, 2), sfac (C, 2, K, 2)).  The plain route's run_steps
    also carries its steps with their draws given:
    run_steps.cheap_step(state, draws) (draws: run_steps.draw_cheap(C)) and
    run_steps.volume_step(state, u_dv, u_acc, bit=None).

    npt_pressure (K/A^3): constant-pressure Gibbs (mixtures only): each
    volume attempt picks one box and moves its ln V by up to +-dv_max
    against the bath (mc/gibbs_mol.volume_step).

    mega=True: the displacement/rotation share through the activity-masked
    whole-sweep kernel, the boxes folded over the chain axis, one launch
    per species block; transfers and volume moves stay plain (a p_transfer
    = 1 build whose p_volume keeps the volume cadence).  mega="full": the
    per-species transfers run in the Gibbs kernel too, one launch per
    species block per cycle.  Both need float32; "full" also n_orient = 1,
    0 < p_transfer < 1 and charge-neutral species.  device: the card
    unless the caller passes "cpu"; generator: the torch.Generator behind
    every draw, seeded 0 when None."""
    device, generator = check_device(device, generator)
    ms = make_binary_slots(system, params, device, dtype)
    evs, caps, m0s, a0s, Ps = ms.evs, ms.caps, ms.m0s, ms.a0s, ms.Ps
    M, K, use_ewald = ms.M, ms.K, ms.use_ewald
    beta = 1.0 / params.temperature
    p_v = float(params.p_volume)
    px = float(p_transfer)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
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
        e, sf = chunked_map(ms.full_one, chunk, _fold(state.com),
                            _fold(state.quat), _fold(state.coords),
                            _fold(state.active0), _fold(state.active1),
                            _fold(state.box))
        return _unfold(e), _unfold(sf)

    def draw_cheap(C):
        """The draws of one cheap step of C chains, as the JAX step takes
        them from its key: the move type, the box bit, the slot pick, the
        displacement, the rotation's axis and angle, per species the
        insertion position, its trial orientations, the source pick, the
        source's extra trials and the trial pick, and the acceptance."""
        axis = randn_chains((C, 3), generator, dtype, device)
        return SimpleNamespace(
            u_move=rand(C), bit=rand(C) < 0.5, u_sel=rand(C),
            u_pos=rand(C, 3),
            axis=axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
            u_rot=rand(C), u_ins=rand(C, 2, 3),
            quats_ins=torch.stack([ms.trial_quats[s](generator, (C, n_or))
                                   for s in (0, 1)], 1),
            u_del=rand(C, 2),
            quats_del=torch.stack([ms.trial_quats[s](generator,
                                                     (C, n_or - 1))
                                   for s in (0, 1)], 1),
            u_pick=rand(C, 2), u_acc=rand(C))

    def _cheap_step(state, dr):
        """One displacement, rotation or transfer (of either species)
        attempt of every chain on the draws dr (draw_cheap)."""
        com, quat, coords = state.com, state.quat, state.coords
        actives = (state.active0, state.active1)
        box, sfac, e = state.box, state.sfac, state.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        n = tuple(a.sum(2) for a in actives)                    # (C, 2) each
        v = box ** 3
        # 0 displace, 1 rotate, 3 transfer species 0, 4 species 1 (2: volume,
        # on its own cycle)
        mt = torch.where(
            dr.u_move < p_disp, 0, torch.where(
                dr.u_move < p_disp + p_rot, 1,
                torch.where(dr.u_move < p_disp + p_rot + 0.5 * px, 3, 4)))
        ln_u = torch.log(torch.clamp_min(dr.u_acc, tiny))
        b = dr.bit.to(torch.int64)
        d = 1 - b
        act_b = tuple(a[ar, b] for a in actives)
        act_d = tuple(a[ar, d] for a in actives)
        com_b, quat_b, coords_b = com[ar, b], quat[ar, b], coords[ar, b]
        com_d, coords_d = com[ar, d], coords[ar, d]
        box_b, box_d = box[ar, b], box[ar, d]
        sfac_b, sfac_d = sfac[ar, b], sfac[ar, d]
        n_b = tuple(x[ar, b] for x in n)
        n_d = tuple(x[ar, d] for x in n)
        cf_b = cfac_of(box_b) if use_ewald else None
        cf_d = cfac_of(box_d) if use_ewald else None
        a_ok_b, a_ok_d = ms.atom_ok_of(*act_b), ms.atom_ok_of(*act_d)
        zero_s = torch.zeros((C, K, 2), dtype=dtype, device=device)

        # displacement / rotation: the pick among all active of box b
        n_tot_b = n_b[0] + n_b[1]
        csum = torch.cumsum(torch.cat(act_b, 1).to(torch.int64), dim=1)
        target = torch.floor(dr.u_sel * n_tot_b.to(dtype)).to(torch.int64) + 1
        idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
        is_a = idx < caps[0]
        com_i, quat_i = com_b[ar, idx], quat_b[ar, idx]
        ok_m = torch.zeros((C,), dtype=torch.bool, device=device)
        if move_on:
            com_new = torch.where(
                (mt == 0)[:, None],
                torch.remainder(com_i + (dr.u_pos - 0.5) * params.dr_max,
                                box_b[:, None]), com_i)
            quat_new = torch.where(
                (mt == 1)[:, None],
                rotate_quaternion(quat_i, dr.axis, dr.u_rot,
                                  params.dphi_max), quat_i)
            per = []
            for ev in evs:
                ra_o = ev.pose_atoms(com_i, quat_i)
                ra_n = ev.pose_atoms(com_new, quat_new)
                e2, o2 = ev.pair_energy(
                    torch.stack([com_i, com_new], 1),
                    torch.stack([ra_o, ra_n], 1), coords_b, com_b, box_b,
                    a_ok_b, idx)
                s_o = ev.pose_sfac(ra_o, box_b) if use_ewald else zero_s
                s_n = ev.pose_sfac(ra_n, box_b) if use_ewald else zero_s
                per.append((ra_n, e2[:, 0], e2[:, 1], o2[:, 1], s_o, s_n))
            e_old, e_new, ovr_new, s_old, s_new = (
                torch.where(is_a.reshape((C,) + (1,) * (x.dim() - 1)), x, y)
                for x, y in zip(per[0][1:], per[1][1:]))
            du_move = e_new - e_old
            if use_ewald:
                du_move = du_move + ewald_ops.recip_energy_delta(
                    sfac_b, s_new - s_old, cf_b)
            ok_m = (mt <= 1) & (n_tot_b > 0) & ~ovr_new \
                & (dr.u_acc < torch.exp(-beta * du_move))

        # per-species transfer b -> d: n_or trial orientations at one
        # uniform position of box d; the source's existing orientation +
        # n_or - 1 trials
        xfer = []
        for s in (0, 1):
            nf_src, nf_dst = n_b[s].to(dtype), n_d[s].to(dtype)
            pos_d = dr.u_ins[:, s] * box_d[:, None]
            quats_i = dr.quats_ins[:, s]
            u_i, ovr_i, s_i = ms.pose_batch(s, pos_d, quats_i, coords_d,
                                            com_d, box_d, a_ok_d, -1, sfac_d,
                                            cf_d)
            m_i, w_i = ms.rosenbluth(torch.where(
                ovr_i, torch.full_like(u_i, -math.inf), -beta * u_i))
            w_sum_i = w_i.sum(1)
            j_sel = (torch.cumsum(w_i, 1) > (dr.u_pick[:, s]
                                             * w_sum_i)[:, None]) \
                .to(torch.int64).argmax(dim=1)
            quat_in = quats_i[ar, j_sel]
            slot_d = (~act_d[s]).to(torch.int64).argmax(dim=1)
            csum_s = torch.cumsum(act_b[s].to(torch.int64), dim=1)
            t_s = torch.floor(dr.u_del[:, s] * nf_src).to(torch.int64) + 1
            slot_s = (csum_s >= t_s[:, None]).to(torch.int64).argmax(dim=1)
            mol_s = m0s[s] + slot_s
            com_s, quat_s = com_b[ar, mol_s], quat_b[ar, mol_s]
            ra_s = evs[s].pose_atoms(com_s, quat_s)
            e_s, _ = evs[s].pair_energy(com_s[:, None], ra_s[:, None],
                                        coords_b, com_b, box_b, a_ok_b,
                                        mol_s)
            u_exist, s_s, sfac_wo = e_s[:, 0], zero_s, sfac_b
            if use_ewald:
                s_s = evs[s].pose_sfac(ra_s, box_b)
                sfac_wo = sfac_b - s_s
                u_exist = u_exist + ewald_ops.recip_energy_delta(
                    sfac_wo, s_s, cf_b)
            neg_o = (-beta * u_exist)[:, None]
            if n_or > 1:
                u_o, ovr_o, _ = ms.pose_batch(s, com_s, dr.quats_del[:, s],
                                              coords_b, com_b, box_b, a_ok_b,
                                              mol_s, sfac_wo, cf_b)
                neg_o = torch.cat([neg_o, torch.where(
                    ovr_o, torch.full_like(u_o, -math.inf), -beta * u_o)], 1)
            m_o, w_o = ms.rosenbluth(neg_o)
            w_sum_o = w_o.sum(1)
            ec_d = ms.exchange_const(box_d, *n_d, s, +1.0)
            ec_s = ms.exchange_const(box_b, *n_b, s, -1.0)
            ln_acc = torch.log(torch.clamp_min(nf_src, 1.0) * v[ar, d]
                               / ((nf_dst + 1.0) * v[ar, b])) \
                + m_i + torch.log(torch.clamp_min(w_sum_i, tiny)) \
                - m_o - torch.log(torch.clamp_min(w_sum_o, tiny)) \
                - beta * (ec_d + ec_s)
            ok = (mt == 3 + s) & (n_b[s] > 0) & (n_d[s] < caps[s]) \
                & (w_sum_i > 0.0) & (ln_u < ln_acc)
            xfer.append(SimpleNamespace(
                ok=ok, pos=pos_d, quat=quat_in,
                ra_in=evs[s].pose_atoms(pos_d, quat_in), s_in=s_i[ar, j_sel],
                slot_d=slot_d, slot_s=slot_s, s_s=s_s,
                du_d=u_i[ar, j_sel] + ec_d, du_s=-u_exist + ec_s))

        # apply (the branches exclude each other)
        com, quat, coords = com.clone(), quat.clone(), coords.clone()
        sfac, e = sfac.clone(), e.clone()
        if move_on:
            com[ar, b, idx] = torch.where(ok_m[:, None], com_new, com_i)
            quat[ar, b, idx] = torch.where(ok_m[:, None], quat_new, quat_i)
            for s in (0, 1):
                mine = is_a if s == 0 else ~is_a
                a0 = torch.where(mine, a0s[s] + (idx - m0s[s]) * Ps[s], 0)
                coords[ar, b] = ms.write_pose(coords[ar, b], a0, Ps[s],
                                              per[s][0], ok_m & mine)
            sfac[ar, b] = sfac[ar, b] + ok_m.to(dtype)[:, None, None] \
                * (s_new - s_old)
            e[ar, b] = e[ar, b] + torch.where(ok_m, du_move, 0.0)
        new_actives = []
        for s, x in enumerate(xfer):
            w_x = x.ok.to(dtype)[:, None, None]
            mol_d = m0s[s] + x.slot_d
            com[ar, d, mol_d] = torch.where(x.ok[:, None], x.pos,
                                            com[ar, d, mol_d])
            quat[ar, d, mol_d] = torch.where(x.ok[:, None], x.quat,
                                             quat[ar, d, mol_d])
            coords[ar, d] = ms.write_pose(coords[ar, d],
                                          a0s[s] + x.slot_d * Ps[s], Ps[s],
                                          x.ra_in, x.ok)
            new_actives.append(clear_slot2(
                set_slot2(actives[s], d, x.slot_d, x.ok), b, x.slot_s, x.ok))
            sfac[ar, d] = sfac[ar, d] + w_x * x.s_in
            sfac[ar, b] = sfac[ar, b] - w_x * x.s_s
            e[ar, d] = e[ar, d] + torch.where(x.ok, x.du_d, 0.0)
            e[ar, b] = e[ar, b] + torch.where(x.ok, x.du_s, 0.0)
        a_row = torch.stack([ok_m & (mt == 0), ok_m & (mt == 1),
                             torch.zeros_like(ok_m), xfer[0].ok, xfer[1].ok],
                            1)
        t_row = torch.arange(5, device=device)[None, :] == mt[:, None]
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords,
            active0=new_actives[0], active1=new_actives[1], sfac=sfac,
            energy=e, acc=state.acc + a_row.to(torch.int32),
            att=state.att + t_row.to(torch.int32))

    def rebuild(com, quat):
        """(C, 2, 3, A_pad) atom planes of both boxes from slot poses."""
        C = com.shape[0]
        return ms.poses_to_coords(_fold(com), _fold(quat)).reshape(
            C, 2, 3, ms.A_pad)

    def _n_tot(state):
        return (state.active0.sum(2) + state.active1.sum(2)).to(dtype)

    def _vol_step(state, u_dv, u_acc, bit=None):
        """One volume attempt on the uniforms u_dv, u_acc (C,) and, under
        npt_pressure, the box bit (C,) bool."""
        return volume_step(state, u_dv, u_acc, _n_tot(state), rebuild,
                           full_energy, dv_max, beta, wall, npt_pressure,
                           bit)

    def _vol_state(state):
        C = state.com.shape[0]
        u = rand(C, 3)
        return _vol_step(state, u[:, 0], u[:, 2], u[:, 1] < 0.5)

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
            raise ValueError("mega binary Gibbs requires dtype=float32 (the "
                             "kernels are f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        if px >= 1.0:
            raise ValueError("mega binary Gibbs needs p_transfer < 1")
        if px == 0.0 and p_v > 0:
            raise ValueError("mega binary Gibbs with p_transfer = 0 cannot "
                             "schedule volume moves")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc import moves

    if mega == "full":
        if not 0.0 < px < 1.0:
            raise ValueError("mega='full' needs 0 < p_transfer < 1")
        if n_or != 1:
            raise ValueError("in-kernel transfers run the unbiased "
                             "algorithm (n_orient=1); use mega=True for "
                             "Rosenbluth-biased transfers")
        if any(abs(ev.q_t_tot) > 1e-5 for ev in evs):
            raise ValueError("in-kernel binary transfers require charge-"
                             "neutral species (the global charge term "
                             "couples the two counts)")
        x_half = max(1, int(round(2 * M * 0.5 * px / (1.0 - px))))
        sweep_g = moves.make_mega_gibbs_binary_fn(
            system, params, ms.kvecs, ms.kweights, device,
            n_exch=(x_half, x_half))
        att_pc = 2 * M + 2 * x_half
        if p_v > 0:
            vol_pc = p_v * att_pc
            if vol_pc >= 1.0:
                k_vol, vol_every = max(1, int(round(vol_pc))), 1
            else:
                k_vol, vol_every = 1, max(1, int(round(1.0 / vol_pc)))
        else:
            k_vol, vol_every = 0, 1

        def exchange_consts(box):
            """Per species the (C, 2) self + intra constant and own-species
            tail coefficient, and the cross-species tail coefficients (or
            None), per box."""
            si2s = tuple(ev.self_intra(box) for ev in evs)
            if not ms.use_lrc:
                return si2s, (torch.zeros_like(box),) * 2, None
            g = ms.lrc_gmat(box.reshape(-1)).reshape(box.shape + (2, 2))
            return (si2s, (g[..., 0, 0], g[..., 1, 1]),
                    (g[..., 0, 1], g[..., 1, 0]))

        def _cycle_full(state):
            si2s, wc2s, lrc_cross = exchange_consts(state.box)
            (com, quat, coords, a0, a1, sfac_o, d_e, acc4,
             att4) = sweep_g(state.com, state.quat, state.coords,
                             state.active0, state.active1, state.box,
                             state.sfac, generator, si2s, wc2s,
                             lrc_cross=lrc_cross)
            zc = torch.zeros_like(acc4[:, :1])
            energy, sfac_o = zero_empty(
                state.energy + d_e.to(dtype),
                sfac_o.to(dtype) if use_ewald else state.sfac,
                torch.cat([a0, a1], 2))
            return dataclasses.replace(
                state, com=com.to(dtype), quat=quat.to(dtype),
                coords=coords.to(dtype), active0=a0, active1=a1, sfac=sfac_o,
                energy=energy,
                acc=state.acc + torch.cat([acc4[:, :2], zc, acc4[:, 2:]],
                                          1).to(torch.int32),
                att=state.att + torch.cat([att4[:, :2], zc, att4[:, 2:]],
                                          1).to(torch.int32))

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

        run_steps.cycle = _cycle_full
        run_steps.x_half = x_half

    elif mega:
        sweep_act = moves.make_mega_sweep_fn(system, params, ms.kvecs,
                                             ms.kweights, device,
                                             with_activity=True)
        if px > 0.0:
            x_per = max(1, int(round(2 * M * px / (1.0 - px))))
            params_x = dataclasses.replace(
                params, p_volume=min(1.0, p_v * (2 * M + x_per) / x_per)
            ) if p_v > 0 else params
            run_x = make_gibbs_binary(system, params_x, dv_max, 1.0, dtype,
                                      n_orient, chunk,
                                      npt_pressure=npt_pressure,
                                      device=device, generator=generator)[1]
        else:
            run_x, x_per = None, 0

        def _sweep_state(state):
            active = torch.cat([state.active0, state.active1], 2)
            com, quat, coords, sfac, d_e, acc2, att2 = sweep_act(
                _fold(state.com), _fold(state.quat), _fold(state.coords),
                _fold(active), _fold(state.box), _fold(state.sfac),
                generator)
            pad = torch.nn.functional.pad
            return dataclasses.replace(
                state, com=_unfold(com).to(dtype),
                quat=_unfold(quat).to(dtype),
                coords=_unfold(coords).to(dtype),
                sfac=_unfold(sfac).to(dtype) if use_ewald else state.sfac,
                energy=state.energy + _unfold(d_e).to(dtype),
                acc=state.acc + pad(_unfold(acc2).sum(1).to(torch.int32),
                                    (0, 3)),
                att=state.att + pad(_unfold(att2).sum(1).to(torch.int32),
                                    (0, 3)))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (2 * M + x_per))))):
                state = _sweep_state(state)
                if run_x is not None:
                    state = run_x(state, x_per)
            return state

        run_steps.sweep = _sweep_state

    def init(boxes, n_init, n_chains):
        """boxes (2,) edges; n_init (2, 2) = [species][box] counts: the
        first n_init[s][b] slots of species s start active in box b."""
        n_init = np.asarray(n_init, np.int64)
        if n_init.shape != (2, 2):
            raise ValueError("n_init must be (2 species, 2 boxes)")
        for s in (0, 1):
            if np.any(n_init[s] > caps[s]):
                raise ValueError(f"species-{s} n_init {n_init[s]} exceeds "
                                 f"capacity {caps[s]}")
        if params.strict_min_image and min(boxes) < wall:
            raise ValueError(
                f"box {min(boxes)} < 2*cutoff ({wall}) violates minimum-"
                "image (set strict_min_image=False to sample the truncated "
                "model)")
        check_ewald_consistency(np.asarray(boxes))
        per_box = [ms.pose_lattice_init(generator, float(bl), n_chains)
                   for bl in np.asarray(boxes)]
        com, quat, coords = (torch.stack([p[i] for p in per_box], 1)
                             for i in range(3))
        act = [(torch.arange(caps[s], device=device)[None, :]
                < torch.as_tensor(n_init[s], device=device)[:, None])[None]
               .expand(n_chains, 2, caps[s]).contiguous() for s in (0, 1)]
        state = BinaryGibbsState(
            com=com, quat=quat, coords=coords, active0=act[0],
            active1=act[1],
            box=torch.tensor(np.asarray(boxes, np.float64), dtype=dtype,
                             device=device)[None].expand(n_chains, 2)
            .contiguous(),
            sfac=torch.zeros((n_chains, 2, K, 2), dtype=dtype, device=device),
            energy=torch.zeros((n_chains, 2), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 5), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 5), dtype=torch.int32, device=device))
        e, sf = full_energy(state)
        return dataclasses.replace(state, energy=e, sfac=sf)

    def pressure_fd(state, rel=1e-4):
        """(C, 2) pressure per box, K/A^3: P = N_tot k T / V - dU/dV by a
        central difference of the COM-rescaled rigid-molecule energy (the
        two boxes agree at coexistence; the vapour box's value is the
        saturation pressure of the sampled model)."""
        v = state.box ** 3

        def e_at(s):
            com_s = state.com * s
            return full_energy(dataclasses.replace(
                state, com=com_s, coords=rebuild(com_s, state.quat),
                box=state.box * s))[0]

        dudv = (e_at((1.0 + rel) ** (1.0 / 3.0))
                - e_at((1.0 - rel) ** (1.0 / 3.0))) / (2.0 * rel * v)
        return _n_tot(state) * params.temperature / v - dudv

    def widom_boltzmann(state, n_insertions, species):
        """(C, 2) mean exp(-beta dU_test) per box for ghost insertions of
        `species`, dU with the full exchange energetics: beta mu_s = ln
        rho_s - ln(this) in one convention for both boxes, so per-species
        equality is the mixture-coexistence diagnostic."""
        s = int(species)
        C = state.com.shape[0]
        # box-folded rows, two per chain (chain-global under a shard
        # context)
        pos = rand(2 * C, n_insertions, 3, fold=2) \
            * _fold(state.box)[:, None, None]
        quats = ms.trial_quats[s](generator, (2 * C, n_insertions), fold=2)

        def one(com, quat, coords, active0, active1, box, sfac, pos, quats):
            ra = evs[s].pose_atoms(pos, quats)
            e_p, ovr = evs[s].pair_energy(pos, ra, coords, com, box,
                                          ms.atom_ok_of(active0, active1),
                                          -1)
            if use_ewald:
                sf = evs[s].pose_sfac(ra, box[:, None].expand(
                    -1, n_insertions))
                e_p = e_p + ewald_ops.recip_energy_delta(
                    sfac[:, None], sf, cfac_of(box)[:, None])
            ec = ms.exchange_const(box, active0.sum(1), active1.sum(1), s,
                                   +1.0)
            return (torch.where(ovr, 0.0, torch.exp(
                -beta * (e_p + ec[:, None]))).mean(1),)

        (bw,) = chunked_map(one, chunk, _fold(state.com), _fold(state.quat),
                            _fold(state.coords), _fold(state.active0),
                            _fold(state.active1), _fold(state.box),
                            _fold(state.sfac), pos, quats)
        return _unfold(bw)

    return (init, run_steps, full_energy, check_ewald_consistency,
            pressure_fd, widom_boltzmann)


class BinaryGibbsEnsemble:
    """The binary Gibbs app as a class: blocks with the drift invariant and
    per-phase composition statistics.

    >>> g = BinaryGibbsEnsemble(co2_n2_system(64, 64), params)
    >>> st = g.init(boxes=(22.0, 30.0), n_init=[[40, 8], [10, 20]],
    ...             n_chains=32)
    >>> st, stats = g.run_block(st, 4000, drift_tol=1e-9)
    """

    def __init__(self, system, params, dv_max=0.05, p_transfer=0.3,
                 dtype=torch.float64, n_orient=1, chunk=8, mega=None,
                 npt_pressure=None, device="cuda", generator=None):
        self.params = params
        (self._init, self.run_steps, self.full_energy, self._check_ewald,
         self.pressure_fd, self.widom_boltzmann) = make_gibbs_binary(
            system, params, dv_max, p_transfer, dtype, n_orient, chunk,
            mega=mega, npt_pressure=npt_pressure, device=device,
            generator=generator)
        sl = system.species_slices
        self.capacities = (sl[0][2] - sl[0][1], sl[1][2] - sl[1][1])

    def init(self, boxes, n_init, n_chains):
        return self._init(boxes, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        """run_steps, then the block-end resync: the carried energies and
        S(k) are replaced by a recompute, after the drift between the two
        is measured (scaled by both block endpoints).  Phase labels are per
        chain: the liquid is the denser box."""
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        # a volume move can grow a box past the Ewald envelope checked at
        # init: checked again at every block end
        self._check_ewald(np.asarray([float(state.box.max())]))
        e, sf = self.full_energy(state)
        scale = torch.clamp_min(torch.maximum(e.abs(), e_start.abs()), 1.0)
        drift = torch.max((e - state.energy).abs() / scale)
        sfac_err = torch.max((sf - state.sfac).abs())
        n0 = state.active0.sum(2).to(torch.float64)              # (C, 2)
        n1 = state.active1.sum(2).to(torch.float64)
        rho = (n0 + n1) / state.box.to(torch.float64) ** 3
        liq = rho.argmax(1)
        ch = torch.arange(rho.shape[0], device=rho.device)
        x0 = n0 / torch.clamp_min(n0 + n1, 1.0)
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "n0_mean": [float(x) for x in n0.mean(0)],
            "n1_mean": [float(x) for x in n1.mean(0)],
            "rho_liq": float(rho[ch, liq].mean()),
            "rho_vap": float(rho[ch, 1 - liq].mean()),
            "x0_liq": float(x0[ch, liq].mean()),
            "x0_vap": float(x0[ch, 1 - liq].mean()),
            "acc_disp": float(ratio[:, 0].mean()),
            "acc_rot": float(ratio[:, 1].mean()),
            "acc_vol": float(ratio[:, 2].mean()),
            "acc_transfer0": float(ratio[:, 3].mean()),
            "acc_transfer1": float(ratio[:, 4].mean()),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and math.isfinite(stats["rho_liq"])):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e, sfac=sf), stats
