"""Osmotic-ensemble MC: grand-canonical solute exchange in a fixed amount of
solvent, mu_solute V T N_solvent (counterpart of
metropolismontecarlo_tpu/mc/gcmc_osmotic.py).

The solubility workhorse (Henry constants, gas loading in a liquid): the
solvent molecule count is fixed while solute molecules exchange with a
reservoir at activity z.  A two-species-block System, solvent block
first, solute block last (its count is the slot capacity), each block
internally uniform; the two-species slot machinery of
`mc/gcmc_binary.make_binary_slots` with the solvent block always active.
Displacements and rotations pick among all active molecules (solvent and
solute) and select the picked species' pose energies; solute insertions
and deletions run as in mc/gcmc_mol.py (with the Rosenbluth option), the
carried Ewald S(k) updated by every accepted move:

    insert:  min[1, z V / (N + 1) exp(-beta dU)]
    delete:  min[1, N / (z V)     exp(-beta dU)]

Three routes, chosen by `mega`:
  None    one attempt of every chain per step in plain tensor code (every
          convention, float64, Rosenbluth-biased exchanges); the step takes
          its draws explicitly: run_steps.step(state, draws), draws from
          run_steps.draw(C);
  True    cycles of one activity-masked sweep-kernel sweep (one launch per
          species block, the solvent's activity all ones) plus x_per
          exchange-only plain steps;
  "full"  cycles of the two block launches with x_per solute exchange
          attempts appended to the solute block's launch only (n_exch =
          (0, x_per)); unbiased, charge-neutral solute.
On CPU tensors the kernel routes run the kernel's plain version.
"""

import dataclasses
import math
from types import SimpleNamespace

import torch

from metropolismontecarlo_tpu_torch.mc.gcmc import check_device
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import (
    binary_atom_ok,
    make_binary_slots,
)
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops.quaternions import rotate_quaternion
from metropolismontecarlo_tpu_torch.utils.activity import clear_slot, set_slot
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.shard import (
    rand_chains,
    randn_chains,
)


@dataclasses.dataclass
class OsmoticState:
    """Per-chain osmotic state; every tensor leads with the chains axis C.
    The JAX state's `key` has no counterpart: draws come from the
    torch.Generator that make_gcmc_osmotic holds."""

    com: torch.Tensor      # (C, M, 3)  M = n_solvent + capacity
    quat: torch.Tensor     # (C, M, 4)
    coords: torch.Tensor   # (C, 3, A_pad)
    active: torch.Tensor   # (C, cap) bool, solute slots only
    box: torch.Tensor      # (C,)
    sfac: torch.Tensor     # (C, K, 2) ((C, 1, 2) without Ewald)
    energy: torch.Tensor   # (C,)
    acc: torch.Tensor      # (C, 4) int32 [trans, rot, insert, delete]
    att: torch.Tensor      # (C, 4) int32


def _blocks(system):
    """(n_solvent, capacity) of an osmotic system, validated."""
    slices = system.species_slices
    if len(slices) != 2:
        raise ValueError("osmotic GCMC requires exactly two species blocks: "
                         "(solvent, n_solvent) + (solute, capacity); got "
                         f"{[s[0] for s in slices]}")
    ns, cap = (m1 - m0 for _, m0, m1, _, _ in slices)
    if ns < 1 or cap < 1:
        raise ValueError(f"need >= 1 solvent molecule and >= 1 solute slot "
                         f"(got {ns}, {cap}); with zero active molecules the "
                         "move pick would land on an inactive slot and "
                         "corrupt the carried state")
    return ns, cap


def make_gcmc_osmotic(system, params, activity, p_exchange=0.3,
                      dtype=torch.float64, chunk=8, n_orient=1, mega=None,
                      device="cuda", generator=None):
    """Build the osmotic-ensemble functions: (init, run_steps, full_energy).

    system: a System with exactly two species blocks, (solvent, count)
    then (solute, capacity), each internally uniform.  init(box, n_init,
    n_chains) -> OsmoticState (the first n_init solute slots active);
    run_steps(state, n_steps) -> state; full_energy(state) -> (energy (C,),
    sfac (C, K, 2)).  Exchange attempts split p_exchange equally between
    insertions and deletions.

    mega=True: displacement/rotation sweeps of solvent and solutes through
    the activity-masked whole-sweep kernel (one launch per species block),
    solute exchanges on plain steps (a p_exchange = 1 build); needs
    float32.  mega="full": the solute exchanges run in the solute block's
    launch (n_exch = (0, x_per)); needs n_orient = 1, 0 < p_exchange < 1, a
    charge-neutral solute and float32.  device: the card unless the caller
    passes "cpu"; generator: the torch.Generator behind every draw, seeded
    0 when None."""
    device, generator = check_device(device, generator)
    ns, cap = _blocks(system)
    ms = make_binary_slots(system, params, device, dtype, neutral=False)
    ev0, ev1 = ms.evs
    use_ewald = ms.use_ewald
    if use_ewald and abs(ev1.q_t_tot) > 1e-5:
        raise ValueError("ewald osmotic GCMC requires a charge-neutral "
                         f"solute (net charge {ev1.q_t_tot})")
    M, K = ms.M, ms.K
    (a0_s, a0_u), (P0, P1) = ms.a0s, ms.Ps
    beta = 1.0 / params.temperature
    z = float(activity)
    px = float(p_exchange)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    move_on = p_disp + p_rot > 0.0
    tiny = torch.finfo(dtype).tiny
    log_k = math.log(n_or)

    def rand(*shape):
        return rand_chains(shape, generator, dtype, device)

    def solvent_on(C):
        return torch.ones((C, ns), dtype=torch.bool, device=device)

    def draw(C):
        """The draws of one plain step of C chains, as the JAX step takes
        them from its key: the move type, the slot pick (also the deletion
        pick), one position draw (the displacement and the insertion
        position), the rotation's axis and angle, the insertion's and the
        deletion's trial orientations, the trial pick and the acceptance."""
        axis = randn_chains((C, 3), generator, dtype, device)
        return SimpleNamespace(
            u_move=rand(C), u_sel=rand(C), u_pos=rand(C, 3),
            axis=axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
            u_rot=rand(C), quats_ins=ms.trial_quats[1](generator, (C, n_or)),
            quats_del=ms.trial_quats[1](generator, (C, n_or - 1)),
            u_pick=rand(C), u_acc=rand(C))

    def _one_step(state, dr):
        """One displacement, rotation, solute insertion or solute deletion
        per chain on the draws dr (draw); where-selects only."""
        com, quat, coords, active = (state.com, state.quat, state.coords,
                                     state.active)
        box, sfac, e = state.box, state.sfac, state.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        n_u = active.sum(1)
        nf = n_u.to(dtype)
        n_s = torch.full_like(n_u, ns)
        # 0 disp, 1 rot, 2 insert, 3 delete
        mt = torch.where(
            dr.u_move < p_disp, 0, torch.where(
                dr.u_move < p_disp + p_rot, 1,
                torch.where(dr.u_move < p_disp + p_rot + 0.5 * px, 2, 3)))
        a_ok = ms.atom_ok_of(solvent_on(C), active)
        cf = ewald_ops.cfac_coeffs(ms.kv, ms.kw, params.kappa_L / box, box) \
            if use_ewald else None
        zero_s = torch.zeros((C, K, 2), dtype=dtype, device=device)

        # the pick among all active molecules (the solvent always active)
        csum = torch.cumsum(torch.cat([solvent_on(C), active], 1)
                            .to(torch.int64), dim=1)
        target = torch.floor(dr.u_sel * (nf + ns)).to(torch.int64) + 1
        idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
        is_solv = idx < ns
        com_i, quat_i = com[ar, idx], quat[ar, idx]
        if move_on:
            com_new = torch.where(
                (mt == 0)[:, None],
                torch.remainder(com_i + (dr.u_pos - 0.5) * params.dr_max,
                                box[:, None]), com_i)
            quat_new = torch.where(
                (mt == 1)[:, None],
                rotate_quaternion(quat_i, dr.axis, dr.u_rot,
                                  params.dphi_max), quat_i)
            per = []
            for ev in ms.evs:
                ra_o = ev.pose_atoms(com_i, quat_i)
                ra_n = ev.pose_atoms(com_new, quat_new)
                e2, o2 = ev.pair_energy(
                    torch.stack([com_i, com_new], 1),
                    torch.stack([ra_o, ra_n], 1), coords, com, box, a_ok, idx)
                s_o = ev.pose_sfac(ra_o, box) if use_ewald else zero_s
                s_n = ev.pose_sfac(ra_n, box) if use_ewald else zero_s
                per.append((ra_n, e2[:, 0], e2[:, 1], o2[:, 1], s_o, s_n))
            e_old, e_new, ovr_new, s_old, s_new = (
                torch.where(is_solv.reshape((C,) + (1,) * (x.dim() - 1)), x,
                            y) for x, y in zip(per[0][1:], per[1][1:]))
            du_move = e_new - e_old
            if use_ewald:
                du_move = du_move + ewald_ops.recip_energy_delta(
                    sfac, s_new - s_old, cf)

        # solute insertion (n_or trial orientations)
        com_ins = dr.u_pos * box[:, None]
        u_i, ovr_i, s_i = ms.pose_batch(1, com_ins, dr.quats_ins, coords, com,
                                        box, a_ok, -1, sfac, cf)
        slot = (~active).to(torch.int64).argmax(dim=1)
        m_i, w_i = ms.rosenbluth(torch.where(
            ovr_i, torch.full_like(u_i, -math.inf), -beta * u_i))
        w_sum_i = w_i.sum(1)
        j_sel = (torch.cumsum(w_i, 1) > (dr.u_pick * w_sum_i)[:, None]) \
            .to(torch.int64).argmax(dim=1)
        quat_ins = dr.quats_ins[ar, j_sel]
        ra_ins = ev1.pose_atoms(com_ins, quat_ins)
        ec_ins = ms.exchange_const(box, n_s, n_u, 1, +1.0)
        du_ins = u_i[ar, j_sel] + ec_ins

        # solute deletion (the existing orientation + n_or - 1 trials): a
        # pick among the active solutes on the move pick's uniform (the two
        # serve disjoint move types)
        ec_del = ms.exchange_const(box, n_s, n_u, 1, -1.0)
        csum_u = torch.cumsum(active.to(torch.int64), dim=1)
        t_u = torch.floor(dr.u_sel * nf).to(torch.int64) + 1
        slot_del = (csum_u >= t_u[:, None]).to(torch.int64).argmax(dim=1)
        com_d, quat_d = com[ar, ns + slot_del], quat[ar, ns + slot_del]
        ra_d = ev1.pose_atoms(com_d, quat_d)
        e_d, _ = ev1.pair_energy(com_d[:, None], ra_d[:, None], coords, com,
                                 box, a_ok, ns + slot_del)
        u_exist, s_d, sfac_wo = e_d[:, 0], zero_s, sfac
        if use_ewald:
            s_d = ev1.pose_sfac(ra_d, box)
            sfac_wo = sfac - s_d
            u_exist = u_exist + ewald_ops.recip_energy_delta(sfac_wo, s_d, cf)
        neg_d = (-beta * u_exist)[:, None]
        if n_or > 1:
            u_dd, ovr_dd, _ = ms.pose_batch(1, com_d, dr.quats_del, coords,
                                            com, box, a_ok, ns + slot_del,
                                            sfac_wo, cf)
            neg_d = torch.cat([neg_d, torch.where(
                ovr_dd, torch.full_like(u_dd, -math.inf), -beta * u_dd)], 1)
        m_d, w_d = ms.rosenbluth(neg_d)
        w_sum_d = w_d.sum(1)
        du_del = -u_exist + ec_del

        # acceptance, in log space for the exchanges
        vol = box ** 3
        ln_u = torch.log(torch.clamp_min(dr.u_acc, tiny))
        ok_m = torch.zeros((C,), dtype=torch.bool, device=device)
        if move_on:
            ok_m = (mt <= 1) & ~ovr_new \
                & (dr.u_acc < torch.exp(-beta * du_move))
        ln_acc_i = torch.log(z * vol / (nf + 1.0)) + m_i \
            + torch.log(torch.clamp_min(w_sum_i, tiny)) - log_k \
            - beta * ec_ins
        ok_i = (mt == 2) & (n_u < cap) & (w_sum_i > 0.0) & (ln_u < ln_acc_i)
        ln_acc_d = torch.log(torch.clamp_min(nf, 1.0) / (z * vol)) + log_k \
            - m_d - torch.log(torch.clamp_min(w_sum_d, tiny)) - beta * ec_del
        ok_d = (mt == 3) & (n_u > 0) & (ln_u < ln_acc_d)

        # apply (the branches exclude each other)
        com, quat = com.clone(), quat.clone()
        if move_on:
            com[ar, idx] = torch.where(ok_m[:, None], com_new, com_i)
            quat[ar, idx] = torch.where(ok_m[:, None], quat_new, quat_i)
            coords = ms.write_pose(
                coords, torch.where(is_solv, a0_s + idx * P0, 0), P0,
                per[0][0], ok_m & is_solv)
            coords = ms.write_pose(
                coords, torch.where(is_solv, 0, a0_u + (idx - ns) * P1), P1,
                per[1][0], ok_m & ~is_solv)
        com[ar, ns + slot] = torch.where(ok_i[:, None], com_ins,
                                         com[ar, ns + slot])
        quat[ar, ns + slot] = torch.where(ok_i[:, None], quat_ins,
                                          quat[ar, ns + slot])
        coords = ms.write_pose(coords, a0_u + slot * P1, P1, ra_ins, ok_i)
        active = clear_slot(set_slot(active, slot, ok_i), slot_del, ok_d)
        sfac = sfac + ok_i.to(dtype)[:, None, None] * s_i[ar, j_sel] \
            - ok_d.to(dtype)[:, None, None] * s_d
        e = e + torch.where(ok_i, du_ins, 0.0) + torch.where(ok_d, du_del,
                                                             0.0)
        if move_on:
            sfac = sfac + ok_m.to(dtype)[:, None, None] * (s_new - s_old)
            e = e + torch.where(ok_m, du_move, 0.0)
        a_row = torch.stack([ok_m & (mt == 0), ok_m & (mt == 1), ok_i, ok_d],
                            1)
        t_row = torch.arange(4, device=device)[None, :] == mt[:, None]
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords, active=active,
            sfac=sfac, energy=e, acc=state.acc + a_row.to(torch.int32),
            att=state.att + t_row.to(torch.int32))

    def _full_one(com, quat, coords, active, box):
        return ms.full_one(com, quat, coords, solvent_on(com.shape[0]),
                           active, box)

    def full_energy(state):
        return chunked_map(_full_one, chunk, state.com, state.quat,
                           state.coords, state.active, state.box)

    def run_steps(state, n_steps):
        C = state.com.shape[0]
        for _ in range(int(n_steps)):
            state = _one_step(state, draw(C))
        return state

    run_steps.step = _one_step
    run_steps.draw = draw

    if mega:
        if dtype != torch.float32:
            raise ValueError("mega osmotic GCMC requires dtype=float32 (the "
                             "whole-sweep kernel is f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        if px >= 1.0:
            raise ValueError("mega osmotic GCMC needs p_exchange < 1")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc.moves import make_mega_sweep_fn

        def _with_solvent(active):
            return torch.cat([solvent_on(active.shape[0]), active], 1)

    if mega == "full":
        if not 0.0 < px < 1.0:
            raise ValueError("mega='full' needs 0 < p_exchange < 1")
        if n_or != 1:
            raise ValueError("in-kernel exchanges run the unbiased algorithm "
                             "(n_orient=1); use mega=True for Rosenbluth-"
                             "biased exchanges")
        if ev1.q_t_tot ** 2 != 0.0:
            raise ValueError("in-kernel osmotic exchanges require a charge-"
                             "neutral solute (the global charge term couples "
                             "to the solvent)")
        x_per = max(1, int(round(M * px / (1.0 - px))))
        sweep_x = make_mega_sweep_fn(system, params, ms.kvecs, ms.kweights,
                                     device, with_activity=True,
                                     n_exch=(0, x_per))

        def _cycle_full(state):
            C = state.com.shape[0]
            zeros = torch.zeros((C,), dtype=torch.float32, device=device)
            si1 = ev1.self_intra(state.box)
            wc1 = zeros
            if ms.use_lrc:
                # the solute-solute tail on the wc lane; the solvent cross
                # term 2 g_uv ns is a constant of the fixed solvent count
                g = ms.lrc_gmat(state.box)
                si1 = si1 + 2.0 * ns * g[:, 1, 0]
                wc1 = g[:, 1, 1]
            com, quat, coords, active_o, sfac_o, d_e, acc6, att6 = sweep_x(
                state.com, state.quat, state.coords,
                _with_solvent(state.active), state.box, state.sfac, generator,
                (zeros, torch.full_like(zeros, z)), (zeros, si1),
                (zeros, wc1))
            sel = [0, 1, 4, 5]             # [trans, rot, insert1, delete1]
            return dataclasses.replace(
                state, com=com.to(dtype), quat=quat.to(dtype),
                coords=coords.to(dtype), active=active_o[:, ns:],
                sfac=sfac_o.to(dtype) if use_ewald else state.sfac,
                energy=state.energy + d_e.to(dtype),
                acc=state.acc + acc6[:, sel].to(torch.int32),
                att=state.att + att6[:, sel].to(torch.int32))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (M + x_per))))):
                state = _cycle_full(state)
            return state

        run_steps.cycle = _cycle_full
        run_steps.x_per = x_per

    elif mega:
        sweep_act = make_mega_sweep_fn(system, params, ms.kvecs, ms.kweights,
                                       device, with_activity=True)
        if px > 0.0:
            run_x = make_gcmc_osmotic(system, params, activity, 1.0, dtype,
                                      chunk, n_orient, device=device,
                                      generator=generator)[1]
            x_per = max(1, int(round(M * px / (1.0 - px))))
        else:
            run_x, x_per = None, 0

        def _sweep_state(state):
            com, quat, coords, sfac, d_e, acc2, att2 = sweep_act(
                state.com, state.quat, state.coords,
                _with_solvent(state.active), state.box, state.sfac,
                generator)
            pad = torch.nn.functional.pad
            return dataclasses.replace(
                state, com=com.to(dtype), quat=quat.to(dtype),
                coords=coords.to(dtype),
                sfac=sfac.to(dtype) if use_ewald else state.sfac,
                energy=state.energy + d_e.to(dtype),
                acc=state.acc + pad(acc2.to(torch.int32), (0, 2)),
                att=state.att + pad(att2.to(torch.int32), (0, 2)))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (M + x_per))))):
                state = _sweep_state(state)
                if run_x is not None:
                    state = run_x(state, x_per)
            return state

        run_steps.sweep = _sweep_state

    def init(box, n_init, n_chains):
        """Lattice placement of all M = n_solvent + capacity slots; the
        first n_init solute slots start active."""
        if n_init > cap:
            raise ValueError("n_init exceeds solute capacity")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-image "
                             "(set strict_min_image=False to sample the "
                             "truncated model)")
        com, quat, coords = ms.pose_lattice_init(generator, box, n_chains)
        state = OsmoticState(
            com=com, quat=quat, coords=coords,
            active=(torch.arange(cap, device=device) < int(n_init))[None]
            .expand(n_chains, cap).contiguous(),
            box=torch.full((n_chains,), float(box), dtype=dtype,
                           device=device),
            sfac=torch.zeros((n_chains, K, 2), dtype=dtype, device=device),
            energy=torch.zeros((n_chains,), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 4), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 4), dtype=torch.int32, device=device))
        e, sf = full_energy(state)
        return dataclasses.replace(state, energy=e, sfac=sf)

    return init, run_steps, full_energy


class OsmoticGCMC:
    """The osmotic app as a class: blocks with the drift invariant and
    solute-N statistics.

    >>> g = OsmoticGCMC(two_species_system, params, activity=1e-3)
    >>> st = g.init(box=20.0, n_init=4, n_chains=64)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, activity, p_exchange=0.3,
                 dtype=torch.float64, chunk=8, n_orient=1, mega=None,
                 device="cuda", generator=None):
        self.params = params
        self._init, self.run_steps, self.full_energy = make_gcmc_osmotic(
            system, params, activity, p_exchange, dtype, chunk, n_orient,
            mega=mega, device=device, generator=generator)
        self.n_solvent, self.capacity = _blocks(system)
        self._system = system

    def init(self, box, n_init, n_chains):
        return self._init(box, n_init, n_chains)

    def atom_mask(self, state):
        """(C, A_pad) per-atom activity mask (for the masked RDF): solvent
        columns always on, solute columns by slot activity."""
        on = torch.ones(state.active.shape[:-1] + (self.n_solvent,),
                        dtype=torch.bool, device=state.active.device)
        return binary_atom_ok(self._system, on, state.active)

    def run_block(self, state, n_steps, drift_tol=None):
        """run_steps, then the block-end resync: the carried energies and
        S(k) are replaced by a recompute, after the drift between the two is
        measured (scaled by both block endpoints)."""
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e, sf = self.full_energy(state)
        scale = torch.clamp_min(torch.maximum(e.abs(), e_start.abs()), 1.0)
        drift = torch.max((e - state.energy).abs() / scale)
        sfac_err = torch.max((sf - state.sfac).abs())
        n = state.active.sum(1).to(torch.float64)
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "n_mean": float(n.mean()),
            "n_var": float(n.var(unbiased=False)),
            "full_frac": float((n >= self.capacity).to(torch.float64).mean()),
            "energy_mean": float(e.mean()),
            "acc_trans": float(ratio[:, 0].mean()),
            "acc_rot": float(ratio[:, 1].mean()),
            "acc_insert": float(ratio[:, 2].mean()),
            "acc_delete": float(ratio[:, 3].mean()),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and math.isfinite(stats["energy_mean"])):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e, sfac=sf), stats
