"""Gibbs-ensemble MC for the monatomic LJ fluid: two-box vapour-liquid
coexistence (counterpart of metropolismontecarlo_tpu/mc/gibbs.py;
Panagiotopoulos 1987, Frenkel & Smit ch. 8).

Every chain carries two boxes exchanging particles and volume at fixed
total N and V.  Moves and acceptance rules:

    displace (p_translate):  Metropolis in a random box;
    volume (every round(1/p_volume) steps, a deterministic cycle as in
        mc/npt.py):  dV moves from one box to the other, both boxes
        rescaled and recomputed, min[1, (V1'/V1)^N1 (V2'/V2)^N2
        exp(-beta dU)]; a volume below 2 r_cut in either box is refused;
    transfer (the rest):  a random particle of box s leaves, one enters
        box d at a uniform position,
        min[1, N_s V_d / ((N_d + 1) V_s) exp(-beta dU)].

Fixed-capacity slots per box with activity masks, shared with the muVT
app (`mc/gcmc.make_slot_lj`).  Two routes: None (plain tensor code, one
attempt of every chain per step, float64) and mega=True (cycles of one
activity-masked sweep-kernel sweep of both boxes, folded over the chain
axis, plus x_per transfer/volume plain steps).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.gcmc import (
    capacity_system,
    check_device,
    make_slot_lj,
)
from metropolismontecarlo_tpu_torch.ops.pbc import cube_root
from metropolismontecarlo_tpu_torch.utils.activity import (
    clear_slot2,
    set_slot2,
)
from metropolismontecarlo_tpu_torch.utils.shard import rand_chains


@dataclasses.dataclass
class GibbsState:
    """Per-chain two-box monatomic state (the JAX state's `key` has no
    counterpart: draws come from make_gibbs's torch.Generator)."""

    com: torch.Tensor      # (C, 2, cap, 3) slot positions per box
    active: torch.Tensor   # (C, 2, cap) bool
    box: torch.Tensor      # (C, 2) box edge lengths
    energy: torch.Tensor   # (C, 2) carried per-box energies
    acc: torch.Tensor      # (C, 3) int32 accepted [disp, volume, transfer]
    att: torch.Tensor      # (C, 3) int32 attempted


def make_gibbs(system, params, capacity, dv_max=0.05, dtype=torch.float64,
               mega=None, device="cuda", generator=None):
    """Build the monatomic Gibbs-ensemble functions: (init, run_steps,
    full_energy, widom_boltzmann).

    init(boxes, n_init, n_chains) -> GibbsState (lattice slots, the first
    n_init[b] of box b active); run_steps(state, n_steps) -> state;
    full_energy(state) -> (C, 2); widom_boltzmann(state, n) -> (C, 2) mean
    exp(-beta dU_test) per box.  The plain route's run_steps also carries
    run_steps.cheap_step(state, draws) (draws: run_steps.draw_cheap(C))
    and run_steps.volume_step(state, u_dv, u_acc).  dv_max: the volume
    move's half-width as a fraction of the total volume.  mega=True:
    displacement sweeps through the activity-masked kernel (a capacity-
    sized copy of the system, identity quaternions), transfers and volume
    moves plain; needs float32.  device: the card unless the caller passes
    "cpu"; generator: the torch.Generator behind every draw, seeded 0 when
    None."""
    device, generator = check_device(device, generator)
    beta = 1.0 / params.temperature
    p_t = float(params.p_translate)
    p_v = float(params.p_volume)
    cap = int(capacity)
    rc = float(params.r_cut)
    site_energy, full_one, nth_active, lrc_g = make_slot_lj(
        system, params, cap, dtype, device)
    # volume moves on a deterministic cycle (mc/npt.py); within the cheap
    # steps displacement has the conditional probability p_t / (1 - p_v)
    p_disp = p_t / (1.0 - p_v) if p_v < 1.0 else 1.0
    move_on = p_disp > 0.0

    def rand(*shape, fold=1):
        return rand_chains(shape, generator, dtype, device, fold)

    def full_energy(state):
        C = state.com.shape[0]
        return full_one(state.com.reshape(2 * C, cap, 3),
                        state.active.reshape(2 * C, cap),
                        state.box.reshape(2 * C)).reshape(C, 2)

    def draw_cheap(C):
        """One cheap step's draws, as the JAX step takes them from its key:
        the move type, the box bit, the slot pick, one position draw (the
        displacement and the insertion position) and the acceptance."""
        return SimpleNamespace(u_move=rand(C), bit=rand(C) < 0.5,
                               u_sel=rand(C), u_pos=rand(C, 3),
                               u_acc=rand(C))

    def _cheap_step(state, dr):
        """A displacement or a transfer of every chain on the draws dr."""
        com, active, box, e = state.com, state.active, state.box, \
            state.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        n = active.sum(2)
        nf = n.to(dtype)
        v = box ** 3
        mt = torch.where(dr.u_move < p_disp, 0, 2)
        b = dr.bit.to(torch.int64)
        d = 1 - b
        com_b, act_b, box_b = com[ar, b], active[ar, b], box[ar, b]
        com_d, act_d, box_d = com[ar, d], active[ar, d], box[ar, d]
        n_b, n_d, nf_b, nf_d = n[ar, b], n[ar, d], nf[ar, b], nf[ar, d]

        idx = nth_active(act_b, torch.floor(dr.u_sel * n_b).to(torch.int64))
        pos_old = com_b[ar, idx]
        u_old = site_energy(com_b, act_b, box_b, pos_old, idx)
        if move_on:
            new_pos = torch.remainder(
                pos_old + (dr.u_pos - 0.5) * params.dr_max, box_b[:, None])
            u_new = site_energy(com_b, act_b, box_b, new_pos, idx)
            ok_t = (mt == 0) & (n_b > 0) \
                & (dr.u_acc < torch.exp(-beta * (u_new - u_old)))
        else:
            ok_t = torch.zeros((C,), dtype=torch.bool, device=device)

        # transfer b -> d; the per-box LJ tail deltas (U_lrc = g(box) N^2)
        # depend on each box and do not cancel
        pos_d = dr.u_pos * box_d[:, None]
        u_in = site_energy(com_d, act_d, box_d, pos_d, -1)
        slot_d = (~act_d).to(torch.int64).argmax(dim=1)
        if lrc_g is not None:
            dl_in = lrc_g(box_d) * (2.0 * nf_d + 1.0)
            dl_rm = lrc_g(box_b) * (-2.0 * nf_b + 1.0)
        else:
            dl_in = dl_rm = torch.zeros_like(u_in)
        a_x = nf_b * v[ar, d] / ((nf_d + 1.0) * v[ar, b]) \
            * torch.exp(-beta * (u_in + dl_in - u_old + dl_rm))
        ok_x = (mt == 2) & (n_b > 0) & (n_d < cap) & (dr.u_acc < a_x)

        com, e = com.clone(), e.clone()
        zero = torch.zeros_like(u_old)
        if move_on:
            com[ar, b, idx] = torch.where(ok_t[:, None], new_pos, pos_old)
            e[ar, b] = e[ar, b] + torch.where(ok_t, u_new - u_old, zero)
        com[ar, d, slot_d] = torch.where(ok_x[:, None], pos_d,
                                         com[ar, d, slot_d])
        active = clear_slot2(set_slot2(active, d, slot_d, ok_x), b, idx,
                             ok_x)
        e[ar, d] = e[ar, d] + torch.where(ok_x, u_in + dl_in, zero)
        e[ar, b] = e[ar, b] + torch.where(ok_x, -u_old + dl_rm, zero)
        a_row = torch.stack([ok_t, torch.zeros_like(ok_t), ok_x], 1)
        t_row = torch.arange(3, device=device)[None, :] == mt[:, None]
        return dataclasses.replace(
            state, com=com, active=active, energy=e,
            acc=state.acc + a_row.to(torch.int32),
            att=state.att + t_row.to(torch.int32))

    def _vol_step(state, u_dv, u_acc):
        """Volume transfer on the uniforms u_dv, u_acc (C,), with the
        dense recompute of both boxes."""
        box, e = state.box, state.energy
        nf = state.active.sum(2).to(dtype)
        v = box ** 3
        dv = (u_dv - 0.5) * 2.0 * dv_max * v.sum(1)
        v_new = v + torch.stack([dv, -dv], 1)
        box_new = cube_root(v_new)         # batch-invariant (ops/pbc.py)
        legal = (box_new > 2.0 * rc).all(1)
        scale = torch.where(legal[:, None], box_new / box, 1.0)
        com_v = state.com * scale[:, :, None, None]
        e_v = full_energy(dataclasses.replace(
            state, com=com_v, box=torch.where(legal[:, None], box_new, box)))
        log_a = (nf * torch.log(torch.where(legal[:, None], v_new / v,
                                            1.0))).sum(1) \
            - beta * (e_v - e).sum(1)
        tiny = torch.finfo(dtype).tiny
        ok = legal & (torch.log(torch.clamp_min(u_acc, tiny)) < log_a)
        okc = ok[:, None]
        acc, att = state.acc.clone(), state.att.clone()
        acc[:, 1] += ok.to(torch.int32)
        att[:, 1] += 1
        return dataclasses.replace(
            state, com=torch.where(okc[..., None, None], com_v, state.com),
            box=torch.where(okc, box_new, box),
            energy=torch.where(okc, e_v, e), acc=acc, att=att)

    period = int(round(1.0 / p_v)) if p_v > 0 else 0

    def run_steps(state, n_steps):
        C = state.com.shape[0]
        n_cycles, rem = divmod(int(n_steps), period) if period > 0 \
            else (0, int(n_steps))
        for _ in range(n_cycles):
            for _ in range(period - 1):
                state = _cheap_step(state, draw_cheap(C))
            u = rand(C, 2)
            state = _vol_step(state, u[:, 0], u[:, 1])
        for _ in range(rem):
            state = _cheap_step(state, draw_cheap(C))
        return state

    run_steps.cheap_step = _cheap_step
    run_steps.draw_cheap = draw_cheap
    run_steps.volume_step = _vol_step

    if mega:
        if mega is not True:
            raise ValueError(f"mega must be True: {mega!r}")
        if dtype != torch.float32:
            raise ValueError("mega Gibbs requires dtype=float32 (the "
                             "whole-sweep kernel is f32)")
        if not 0.0 < p_disp < 1.0:
            raise ValueError("mega Gibbs needs 0 < p_translate < 1 - "
                             "p_volume")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc.moves import make_mega_sweep_fn

        cap_sys = capacity_system(system, cap)
        A_pad = cap_sys.n_atoms_padded
        sweep_act = make_mega_sweep_fn(cap_sys, params, None, None, device,
                                       with_activity=True)
        x_per = max(1, int(round(2 * cap * (1.0 - p_disp) / p_disp)))
        p_v_x = min(1.0, p_v * (2 * cap + x_per) / x_per) if p_v > 0 \
            else 0.0
        run_x = make_gibbs(system, dataclasses.replace(
            params, p_translate=0.0, p_volume=p_v_x), cap, dv_max, dtype,
            device=device, generator=generator)[1]
        f32 = torch.float32

        def _sweep_state(state):
            """The kernel's molecular layout of both boxes' slots (folded
            over the chain axis): identity quaternions, the positions as
            the atom planes, a dummy S(k) row."""
            C2 = 2 * state.com.shape[0]
            com2 = state.com.reshape(C2, cap, 3).to(f32)
            quat = torch.zeros((C2, cap, 4), dtype=f32, device=device)
            quat[..., 0] = 1.0
            coords = torch.nn.functional.pad(com2.transpose(1, 2),
                                             (0, A_pad - cap))
            com, _, _, _, d_e, acc2, att2 = sweep_act(
                com2, quat, coords.contiguous(),
                state.active.reshape(C2, cap), state.box.reshape(C2).to(f32),
                torch.zeros((C2, 1, 2), dtype=f32, device=device), generator)
            pad = torch.nn.functional.pad
            C = C2 // 2
            return dataclasses.replace(
                state, com=com.reshape(C, 2, cap, 3).to(dtype),
                energy=state.energy + d_e.reshape(C, 2).to(dtype),
                acc=state.acc + pad(acc2.reshape(C, 2, 2).sum(1)[:, :1]
                                    .to(torch.int32), (0, 2)),
                att=state.att + pad(att2.reshape(C, 2, 2).sum(1)[:, :1]
                                    .to(torch.int32), (0, 2)))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (2 * cap + x_per))))):
                state = run_x(_sweep_state(state), x_per)
            return state

        run_steps.sweep = _sweep_state

    def init(boxes, n_init, n_chains):
        """boxes (2,) edge lengths; n_init (2,) actives per box."""
        n_init = np.asarray(n_init, np.int64)
        if np.any(n_init > cap):
            raise ValueError("n_init exceeds capacity")
        # lattice starts per box (random placement seeds overlapping pairs
        # whose huge energies cancel imperfectly against the carried one)
        lat = torch.stack([torch.tensor(cubic_lattice(cap, float(bl)),
                                        dtype=dtype, device=device)
                           for bl in np.asarray(boxes)])       # (2, cap, 3)
        active = torch.arange(cap, device=device)[None, :] \
            < torch.as_tensor(n_init, device=device)[:, None]
        state = GibbsState(
            com=lat[None].expand(n_chains, 2, cap, 3).contiguous(),
            active=active[None].expand(n_chains, 2, cap).contiguous(),
            box=torch.tensor(np.asarray(boxes, np.float64), dtype=dtype,
                             device=device)[None].expand(n_chains, 2)
            .contiguous(),
            energy=torch.zeros((n_chains, 2), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 3), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 3), dtype=torch.int32, device=device))
        return dataclasses.replace(state, energy=full_energy(state))

    def widom_boltzmann(state, n_insertions):
        """(C, 2) mean exp(-beta dU_test) per box over n_insertions uniform
        test particles (the mu-equality diagnostic)."""
        C = state.com.shape[0]
        n = int(n_insertions)
        B = 2 * C * n
        # box-folded rows, two per chain (chain-global under a shard
        # context)
        pos = rand(2 * C, n, 3, fold=2) \
            * state.box.reshape(2 * C)[:, None, None]
        du = site_energy(
            state.com.reshape(2 * C, 1, cap, 3).expand(2 * C, n, cap, 3)
            .reshape(B, cap, 3),
            state.active.reshape(2 * C, 1, cap).expand(2 * C, n, cap)
            .reshape(B, cap),
            state.box.reshape(2 * C, 1).expand(2 * C, n).reshape(B),
            pos.reshape(B, 3), -1)
        return torch.exp(-beta * du).reshape(C, 2, n).mean(-1)

    return init, run_steps, full_energy, widom_boltzmann


class GibbsEnsemble:
    """The monatomic Gibbs app as a class: blocks with the drift invariant
    and phase statistics.

    >>> g = GibbsEnsemble(lj_system(1), params, capacity=256)
    >>> st = g.init(boxes=(9.0, 9.0), n_init=(128, 128), n_chains=16)
    >>> st, stats = g.run_block(st, 20_000)
    """

    def __init__(self, system, params, capacity, dv_max=0.05,
                 dtype=torch.float64, mega=None, device="cuda",
                 generator=None):
        self.params = params
        self.capacity = int(capacity)
        (self._init, self.run_steps, self.full_energy,
         self.widom_boltzmann) = make_gibbs(system, params, capacity,
                                            dv_max, dtype, mega, device,
                                            generator)

    def init(self, boxes, n_init, n_chains):
        return self._init(boxes, n_init, n_chains)

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e = self.full_energy(state)
        # both-endpoint drift scale (see mc/gcmc_mol.MolGCMC.run_block)
        scale = torch.clamp_min(torch.maximum(e.abs(), e_start.abs()), 1.0)
        drift = torch.max((e - state.energy).abs() / scale)
        n = state.active.sum(2).to(torch.float64)                # (C, 2)
        rho = n / state.box.to(torch.float64) ** 3
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        # the denser box of each chain is its liquid (boxes can swap roles
        # chain to chain)
        stats = {
            "n_mean": [float(x) for x in n.mean(0)],
            "rho_liq": float(rho.max(1).values.mean()),
            "rho_vap": float(rho.min(1).values.mean()),
            "full_frac": float((n >= self.capacity).to(torch.float64)
                               .mean()),
            "acc_disp": float(ratio[:, 0].mean()),
            "acc_vol": float(ratio[:, 1].mean()),
            "acc_transfer": float(ratio[:, 2].mean()),
            "drift_max_rel": float(drift),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and bool(torch.isfinite(e).all())):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e), stats
