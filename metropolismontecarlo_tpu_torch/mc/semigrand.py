"""Semigrand-canonical MC: identity flips between two species at fixed
total N, N_tot V T Delta-mu (counterpart of
metropolismontecarlo_tpu/mc/semigrand.py).

A molecule changes species in place, controlled by the fugacity ratio
xi = f_B / f_A = exp(beta Delta-mu).  Flip acceptance for a uniformly
picked active molecule (the reverse move picks the same molecule, so no
N-ratio factors appear):

    A -> B:  min[1, xi   exp(-beta dU)]
    B -> A:  min[1, 1/xi exp(-beta dU)]

The new identity sits at the same center of mass in a fresh uniform
orientation (optionally n_orient Rosenbluth trials, as in mc/gcmc_mol.py;
the old identity's reverse set completes with n_orient - 1 trials).  In
the ideal-gas limit, and for physically identical species at any
interaction strength, N_B ~ Binomial(N_tot, xi / (1 + xi)).

Slot design: a two-species-block System whose blocks both have at least
N_tot slots; per-slot activity masks with sum(active) = N_tot conserved; a
flip deactivates the molecule's slot and activates the first free slot of
the other block at the same COM.  The slot machinery, the recompute and the
LJ tail coefficients are mc/gcmc_binary.make_binary_slots'.

Three routes, chosen by `mega`:
  None    one attempt of every chain per step in plain tensor code
          (displacement, rotation or flip; float64; Rosenbluth-biased
          flips); the step takes its draws explicitly:
          run_steps.step(state, draws), draws from run_steps.draw(C);
  True    cycles of one activity-masked sweep-kernel sweep (one launch per
          species block) plus x_per flip-only plain steps;
  "full"  cycles of the same sweep launches plus one flip-op launch of
          x_per flips (ops/cuda/flip_kernel.py, mc/moves.make_mega_flip_fn).
On CPU tensors the kernel routes run the kernels' plain versions.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.gcmc import check_device
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import make_binary_slots
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import (
    make_trial_quats,
    rosenbluth,
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
class SemigrandState:
    """Per-chain semigrand state; every tensor leads with the chains axis C.
    The JAX state's `key` has no counterpart: draws come from the
    torch.Generator that make_semigrand holds."""

    com: torch.Tensor      # (C, M, 3)  M = cap_A + cap_B slots
    quat: torch.Tensor     # (C, M, 4)
    coords: torch.Tensor   # (C, 3, A_pad)
    active: torch.Tensor   # (C, M) bool; sum per chain = N_tot (conserved)
    box: torch.Tensor      # (C,)
    sfac: torch.Tensor     # (C, K, 2) ((C, 1, 2) without Ewald)
    energy: torch.Tensor   # (C,)
    acc: torch.Tensor      # (C, 4) int32 [disp, rot, flip A->B, flip B->A]
    att: torch.Tensor      # (C, 4) int32


def make_semigrand(system, params, fugacity_ratio, p_flip=0.3,
                   dtype=torch.float64, chunk=8, n_orient=1, mega=None,
                   device="cuda", generator=None):
    """Build the semigrand functions: (init, run_steps, full_energy).

    system: a System with exactly two species blocks (A then B), each
    internally uniform, whose block counts are slot capacities, each at
    least the total N chosen at init.  fugacity_ratio: xi = f_B / f_A.
    init(box, n_a, n_b, n_chains) -> SemigrandState; run_steps(state,
    n_steps) -> state; full_energy(state) -> (energy (C,), sfac (C, K, 2)).

    mega=True: displacement/rotation sweeps through the activity-masked
    whole-sweep kernel (one launch per species block), flips on plain steps
    (a p_flip = 1 build).  mega="full": the flips run in the flip kernel
    too, x_per = round(M p_flip / (1 - p_flip)) per cycle in one launch;
    needs n_orient = 1, 0 < p_flip < 1 and lj_shift 'none'.  Both need
    float32.  device: the card unless the caller passes "cpu"; generator:
    the torch.Generator behind every draw, seeded 0 when None."""
    device, generator = check_device(device, generator)
    ms = make_binary_slots(system, params, device, dtype, neutral=False)
    ev0, ev1 = ms.evs
    if ms.use_ewald and abs(ev1.q_t_tot - ev0.q_t_tot) > 1e-5:
        raise ValueError(
            "ewald semigrand requires equal species net charges (a flip "
            f"would change the background; got {ev0.q_t_tot} vs "
            f"{ev1.q_t_tot})")
    if params.coulomb == "wolf" and params.wolf_style != "pairwise" \
            and abs(ev1.q_t_tot - ev0.q_t_tot) > 1e-5:
        raise ValueError("reference-Wolf semigrand requires equal species "
                         "net charges (the global c*Q^2 term would change "
                         "per flip)")
    cap_a, cap_b = ms.caps
    P0, P1 = ms.Ps
    M, K, use_ewald = ms.M, ms.K, ms.use_ewald
    beta = 1.0 / params.temperature
    ln_xi = float(np.log(fugacity_ratio))
    px = float(p_flip)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    move_on = p_disp + p_rot > 0.0
    tiny = torch.finfo(dtype).tiny
    ones4 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    trials = make_trial_quats(max(P0, P1), dtype)

    def species_quats(q, s):
        """Trial orientations of species s from the shared draws (the JAX
        step draws both species' trials from one key): the identity for a
        one-site species."""
        return q if ms.Ps[s] > 1 else ones4.expand(q.shape).clone()

    def lrc3_of(box):
        """(C, 3) the tail's flip coefficients [g c00, g c01, g c11]."""
        g = ms.lrc_gmat(box)
        return torch.stack([g[:, 0, 0], g[:, 0, 1], g[:, 1, 1]], 1)

    def rand(*shape):
        return rand_chains(shape, generator, dtype, device)

    def draw(C):
        """The draws of one plain step of C chains, as the JAX step takes
        them from its key: the move type, the slot pick, the displacement,
        the rotation's axis and angle, the new identity's trial
        orientations, the old identity's extra trials, the trial pick and
        the acceptance."""
        axis = randn_chains((C, 3), generator, dtype, device)
        return SimpleNamespace(
            u_move=rand(C), u_sel=rand(C), u_pos=rand(C, 3),
            axis=axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
            u_rot=rand(C), quats_new=trials(generator, (C, n_or)),
            quats_old=trials(generator, (C, n_or - 1)), u_pick=rand(C),
            u_acc=rand(C))

    def _one_step(state, dr):
        """One displacement, rotation or identity flip of every chain on
        the draws dr (draw); where-selects only."""
        com, quat, coords, active = (state.com, state.quat, state.coords,
                                     state.active)
        box, sfac, e = state.box, state.sfac, state.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        n_tot = active.sum(1)
        # 0 displace, 1 rotate, 2 identity flip (direction: the picked
        # molecule's species)
        mt = torch.where(dr.u_move < p_disp, 0,
                         torch.where(dr.u_move < p_disp + p_rot, 1, 2))
        act_a, act_b = active[:, :cap_a], active[:, cap_a:]
        a_ok = ms.atom_ok_of(act_a, act_b)

        # the pick among all active molecules
        csum = torch.cumsum(active.to(torch.int64), dim=1)
        target = torch.floor(dr.u_sel * n_tot.to(dtype)).to(torch.int64) + 1
        idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
        is_a = idx < cap_a
        com_i, quat_i = com[ar, idx], quat[ar, idx]
        cf = ewald_ops.cfac_coeffs(ms.kv, ms.kw, params.kappa_L / box, box) \
            if use_ewald else None
        zero_s = torch.zeros((C, K, 2), dtype=dtype, device=device)

        def sel(x, y):
            return torch.where(is_a.reshape((C,) + (1,) * (x.dim() - 1)),
                               x, y)

        # the old pose per species (the flip source needs it in flip-only
        # builds too) and, with moves on, the displaced / rotated one
        com_new = quat_new = None
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
            coms, ras = [com_i], [ra_o]
            if move_on:
                ra_n = ev.pose_atoms(com_new, quat_new)
                coms.append(com_new)
                ras.append(ra_n)
            e2, o2 = ev.pair_energy(torch.stack(coms, 1), torch.stack(ras, 1),
                                    coords, com, box, a_ok, idx)
            s_o = ev.pose_sfac(ra_o, box) if use_ewald else zero_s
            if move_on:
                s_n = ev.pose_sfac(ra_n, box) if use_ewald else zero_s
                per.append((e2[:, 0], s_o, ra_n, e2[:, 1], o2[:, 1], s_n))
            else:
                per.append((e2[:, 0], s_o))
        e_old, s_old = sel(per[0][0], per[1][0]), sel(per[0][1], per[1][1])
        if move_on:
            e_new, ovr_new, s_new = (sel(per[0][i], per[1][i])
                                     for i in (3, 4, 5))
            du_move = e_new - e_old
            if use_ewald:
                du_move = du_move + ewald_ops.recip_energy_delta(
                    sfac, s_new - s_old, cf)

        # the flip at the same COM: the old identity's existing orientation
        # + n_or - 1 trials (recip against sfac - s_old), the new identity's
        # n_or trials
        sfac_wo = sfac - s_old if use_ewald else sfac
        u_exist = e_old
        if use_ewald:
            u_exist = u_exist + ewald_ops.recip_energy_delta(sfac_wo, s_old,
                                                             cf)
        neg_o = (-beta * u_exist)[:, None]
        if n_or > 1:
            u_o, ov_o = (sel(x, y) for x, y in zip(*(
                ms.pose_batch(s, com_i, species_quats(dr.quats_old, s),
                              coords, com, box, a_ok, idx, sfac_wo, cf)[:2]
                for s in (0, 1))))
            neg_o = torch.cat([neg_o, torch.where(
                ov_o, torch.full_like(u_o, -math.inf), -beta * u_o)], 1)
        m_o, w_o = rosenbluth(neg_o)
        w_sum_o = w_o.sum(1)
        # the new identity is the other species: A -> B uses species 1
        q_new = [species_quats(dr.quats_new, s) for s in (0, 1)]
        trial = [ms.pose_batch(s, com_i, q_new[s], coords, com, box, a_ok,
                               idx, sfac_wo, cf) for s in (0, 1)]
        u_n, ov_n, s_n_tr = (sel(y, x) for x, y in zip(*trial))
        q_n_tr = sel(q_new[1], q_new[0])
        m_n, w_n = rosenbluth(torch.where(
            ov_n, torch.full_like(u_n, -math.inf), -beta * u_n))
        w_sum_n = w_n.sum(1)
        j_sel = (torch.cumsum(w_n, 1) > (dr.u_pick * w_sum_n)[:, None]) \
            .to(torch.int64).argmax(dim=1)
        quat_flip = q_n_tr[ar, j_sel]
        s_flip = s_n_tr[ar, j_sel]
        c0, c1 = ev0.self_intra(box), ev1.self_intra(box)
        dconst = torch.where(is_a, c1 - c0, c0 - c1)
        if ms.use_lrc:
            # the tail's flip delta, affine in the live per-species counts
            n_a, n_b = act_a.sum(1).to(dtype), act_b.sum(1).to(dtype)
            g00, g01, g11 = lrc3_of(box).unbind(1)
            d_ab = -(2.0 * n_a - 1.0) * g00 + (2.0 * n_b + 1.0) * g11 \
                + 2.0 * (n_a - n_b - 1.0) * g01
            d_ba = (2.0 * n_a + 1.0) * g00 - (2.0 * n_b - 1.0) * g11 \
                + 2.0 * (n_b - n_a - 1.0) * g01
            dconst = dconst + torch.where(is_a, d_ab, d_ba)
        du_flip = u_n[ar, j_sel] - u_exist + dconst
        # the target: the first free slot of the other block
        free_b = (~act_b).to(torch.int64).argmax(dim=1) + cap_a
        free_a = (~act_a).to(torch.int64).argmax(dim=1)
        tgt = torch.where(is_a, free_b, free_a)
        room = torch.where(is_a, (~act_b).any(1), (~act_a).any(1))

        # acceptance
        ln_u = torch.log(torch.clamp_min(dr.u_acc, tiny))
        ok_m = torch.zeros((C,), dtype=torch.bool, device=device)
        if move_on:
            ok_m = (mt <= 1) & ~ovr_new \
                & (dr.u_acc < torch.exp(-beta * du_move))
        ln_acc_f = torch.where(is_a, ln_xi, -ln_xi) + m_n \
            + torch.log(torch.clamp_min(w_sum_n, tiny)) - m_o \
            - torch.log(torch.clamp_min(w_sum_o, tiny)) - beta * dconst
        ok_f = (mt == 2) & room & (w_sum_n > 0.0) & (ln_u < ln_acc_f)

        # apply (the branches exclude each other)
        com, quat = com.clone(), quat.clone()
        if move_on:
            com[ar, idx] = torch.where(ok_m[:, None], com_new, com_i)
            quat[ar, idx] = torch.where(ok_m[:, None], quat_new, quat_i)
            for s in (0, 1):
                mine = is_a if s == 0 else ~is_a
                a0 = torch.where(mine, ms.a0s[s] + (idx - ms.m0s[s])
                                 * ms.Ps[s], 0)
                coords = ms.write_pose(coords, a0, ms.Ps[s], per[s][2],
                                       ok_m & mine)
        com[ar, tgt] = torch.where(ok_f[:, None], com_i, com[ar, tgt])
        quat[ar, tgt] = torch.where(ok_f[:, None], quat_flip, quat[ar, tgt])
        for s in (0, 1):
            into = ~is_a if s == 0 else is_a      # flips into species s
            ra_f = ms.evs[s].pose_atoms(com_i, q_new[s][ar, j_sel])
            a0 = torch.where(into, ms.a0s[s] + (tgt - ms.m0s[s]) * ms.Ps[s],
                             0)
            coords = ms.write_pose(coords, a0, ms.Ps[s], ra_f, ok_f & into)
        active = clear_slot(set_slot(active, tgt, ok_f), idx, ok_f)
        if use_ewald:
            sfac = sfac + ok_f.to(dtype)[:, None, None] * (s_flip - s_old)
        e = e + torch.where(ok_f, du_flip, 0.0)
        if move_on:
            if use_ewald:
                sfac = sfac + ok_m.to(dtype)[:, None, None] * (s_new - s_old)
            e = e + torch.where(ok_m, du_move, 0.0)
        a_row = torch.stack([ok_m & (mt == 0), ok_m & (mt == 1), ok_f & is_a,
                             ok_f & ~is_a], 1)
        t_row = torch.stack([mt == 0, mt == 1, (mt == 2) & is_a,
                             (mt == 2) & ~is_a], 1)
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords, active=active,
            sfac=sfac, energy=e, acc=state.acc + a_row.to(torch.int32),
            att=state.att + t_row.to(torch.int32))

    def full_energy(state):
        return chunked_map(
            lambda com, quat, coords, active, box: ms.full_one(
                com, quat, coords, active[:, :cap_a], active[:, cap_a:], box),
            chunk, state.com, state.quat, state.coords, state.active,
            state.box)

    def run_steps(state, n_steps):
        C = state.com.shape[0]
        for _ in range(int(n_steps)):
            state = _one_step(state, draw(C))
        return state

    run_steps.step = _one_step
    run_steps.draw = draw

    if mega:
        if dtype != torch.float32:
            raise ValueError("mega semigrand requires dtype=float32 (the "
                             "kernels are f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        if px >= 1.0:
            raise ValueError("mega semigrand needs p_flip < 1")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc import moves
        sweep_act = moves.make_mega_sweep_fn(system, params, ms.kvecs,
                                             ms.kweights, device,
                                             with_activity=True)

        def _sweep_state(state):
            com, quat, coords, sfac, d_e, acc2, att2 = sweep_act(
                state.com, state.quat, state.coords, state.active, state.box,
                state.sfac, generator)
            return dataclasses.replace(
                state, com=com, quat=quat, coords=coords,
                sfac=sfac if use_ewald else state.sfac,
                energy=state.energy + d_e), acc2, att2

    if mega == "full":
        if not 0.0 < px < 1.0:
            raise ValueError("mega='full' needs 0 < p_flip < 1")
        if n_or != 1:
            raise ValueError("in-kernel flips run the unbiased algorithm "
                             "(n_orient=1); use mega=True for Rosenbluth-"
                             "biased flips")
        x_per = max(1, int(round(M * px / (1.0 - px))))
        flips = moves.make_mega_flip_fn(system, params, ms.kvecs,
                                        ms.kweights, device, fugacity_ratio,
                                        n_flip=x_per)

        def _cycle_full(state):
            st, acc2, att2 = _sweep_state(state)
            si2 = torch.stack([ev0.self_intra(st.box),
                               ev1.self_intra(st.box)], 1)
            lrc3 = lrc3_of(st.box) if ms.use_lrc else None
            com, quat, coords, active, sfac_o, d_ef, accf, attf = flips(
                st.com, st.quat, st.coords, st.active, st.box, st.sfac,
                generator, si2, lrc3)
            return dataclasses.replace(
                st, com=com, quat=quat, coords=coords, active=active,
                sfac=sfac_o if use_ewald else st.sfac,
                energy=st.energy + d_ef,
                acc=state.acc + torch.cat([acc2, accf], 1).to(torch.int32),
                att=state.att + torch.cat([att2, attf], 1).to(torch.int32))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (M + x_per))))):
                state = _cycle_full(state)
            return state

        run_steps.x_per = x_per

    elif mega:
        if px > 0.0:
            run_x = make_semigrand(system, params, fugacity_ratio, 1.0, dtype,
                                   chunk, n_orient, device=device,
                                   generator=generator)[1]
            x_per = max(1, int(round(M * px / (1.0 - px))))
        else:
            run_x, x_per = None, 0

        def _sweep_counted(state):
            st, acc2, att2 = _sweep_state(state)
            pad = torch.nn.functional.pad
            return dataclasses.replace(
                st, acc=state.acc + pad(acc2.to(torch.int32), (0, 2)),
                att=state.att + pad(att2.to(torch.int32), (0, 2)))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (M + x_per))))):
                state = _sweep_counted(state)
                if run_x is not None:
                    state = run_x(state, x_per)
            return state

        run_steps.sweep = _sweep_counted

    def init(box, n_a, n_b, n_chains):
        """n_a + n_b molecules in all (conserved), at most min(cap_A,
        cap_B) so that either pure composition fits; one shared lattice of
        n_a + n_b sites: active A slots take the first n_a sites, active B
        slots the next n_b, inactive slots park on the first site
        (masked)."""
        n_tot = int(n_a) + int(n_b)
        if n_tot < 1:
            raise ValueError("need at least one molecule (n_a + n_b >= 1)")
        if n_tot > min(cap_a, cap_b):
            raise ValueError(
                f"n_a + n_b = {n_tot} exceeds a block capacity ({cap_a}, "
                f"{cap_b}): every molecule must be able to flip to either "
                "species")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-image "
                             "(set strict_min_image=False to sample the "
                             "truncated model)")
        lat = np.asarray(cubic_lattice(n_tot, float(box)), np.float64)
        com_np = np.zeros((M, 3))
        com_np[:cap_a] = lat[0]
        com_np[:n_a] = lat[:n_a]
        com_np[cap_a:] = lat[0]
        com_np[cap_a:cap_a + n_b] = lat[n_a:n_tot]
        com = torch.tensor(com_np, dtype=dtype, device=device)[None].expand(
            n_chains, M, 3).contiguous()
        quat = ms.random_quats(generator, n_chains)
        act = np.zeros(M, bool)
        act[:n_a] = True
        act[cap_a:cap_a + n_b] = True
        state = SemigrandState(
            com=com, quat=quat, coords=ms.poses_to_coords(com, quat),
            active=torch.tensor(act, device=device)[None].expand(
                n_chains, M).contiguous(),
            box=torch.full((n_chains,), float(box), dtype=dtype,
                           device=device),
            sfac=torch.zeros((n_chains, K, 2), dtype=dtype, device=device),
            energy=torch.zeros((n_chains,), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 4), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 4), dtype=torch.int32, device=device))
        e, sf = full_energy(state)
        return dataclasses.replace(state, energy=e, sfac=sf)

    return init, run_steps, full_energy


class Semigrand:
    """The semigrand app as a class: blocks with the drift invariant and
    composition statistics.

    >>> g = Semigrand(two_block_system, params, fugacity_ratio=2.0)
    >>> st = g.init(box=10.0, n_a=20, n_b=20, n_chains=128)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, fugacity_ratio, p_flip=0.3,
                 dtype=torch.float64, chunk=8, n_orient=1, mega=None,
                 device="cuda", generator=None):
        self.params = params
        self._init, self.run_steps, self.full_energy = make_semigrand(
            system, params, fugacity_ratio, p_flip, dtype, chunk, n_orient,
            mega=mega, device=device, generator=generator)
        self.cap_a = system.species_slices[0][2] \
            - system.species_slices[0][1]

    def init(self, box, n_a, n_b, n_chains):
        return self._init(box, n_a, n_b, n_chains)

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
        n_b = state.active[:, self.cap_a:].sum(1).to(torch.float64)
        n_tot = state.active.sum(1).to(torch.float64)
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "nb_mean": float(n_b.mean()),
            "nb_var": float(n_b.var(unbiased=False)),
            "n_tot_mean": float(n_tot.mean()),
            "energy_mean": float(e.mean()),
            "acc_trans": float(ratio[:, 0].mean()),
            "acc_rot": float(ratio[:, 1].mean()),
            "acc_flip_ab": float(ratio[:, 2].mean()),
            "acc_flip_ba": float(ratio[:, 3].mean()),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and math.isfinite(stats["energy_mean"])):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e, sfac=sf), stats
