"""Grand-canonical (muVT) MC for rigid molecular species (counterpart of
metropolismontecarlo_tpu/mc/gcmc_mol.py).

Moves: displacement, rotation, insertion at a uniform position and
uniform orientation, deletion.  Acceptance (Frenkel & Smit ch. 5; the
uniform-orientation measure cancels into the activity):

    insert:  min[1, z V / (N + 1) exp(-beta dU)]
    delete:  min[1, N / (z V)     exp(-beta dU)]

A fixed capacity of molecule slots (the system's n_mol) with a per-chain
activity mask; every pose energy comes from `widom.make_pose_eval`, so
insertion energies and Widom ghosts are one implementation.  Per-chain
Ewald structure factors are carried and updated O(P K) per accepted
move; molecules must be neutral under "ewald".  `use_lrc` adds the
species-level tail U_lrc = g(box) N^2 to the exchange constants.

Three routes, chosen by `mega`:
  None    one attempt of every chain per step in plain tensor code
          (every convention, float64, Rosenbluth-biased exchanges);
  True    cycles of one activity-masked sweep-kernel sweep plus x_per
          exchange-only plain steps;
  "full"  cycles of one sweep-kernel launch that runs the cap moves and
          the x_per exchange attempts.
On CPU tensors the kernel routes run the kernel's plain version.  Spans
(utils/profiling.py): `gcmc.cycle` around each kernel launch,
`gcmc.exchange` around a hybrid cycle's exchange steps, `recompute`
around `full_energy`.  tmmc=True builds the transition-matrix variant on
every route (mc/tmmc.py TMMCMol runs it in blocks): each exchange attempt
deposits both branches' unbiased acceptances into a collection matrix
and the bias eta enters the acceptance thresholds only.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.gcmc import check_device
from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    random_quaternion,
    random_rotate_quaternion,
)
from metropolismontecarlo_tpu_torch.utils.activity import (
    clear_slot,
    set_slot,
    zero_empty,
)
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.profiling import span
from metropolismontecarlo_tpu_torch.utils.shard import chain_rows, rand_chains


@dataclasses.dataclass
class MolGCMCState:
    """Per-chain muVT state; every tensor leads with the chains axis C.
    The JAX state's `key` has no counterpart: draws come from the
    torch.Generator that make_gcmc_mol holds."""

    com: torch.Tensor      # (C, cap, 3) slot COMs (junk where inactive)
    quat: torch.Tensor     # (C, cap, 4) slot orientations
    coords: torch.Tensor   # (C, 3, A_pad) atom planes, in sync with (com,
    #   quat) for active slots only
    active: torch.Tensor   # (C, cap) bool
    box: torch.Tensor      # (C,)
    sfac: torch.Tensor     # (C, K, 2) carried S(k) ((C, 1, 2) without Ewald)
    energy: torch.Tensor   # (C,) carried total potential energy
    acc: torch.Tensor      # (C, 4) int32 accepted [trans, rot, insert, delete]
    att: torch.Tensor      # (C, 4) int32 attempted


def rosenbluth(neg_beta_u):
    """(C, k) -beta u (-inf for vetoed trials) -> (m (C,), w (C, k)) with
    sum_j exp(-beta u_j) = exp(m) sum(w), stably."""
    m = neg_beta_u.max(dim=-1).values
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m_safe, torch.exp(neg_beta_u - m_safe[:, None])


def make_trial_quats(P, dtype):
    """Uniform-orientation trial sampler of a P-site rigid species
    (identity rows for point species): trial_quats(generator, shape,
    fold=1), chain-global under a shard context (ops/quaternions.py)."""
    def trial_quats(generator, shape, fold=1):
        if P > 1:
            return random_quaternion(generator, shape, dtype, fold)
        q = torch.zeros(tuple(shape) + (4,), dtype=dtype,
                        device=generator.device)
        q[..., 0] = 1.0
        return q

    return trial_quats


def make_mol_slots(system, params, device="cuda", dtype=torch.float64):
    """The rigid-molecule slot machinery of the muVT app, batched over
    chains.  Validates the system/params combination and returns a
    namespace:
      ev: the `widom.make_pose_eval` pose evaluator;
      atom_ok_of(active (C, cap)) -> (C, A_pad) per-atom activity;
      write_pose(coords (C, 3, A_pad), slot (C,), ra (C, P, 3), keep (C,))
          -> coords with each kept chain's pose written into its slot;
      exchange_const(box (C,), n_old (C,), dn): the position-independent
          energy delta of changing N by dn (self + intra, the reference
          Wolf c Q^2 and the LJ tail, both quadratic in N);
      full_one(com, quat, coords, active, box) -> (e (C,), sfac (C, K,
          2)): the dense masked recompute (the drift anchor);
      pose_lattice_init(generator, box, n_chains) -> (com, quat, coords):
          lattice slots with random orientations;
      pose_batch, trial_quats, rosenbluth: the Rosenbluth trial tools;
      and the fields P, cap, A, A_pad, K, kv, kw, use_ewald, q_t2."""
    if not system.is_uniform:
        raise ValueError("molecular GCMC requires a uniform single-"
                         "species system (n_mol == slot capacity)")
    if params.ewald_surface:
        raise ValueError("ewald_surface is not supported in GCMC (the "
                         "whole-system dipole term would need deltas on "
                         "every move type)")
    if params.nlist_width != 0:
        raise ValueError("neighbor lists are not supported in GCMC")
    use_ewald = params.coulomb == "ewald"
    if use_ewald:
        kvecs, kweights = ewald_ops.make_kvectors(params.nk, params.ksq_max)
    else:
        kvecs = kweights = None

    ev = make_pose_eval(system, params, kvecs, kweights, device, dtype)
    if use_ewald and abs(ev.q_t_tot) > 1e-5:
        raise ValueError("ewald GCMC requires charge-neutral molecules "
                         f"(molecule net charge {ev.q_t_tot})")
    P, cap = ev.P, system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    assert A == cap * P
    K = len(kvecs) if use_ewald else 1
    kv = None if kvecs is None else torch.tensor(
        kvecs, dtype=torch.int32, device=device)
    kb = None if kvecs is None else ewald_ops.k_bounds(kvecs)
    kw = None if kweights is None else torch.tensor(
        kweights, dtype=dtype, device=device)
    mol_safe = ev.mol_of_atom.clamp(0, cap - 1)
    q_t2 = ev.q_t_tot ** 2
    prange = torch.arange(P, device=device)

    def atom_ok_of(active):
        return ev.real & active[..., mol_safe]

    def write_pose(coords, slot, ra, keep):
        idx = ((slot * P)[:, None] + prange)[:, None, :].expand(-1, 3, -1)
        new = torch.where(keep[:, None, None], ra.transpose(1, 2),
                          coords.gather(2, idx))
        return coords.scatter(2, idx, new)

    def exchange_const(box, n_old, dn):
        c = ev.self_intra(box) * dn
        nf = n_old.to(dtype)
        dn2 = (nf + dn) ** 2 - nf ** 2
        if q_t2 != 0.0:
            c = c + ev.wolf_const_coeff(box) * q_t2 * dn2
        if ev.use_lrc:
            c = c + ev.lrc_self_coeff(box) * dn2
        return c

    slots = torch.arange(cap, device=device)[None, :]

    def full_one(com, quat, coords, active, box):
        """Half the pose pair sums over active slots + the reciprocal
        energy of the active charges + the N-dependent constants, in the
        spans energy.setup (masks and poses), energy.real (pair sums and
        constants) and energy.kspace (S(k) and the reciprocal energy)."""
        with span("energy.setup", sync=False):
            a_ok = atom_ok_of(active)
            ra = ev.pose_atoms(com, quat)                  # (C, cap, P, 3)
        with span("energy.real", sync=False):
            e_m, _ = ev.pair_energy(com, ra, coords, com, box, a_ok, slots)
            e = 0.5 * torch.sum(torch.where(active, e_m, 0.0), dim=1)
            nf = active.sum(1).to(dtype)
            e = e + nf * ev.self_intra(box)
            if q_t2 != 0.0:
                e = e + ev.wolf_const_coeff(box) * q_t2 * nf * nf
            if ev.use_lrc:
                e = e + ev.lrc_self_coeff(box) * nf * nf
        if use_ewald:
            with span("energy.kspace", sync=False):
                cf = ewald_ops.cfac_coeffs(kv, kw, params.kappa_L / box,
                                           box)
                q_eff = torch.where(a_ok, ev.charges_flat, 0.0)
                sf = ewald_ops.structure_factor(coords.transpose(1, 2),
                                                q_eff, kv, box, kb)
                e = e + ewald_ops.recip_energy(sf, cf)
        else:
            sf = torch.zeros((com.shape[0], K, 2), dtype=dtype,
                             device=com.device)
        return e, sf

    trial_quats = make_trial_quats(P, dtype)

    def pose_lattice_init(generator, box, n_chains):
        lat = torch.tensor(cubic_lattice(cap, float(box)), dtype=dtype,
                           device=device)
        com = lat[None].expand(n_chains, cap, 3).contiguous()
        quat = trial_quats(generator, (n_chains, cap))
        ra = ev.pose_atoms(com, quat)                          # (C, cap, P, 3)
        coords = ra.reshape(n_chains, A, 3).transpose(1, 2)
        coords = torch.nn.functional.pad(coords, (0, A_pad - A)).contiguous()
        return com, quat, coords

    def pose_batch(com_t, quats, coords, com, box, a_ok, excl, sfac_base,
                   cf):
        """Energies of a batch of trial poses: (u (C, k), ovr (C, k), s
        (C, k, K, 2)), u = pair + reciprocal delta against sfac_base.
        com_t is (C, 3) for k orientations at one COM or (C, k, 3) for k
        full poses; quats (C, k, 4)."""
        C, k = quats.shape[:2]
        coms = com_t[:, None, :].expand(C, k, 3) if com_t.dim() == 2 \
            else com_t
        ra = ev.pose_atoms(coms, quats)
        e_p, ovr = ev.pair_energy(coms, ra, coords, com, box, a_ok, excl)
        if use_ewald:
            s = ev.pose_sfac(ra, box[:, None].expand(C, k))
            e_p = e_p + ewald_ops.recip_energy_delta(sfac_base[:, None], s,
                                                     cf[:, None])
        else:
            s = torch.zeros((C, k, K, 2), dtype=dtype, device=quats.device)
        return e_p, ovr, s

    return SimpleNamespace(
        ev=ev, P=P, cap=cap, A=A, A_pad=A_pad, K=K, kv=kv, kw=kw,
        kvecs=kvecs, kweights=kweights, use_ewald=use_ewald, q_t2=q_t2,
        atom_ok_of=atom_ok_of, write_pose=write_pose,
        exchange_const=exchange_const, full_one=full_one,
        pose_lattice_init=pose_lattice_init, trial_quats=trial_quats,
        pose_batch=pose_batch, rosenbluth=rosenbluth)


def make_gcmc_mol(system, params, activity, p_exchange=0.3,
                  dtype=torch.float64, chunk=8, n_orient=1,
                  bias="orientation", tmmc=False, mega=None, device="cuda",
                  generator=None):
    """Build the molecular-muVT functions: (init, run_steps, full_energy).

    system: a uniform single-species System whose n_mol is the slot
    capacity.  activity: a scalar, or a (n_chains,) activity ladder (each
    chain samples its own muVT state).  init(box, n_init, n_chains) ->
    MolGCMCState; run_steps(state, n_steps) -> state; full_energy(state)
    -> (energy (C,), sfac (C, K, 2)).  device: the card unless the caller
    passes "cpu"; generator: the torch.Generator (on device) behind every
    draw, seeded 0 when None.

    tmmc=True: run_steps(state, eta, n_steps) -> (state, cmat, uhist),
    eta the (cap + 1,) bias applied to the exchange acceptance only, cmat
    this call's (C, cap + 1, 3) collection matrix of Rao-Blackwellized
    unbiased acceptance probabilities ([stay, up, down], the exchange
    type's probability folded in) and uhist the (C, cap + 1, 3) energy
    moments [count, sum E, sum E^2] of each row.  With eta = 0 the
    trajectories are those of the tmmc=False build bit for bit.

    n_orient > 1: orientational-bias exchanges (Rosenbluth k-trial
    sampling, Frenkel & Smit ch. 13.2); bias="pose" widens the trials
    from k orientations at one position to k full poses.  Exact for every
    k; n_orient = 1 is the unbiased algorithm.

    mega=True: the displacement/rotation share of the sampling runs
    through the whole-sweep kernel with the activity mask
    (`mc/moves.make_mega_sweep_fn(with_activity=True)`), exchanges stay
    plain steps: run_steps executes its n_steps budget as cycles of [one
    kernel sweep = cap attempts + x_per exchange-only steps], x_per sized
    so the mix matches p_exchange.  mega="full": the exchanges run in
    the kernel too, one launch per cycle.  Both need dtype=float32 and
    the whole-sweep route's conventions, and run at params.temperature /
    dr_max / dphi_max; "full" needs n_orient=1, bias="orientation" and
    0 < p_exchange < 1."""
    device, generator = check_device(device, generator)
    ms = make_mol_slots(system, params, device, dtype)
    ev, P, cap, K = ms.ev, ms.P, ms.cap, ms.K
    kv, kw, use_ewald = ms.kv, ms.kw, ms.use_ewald
    atom_ok_of, write_pose = ms.atom_ok_of, ms.write_pose
    exchange_const, pose_batch = ms.exchange_const, ms.pose_batch

    beta = 1.0 / params.temperature
    z_arr = torch.as_tensor(np.asarray(activity), dtype=dtype, device=device)
    if z_arr.dim() not in (0, 1):
        raise ValueError("activity must be a scalar or a (n_chains,) "
                         "ladder")
    px = float(p_exchange)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    if bias not in ("orientation", "pose"):
        raise ValueError(f"bias must be 'orientation' or 'pose': {bias!r}")
    pose_bias = bias == "pose"
    # within non-exchange attempts, split params.p_translate : rest
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    move_on = p_disp + p_rot > 0.0
    tiny = torch.finfo(dtype).tiny
    log_k = math.log(n_or)

    def rand(*shape):
        return rand_chains(shape, generator, dtype, device)

    def _one_step(st, z, eta=None, cmat=None, uhist=None):
        """One attempt of every chain: displace, rotate, insert or delete
        by the chain's own draw; where-selects only.  With tmmc, deposits
        into cmat and uhist (C, cap + 1, 3) in place."""
        com, quat, coords, active, box, sfac, e = (
            st.com, st.quat, st.coords, st.active, st.box, st.sfac,
            st.energy)
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        us = rand(C, 4)          # [move type, slot pick, trial pick, accept]
        n = active.sum(1)
        nf = n.to(dtype)
        u_move = us[:, 0]
        # move type: 0 displace, 1 rotate, 2 insert, 3 delete
        mt = (u_move >= p_disp).long() + (u_move >= p_disp + p_rot).long() \
            + (u_move >= p_disp + p_rot + 0.5 * px).long()
        a_ok = atom_ok_of(active)

        # the slot picked among the N active (displace / rotate / delete)
        csum = torch.cumsum(active.to(torch.int64), dim=1)
        target = torch.floor(us[:, 1] * nf).to(torch.int64) + 1
        idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
        com_i, quat_i = com[ar, idx], quat[ar, idx]
        ra_old = ev.pose_atoms(com_i, quat_i)                     # (C, P, 3)

        # the displaced / rotated pose (skipped in exchange-only builds)
        if move_on:
            disp = (rand(C, 3) - 0.5) * params.dr_max
            com_new = torch.where((mt == 0)[:, None],
                                  torch.remainder(com_i + disp,
                                                  box[:, None]), com_i)
            quat_new = torch.where(
                (mt == 1)[:, None],
                random_rotate_quaternion(generator, quat_i, params.dphi_max),
                quat_i)
            ra_new = ev.pose_atoms(com_new, quat_new)
            e2, o2 = ev.pair_energy(
                torch.stack([com_i, com_new], 1),
                torch.stack([ra_old, ra_new], 1), coords, com, box, a_ok,
                idx)
            e_old, e_new, ovr_new = e2[:, 0], e2[:, 1], o2[:, 1]
        else:
            e1, _ = ev.pair_energy(com_i[:, None], ra_old[:, None], coords,
                                   com, box, a_ok, idx)
            e_old = e_new = e1[:, 0]
            ovr_new = torch.zeros_like(n, dtype=torch.bool)

        if use_ewald:
            cf = ewald_ops.cfac_coeffs(kv, kw, params.kappa_L / box, box)
            s_old = ev.pose_sfac(ra_old, box)
            if move_on:
                s_new = ev.pose_sfac(ra_new, box)
                d_move = ewald_ops.recip_energy_delta(sfac, s_new - s_old,
                                                      cf)
            else:
                d_move = torch.zeros_like(e)
        else:
            cf = None
            s_old = s_new = torch.zeros((C, K, 2), dtype=dtype,
                                        device=device)
            d_move = torch.zeros_like(e)
        du_move = e_new - e_old + d_move

        # insertion: k trial orientations at one uniform position, or k
        # full uniform poses (n_or = 1 is the unbiased rule)
        if pose_bias:
            com_ins = rand(C, n_or, 3) * box[:, None, None]
        else:
            com_ins = rand(C, 3) * box[:, None]
        quats_i = ms.trial_quats(generator, (C, n_or))
        u_i, ovr_i, s_i = pose_batch(com_ins, quats_i, coords, com, box,
                                     a_ok, -1, sfac, cf)
        slot = (~active).to(torch.int64).argmax(dim=1)
        full = n >= cap
        neg_inf = torch.full_like(u_i, -math.inf)
        m_i, w_i = rosenbluth(torch.where(ovr_i, neg_inf, -beta * u_i))
        w_sum_i = w_i.sum(1)
        j_sel = (torch.cumsum(w_i, 1) > (us[:, 2] * w_sum_i)[:, None]) \
            .to(torch.int64).argmax(dim=1)
        quat_ins = quats_i[ar, j_sel]
        if pose_bias:
            com_ins = com_ins[ar, j_sel]
        ra_ins = ev.pose_atoms(com_ins, quat_ins)
        s_ins = s_i[ar, j_sel]
        ec_ins = exchange_const(box, n, +1.0)
        du_ins = u_i[ar, j_sel] + ec_ins

        # deletion: the existing orientation + k-1 fresh trials, energies
        # of insertion into the system without molecule idx
        sfac_wo = sfac - s_old if use_ewald else sfac
        u_exist = e_old
        if use_ewald:
            u_exist = u_exist + ewald_ops.recip_energy_delta(sfac_wo, s_old,
                                                             cf)
        neg_d = (-beta * u_exist)[:, None]
        if n_or > 1:
            quats_d = ms.trial_quats(generator, (C, n_or - 1))
            coms_d = rand(C, n_or - 1, 3) * box[:, None, None] \
                if pose_bias else com_i
            u_d, ovr_d, _ = pose_batch(coms_d, quats_d, coords, com, box,
                                       a_ok, idx, sfac_wo, cf)
            neg_d = torch.cat([neg_d, torch.where(
                ovr_d, torch.full_like(u_d, -math.inf), -beta * u_d)], 1)
        m_d, w_d = rosenbluth(neg_d)
        w_sum_d = w_d.sum(1)
        ec_del = exchange_const(box, n, -1.0)
        du_del = -u_exist + ec_del

        # acceptance, in log space (exact for n_or = 1)
        vol = box ** 3
        u = us[:, 3]
        ln_u = torch.log(torch.clamp_min(u, tiny))
        ok_m = (mt <= 1) & (n > 0) & ~ovr_new \
            & (u < torch.exp(-beta * du_move))
        ln_acc_i = torch.log(z * vol / (nf + 1.0)) + m_i \
            + torch.log(torch.clamp_min(w_sum_i, tiny)) - log_k \
            - beta * ec_ins
        ln_acc_d = torch.log(torch.clamp_min(nf, 1.0) / (z * vol)) \
            + log_k - m_d - torch.log(torch.clamp_min(w_sum_d, tiny)) \
            - beta * ec_del
        if tmmc:
            # Rao-Blackwellized deposit of the unbiased acceptances
            # (min(1, e^ln_acc) = e^min(ln_acc, 0)), the exchange type's
            # probability 0.5 px folded in; uhist takes the pre-step energy
            pa_i = torch.where(full | (w_sum_i <= 0.0), 0.0,
                               torch.exp(torch.clamp_max(ln_acc_i, 0.0)))
            pa_d = torch.where(n > 0, torch.exp(torch.clamp_max(ln_acc_d,
                                                                0.0)), 0.0)
            up_v, dn_v = 0.5 * px * pa_i, 0.5 * px * pa_d
            cmat[ar, n] += torch.stack([1.0 - up_v - dn_v, up_v, dn_v], 1)
            uhist[ar, n] += torch.stack([torch.ones_like(e), e, e * e], 1)
            # the bias enters the thresholds only (the clamped reads are
            # behind the full / n == 0 refusals)
            eta_n = eta[n]
            ln_acc_i = ln_acc_i + eta[torch.clamp_max(n + 1, cap)] - eta_n
            ln_acc_d = ln_acc_d + eta[torch.clamp_min(n - 1, 0)] - eta_n
        ok_i = (mt == 2) & ~full & (w_sum_i > 0.0) & (ln_u < ln_acc_i)
        ok_d = (mt == 3) & (n > 0) & (ln_u < ln_acc_d)

        com, quat = com.clone(), quat.clone()
        if move_on:
            com[ar, idx] = torch.where(ok_m[:, None], com_new, com_i)
            quat[ar, idx] = torch.where(ok_m[:, None], quat_new, quat_i)
            coords = write_pose(coords, idx, ra_new, ok_m)
        com[ar, slot] = torch.where(ok_i[:, None], com_ins, com[ar, slot])
        quat[ar, slot] = torch.where(ok_i[:, None], quat_ins,
                                     quat[ar, slot])
        coords = write_pose(coords, slot, ra_ins, ok_i)
        active = clear_slot(set_slot(active, slot, ok_i), idx, ok_d)
        if use_ewald:
            sfac = sfac + ok_i.to(dtype)[:, None, None] * s_ins \
                - ok_d.to(dtype)[:, None, None] * s_old
            if move_on:
                sfac = sfac + ok_m.to(dtype)[:, None, None] * (s_new - s_old)
        zero = torch.zeros_like(e)
        e = e + torch.where(ok_i, du_ins, zero) \
            + torch.where(ok_d, du_del, zero)
        if move_on:
            e = e + torch.where(ok_m, du_move, zero)
        a_row = torch.stack([ok_m & (mt == 0), ok_m & (mt == 1), ok_i,
                             ok_d], 1).to(torch.int32)
        t_row = (torch.arange(4, device=device)[None, :]
                 == mt[:, None]).to(torch.int32)
        return dataclasses.replace(
            st, com=com, quat=quat, coords=coords, active=active, sfac=sfac,
            energy=e, acc=st.acc + a_row, att=st.att + t_row)

    def full_energy(state):
        """The chunked recompute of every chain, in one `recompute` span
        of the chains (utils/profiling.py)."""
        with span("recompute", state.com.shape[0]):
            return chunked_map(ms.full_one, chunk, state.com, state.quat,
                               state.coords, state.active, state.box)

    def _z_of(state):
        """(C,) per-chain activity: the scalar broadcast, or the ladder's
        rows of these chains (utils/shard.py chain_rows)."""
        return chain_rows(z_arr, state.com.shape[0], "activity ladder")

    def _tm_zeros(state):
        return torch.zeros((state.com.shape[0], cap + 1, 3), dtype=dtype,
                           device=device)

    def _eta(eta):
        return torch.as_tensor(eta).to(device=device, dtype=dtype)

    if tmmc:
        def run_steps(state, eta, n_steps):
            z, eta = _z_of(state), _eta(eta)
            cmat, uhist = _tm_zeros(state), _tm_zeros(state)
            for _ in range(int(n_steps)):
                state = _one_step(state, z, eta, cmat, uhist)
            return state, cmat, uhist
    else:
        def run_steps(state, n_steps):
            z = _z_of(state)
            for _ in range(int(n_steps)):
                state = _one_step(state, z)
            return state

    if mega:
        if dtype != torch.float32:
            raise ValueError("mega GCMC requires dtype=float32 (the "
                             "whole-sweep kernel is f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc.moves import make_mega_sweep_fn

        if mega == "full":
            if not 0.0 < px < 1.0:
                raise ValueError("mega='full' needs 0 < p_exchange < 1 "
                                 "(the kernel cycle mixes moves and "
                                 "exchanges)")
            if n_or != 1 or pose_bias:
                raise ValueError("in-kernel exchanges run the unbiased "
                                 "algorithm (n_orient=1, bias="
                                 "'orientation'); use mega=True for "
                                 "Rosenbluth-biased exchanges")
            x_per = max(1, int(round(cap * px / (1.0 - px))))
            sweep_x = make_mega_sweep_fn(
                system, params, ms.kvecs, ms.kweights, device,
                with_activity=True, n_exch=x_per, tmmc_exch=tmmc)

            def _cycle_full(state, eta=None):
                """One launch, in a `gcmc.cycle` span of the chains; with
                tmmc also its (cmat, uhist), the carried energy going in as
                the deposits' e_in."""
                si_c = ev.self_intra(state.box)
                wc_c = ev.wolf_const_coeff(state.box) * ms.q_t2
                if ev.use_lrc:
                    # the tail rides the quadratic-in-N constant:
                    # wc (2 n +- 1) is g ((N + dn)^2 - N^2) for dn = +-1
                    wc_c = wc_c + ev.lrc_self_coeff(state.box)
                with span("gcmc.cycle", state.com.shape[0], sync=False):
                    out = sweep_x(
                        state.com, state.quat, state.coords, state.active,
                        state.box, state.sfac, generator, _z_of(state), si_c,
                        wc_c, energy=state.energy, eta=eta)
                com, quat, coords, active, sfac_o, d_e, acc4, att4 = out[:8]
                energy, sfac_o = zero_empty(
                    state.energy + d_e,
                    sfac_o if use_ewald else state.sfac, active)
                st = dataclasses.replace(
                    state, com=com, quat=quat, coords=coords, active=active,
                    sfac=sfac_o, energy=energy,
                    acc=state.acc + acc4.to(torch.int32),
                    att=state.att + att4.to(torch.int32))
                return (st,) + tuple(out[8:10]) if tmmc else st

            def n_cycles(n_steps):
                return max(1, int(round(n_steps / (cap + x_per))))

            if tmmc:
                def run_steps(state, eta, n_steps):   # noqa: F811
                    eta = _eta(eta)
                    cmat, uhist = _tm_zeros(state), _tm_zeros(state)
                    for _ in range(n_cycles(n_steps)):
                        state, cm, uh = _cycle_full(state, eta)
                        cmat, uhist = cmat + cm, uhist + uh
                    return state, cmat, uhist
            else:
                def run_steps(state, n_steps):        # noqa: F811
                    for _ in range(n_cycles(n_steps)):
                        state = _cycle_full(state)
                    return state

        else:
            sweep_act = make_mega_sweep_fn(
                system, params, ms.kvecs, ms.kweights, device,
                with_activity=True)
            if px >= 1.0:
                raise ValueError("mega GCMC needs p_exchange < 1 (otherwise "
                                 "there is no displacement work for the "
                                 "kernel)")
            if px > 0.0:
                # the exchange-only plain sampler (p_exchange = 1) on the
                # same generator, x_per steps of it per kernel sweep
                _, run_x, _ = make_gcmc_mol(
                    system, params, activity, 1.0, dtype, chunk, n_orient,
                    bias, tmmc, device=device, generator=generator)
                x_per = max(1, int(round(cap * px / (1.0 - px))))
            elif tmmc:
                raise ValueError(
                    "mega=True TMMC needs p_exchange > 0: its exchange "
                    "steps deposit the collection matrix (mc/tmmc.py); melt "
                    "phases use a tmmc=False build")
            else:
                run_x, x_per = None, 0

            def _sweep_state(state):
                """One launch, in a `gcmc.cycle` span of the chains."""
                with span("gcmc.cycle", state.com.shape[0], sync=False):
                    com, quat, coords, sfac, d_e, acc2, att2 = sweep_act(
                        state.com, state.quat, state.coords, state.active,
                        state.box, state.sfac, generator)
                pad = torch.nn.functional.pad
                return dataclasses.replace(
                    state, com=com, quat=quat, coords=coords,
                    sfac=sfac if use_ewald else state.sfac,
                    energy=state.energy + d_e,
                    acc=state.acc + pad(acc2.to(torch.int32), (0, 2)),
                    att=state.att + pad(att2.to(torch.int32), (0, 2)))

            def n_cycles(n_steps):
                return max(1, int(round(n_steps / (cap + x_per))))

            def exchanges(state):
                """The span of a cycle's x_per plain exchange steps."""
                return span("gcmc.exchange", state.com.shape[0] * x_per,
                            sync=False)

            if tmmc:
                def run_steps(state, eta, n_steps):   # noqa: F811
                    cmat, uhist = _tm_zeros(state), _tm_zeros(state)
                    for _ in range(n_cycles(n_steps)):
                        state = _sweep_state(state)
                        with exchanges(state):
                            state, cm, uh = run_x(state, eta, x_per)
                        cmat, uhist = cmat + cm, uhist + uh
                    return state, cmat, uhist
            else:
                def run_steps(state, n_steps):        # noqa: F811
                    for _ in range(n_cycles(n_steps)):
                        state = _sweep_state(state)
                        if run_x is not None:
                            with exchanges(state):
                                state = run_x(state, x_per)
                    return state

    def init(box, n_init, n_chains):
        """n_init: a scalar, or (n_chains,) per-chain starts.  Under a
        shard context n_chains is this process's count, and a per-chain
        n_init or activity ladder may have the global length: the rows
        are the unsharded init's rows of these chains."""
        n0 = np.asarray(n_init, np.int32)
        if np.any(n0 > cap):
            raise ValueError("n_init exceeds capacity")
        if n0.ndim == 1:
            n0 = chain_rows(n0, n_chains, "per-chain n_init")
        if z_arr.dim() == 1:
            chain_rows(z_arr, n_chains, "activity ladder")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-"
                             "image (set strict_min_image=False to "
                             "sample the truncated model)")
        com, quat, coords = ms.pose_lattice_init(generator, box, n_chains)
        active = torch.arange(cap, device=device)[None, :] \
            < torch.as_tensor(n0, device=device).reshape(-1, 1)
        active = active.expand(n_chains, cap).contiguous()
        state = MolGCMCState(
            com=com, quat=quat, coords=coords, active=active,
            box=torch.full((n_chains,), float(box), dtype=dtype,
                           device=device),
            sfac=torch.zeros((n_chains, K, 2), dtype=dtype, device=device),
            energy=torch.zeros((n_chains,), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 4), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 4), dtype=torch.int32, device=device))
        e, sf = full_energy(state)
        return dataclasses.replace(state, energy=e, sfac=sf)

    return init, run_steps, full_energy


class MolGCMC:
    """The muVT app as a class: blocks with the drift invariant and N
    statistics.

    >>> g = MolGCMC(spce_system(64), params, activity=3e-5)   # on the card
    >>> st = g.init(box=20.0, n_init=24, n_chains=128)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, activity, p_exchange=0.3,
                 dtype=torch.float64, chunk=8, n_orient=1,
                 bias="orientation", mega=None, device="cuda",
                 generator=None):
        self.params = params
        self.capacity = system.n_mol
        self._system = system
        self._init, self.run_steps, self.full_energy = make_gcmc_mol(
            system, params, activity, p_exchange, dtype, chunk, n_orient,
            bias, mega=mega, device=device, generator=generator)

    def init(self, box, n_init, n_chains):
        return self._init(box, n_init, n_chains)

    def atom_mask(self, state):
        """(C, A_pad) per-atom activity mask (for masked observables)."""
        moa = torch.as_tensor(np.array(self._system.mol_of_atom_padded),
                              device=state.active.device)
        return (moa >= 0) & state.active[:, moa.clamp(0, self.capacity - 1)]

    def run_block(self, state, n_steps, drift_tol=None):
        att0, acc0 = state.att, state.acc
        e_start = state.energy
        state = self.run_steps(state, n_steps)
        e, sf = self.full_energy(state)
        # scale on both block endpoints: a chain that traverses a large
        # energy range and ends near zero carries its cancellation residue
        # relative to the traversal, not the endpoint
        scale = torch.clamp_min(torch.maximum(e.abs(), e_start.abs()), 1.0)
        drift = torch.max((e - state.energy).abs() / scale)
        sfac_err = torch.max((sf - state.sfac).abs())
        n = state.active.sum(1).to(torch.float64)
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "n_mean": float(n.mean()),
            "n_var": float(n.var(unbiased=False)),
            "full_frac": float((n >= self.capacity).to(torch.float64)
                               .mean()),
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
