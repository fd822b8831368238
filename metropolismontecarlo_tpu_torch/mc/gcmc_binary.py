"""Binary-mixture grand-canonical MC: both species exchange with reservoirs
at their own activities, mu_A mu_B V T (counterpart of
metropolismontecarlo_tpu/mc/gcmc_binary.py).

A two-species-block System (each block internally uniform; each block's
molecule count is that species' slot capacity), one `widom.make_pose_eval`
per species; displacements and rotations pick uniformly among all active
molecules and select the picked species' pose energies; insertions and
deletions per species as in mc/gcmc_mol.py (with the Rosenbluth option),
the carried per-chain Ewald S(k) updated through every accepted move of
either species.  Acceptance, per species s:

    insert:  min[1, z_s V / (N_s + 1) exp(-beta dU)]
    delete:  min[1, N_s / (z_s V)     exp(-beta dU)]

`use_lrc` adds the two-species quadratic tail U_lrc = (8 pi / 3V)
sum_ss' N_s N_s' c_ss' (ops/tail.mol_tail_coeff) to the exchange constants
and the recompute; the in-kernel route carries the own-species term on the
wc lane and the cross term through the live-count si fold (mc/moves.py
sweep_x lrc_cross).

Three routes, chosen by `mega`:
  None    one attempt of every chain per step in plain tensor code (every
          convention, float64, Rosenbluth-biased exchanges); the step takes
          its draws explicitly: run_steps.step(state, draws), draws from
          run_steps.draw(C);
  True    cycles of one activity-masked sweep-kernel sweep (one launch per
          species block) plus x_per exchange-only plain steps;
  "full"  cycles of one sweep-kernel launch per species block, each running
          the block's moves and x_per / 2 exchange attempts of its species,
          the activity planes threaded between the two launches.
On CPU tensors the kernel routes run the kernel's plain version.

`make_binary_slots` is the two-species slot machinery that the semigrand
ensemble (mc/semigrand.py) shares.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.gcmc import check_device
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import (
    make_trial_quats,
    rosenbluth,
)
from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.ops.quaternions import rotate_quaternion
from metropolismontecarlo_tpu_torch.utils.activity import (
    clear_slot,
    set_slot,
    zero_empty,
)
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.shard import (
    rand_chains,
    randn_chains,
)


@dataclasses.dataclass
class BinaryGCMCState:
    """Per-chain binary muVT state; every tensor leads with the chains axis
    C.  The JAX state's `key` has no counterpart: draws come from the
    torch.Generator that make_gcmc_binary holds."""

    com: torch.Tensor      # (C, M, 3)  M = cap0 + cap1 slot COMs
    quat: torch.Tensor     # (C, M, 4)
    coords: torch.Tensor   # (C, 3, A_pad)
    active0: torch.Tensor  # (C, cap0) bool, species-0 slots
    active1: torch.Tensor  # (C, cap1) bool, species-1 slots
    box: torch.Tensor      # (C,)
    sfac: torch.Tensor     # (C, K, 2) ((C, 1, 2) without Ewald)
    energy: torch.Tensor   # (C,)
    acc: torch.Tensor      # (C, 6) int32 [trans, rot, insA, delA, insB, delB]
    att: torch.Tensor      # (C, 6) int32


def _atom_ok_fn(system, device):
    """atom_ok_of(active0 (..., cap0), active1 (..., cap1)) -> (..., A_pad)
    bool per-atom activity of a two-species-block system."""
    (_, m0_a, m1_a, _, _), (_, m0_b, m1_b, _, _) = system.species_slices
    mol = torch.as_tensor(np.array(system.mol_of_atom_padded, np.int64),
                          device=device)
    real = mol >= 0
    col_b = (mol >= m0_b) & real
    slot0 = (mol - m0_a).clamp(0, (m1_a - m0_a) - 1)
    slot1 = (mol - m0_b).clamp(0, (m1_b - m0_b) - 1)

    def atom_ok_of(active0, active1):
        return real & torch.where(col_b, active1[..., slot1],
                                  active0[..., slot0])

    return atom_ok_of


def binary_atom_ok(system, active0, active1):
    """Per-atom activity mask of a two-species-block system, batched:
    active0 (..., cap0) and active1 (..., cap1) -> (..., A_pad) bool (for
    observables over ensemble states, without the pose evaluators)."""
    return _atom_ok_fn(system, active0.device)(active0, active1)


def make_binary_slots(system, params, device="cuda", dtype=torch.float64,
                      neutral=True):
    """The two-species slot machinery of the binary ensembles, batched over
    chains (the two-species analogue of gcmc_mol.make_mol_slots).
    Validates the system/params combination (neutral: under Ewald each
    species must be charge-neutral; the semigrand ensemble passes False and
    checks equal net charges itself) and returns a namespace:
      evs: one `widom.make_pose_eval` per species;
      caps, m0s, a0s, Ps: per-species slot counts, first slot, first atom
          column, sites;
      atom_ok_of(active0, active1) -> (C, A_pad) per-atom activity;
      write_pose(coords (C, 3, A_pad), a0 (C,), width, ra (C, width, 3),
          keep (C,)): each kept chain's pose written from column a0;
      exchange_const(box, n0, n1, s, dn): the position-independent energy
          delta of changing species s by dn (self + intra, the reference
          Wolf c Q_tot^2 of both species' charges, the two-species tail);
      pose_batch(s, com_t, quats, coords, com, box, a_ok, excl, sfac_base,
          cf): species-s trial-pose energies (gcmc_mol's pose_batch);
      full_one(com, quat, coords, active0, active1, box) -> (e (C,), sfac
          (C, K, 2)): the dense masked recompute;
      pose_lattice_init(generator, box, n_chains) -> (com, quat, coords);
      lrc_gmat(box (C,)) -> (C, 2, 2) tail coefficients g_ss' (use_lrc);
      trial_quats, rosenbluth, and the fields M, A, A_pad, K, kv, kw,
          kvecs, kweights, use_ewald, use_lrc."""
    slices = system.species_slices
    if len(slices) != 2:
        raise ValueError("binary ensembles require exactly two species "
                         f"blocks; got {[s[0] for s in slices]}")
    if not system.species_uniform:
        raise ValueError("each species block must be internally uniform")
    if params.ewald_surface or params.nlist_width != 0:
        raise ValueError("ewald_surface / neighbor lists are not supported "
                         "in binary ensembles")
    use_ewald = params.coulomb == "ewald"
    if use_ewald:
        kvecs, kweights = ewald_ops.make_kvectors(params.nk, params.ksq_max)
    else:
        kvecs = kweights = None
    evs = tuple(make_pose_eval(system, params, kvecs, kweights, device, dtype,
                               species=s) for s in (0, 1))
    if use_ewald and neutral:
        for s, ev in enumerate(evs):
            if abs(ev.q_t_tot) > 1e-5:
                raise ValueError(
                    "ewald binary ensembles require charge-neutral species "
                    f"(species {s} net charge {ev.q_t_tot})")
    (_, m0_a, m1_a, P0, a0_a), (_, m0_b, m1_b, P1, a0_b) = slices
    caps = (m1_a - m0_a, m1_b - m0_b)
    m0s, a0s, Ps = (m0_a, m0_b), (a0_a, a0_b), (P0, P1)
    if min(caps) < 1:
        raise ValueError(f"each species needs >= 1 slot (got {caps})")
    M = system.n_mol
    A, A_pad = system.n_atoms, system.n_atoms_padded
    K = len(kvecs) if use_ewald else 1
    kv = None if kvecs is None else torch.tensor(kvecs, dtype=torch.int32,
                                                 device=device)
    kb = None if kvecs is None else ewald_ops.k_bounds(kvecs)
    kw = None if kweights is None else torch.tensor(kweights, dtype=dtype,
                                                    device=device)
    trial_quats = tuple(make_trial_quats(P, dtype) for P in Ps)
    atom_ok_of = _atom_ok_fn(system, device)

    def write_pose(coords, a0, width, ra, keep):
        idx = (a0[:, None] + torch.arange(width, device=coords.device))
        idx = idx.clamp(0, A_pad - 1)[:, None, :].expand(-1, 3, -1)
        new = torch.where(keep[:, None, None], ra.transpose(1, 2),
                          coords.gather(2, idx))
        return coords.scatter(2, idx, new)

    # the species-level tail coefficients: U_lrc = (8 pi / 3V) sum_ss'
    # N_s N_s' c_lrc[s, s'], for use_lrc with the unshifted potential
    use_lrc = evs[0].use_lrc
    lrc_gmat = None
    if use_lrc:
        c_lrc = torch.tensor(
            [[tail_ops.mol_tail_coeff(evs[a].t_vec, evs[b].t_vec,
                                      system.eps_table, system.sig_table,
                                      params.r_cut) for b in (0, 1)]
             for a in (0, 1)], dtype=dtype, device=device)

        def lrc_gmat(box):
            return tail_ops.LRC_PREFACTOR * c_lrc / box[:, None, None] ** 3

    def exchange_const(box, n0, n1, s, dn):
        c = evs[s].self_intra(box) * dn
        q0, q1 = evs[0].q_t_tot, evs[1].q_t_tot
        if q0 != 0.0 or q1 != 0.0:
            q_tot = n0.to(dtype) * q0 + n1.to(dtype) * q1
            dq = dn * (q1 if s else q0)
            c = c + evs[s].wolf_const_coeff(box) \
                * ((q_tot + dq) ** 2 - q_tot ** 2)
        if use_lrc:
            g = lrc_gmat(box)
            nf_s = (n1 if s else n0).to(dtype)
            nf_o = (n0 if s else n1).to(dtype)
            c = c + g[:, s, s] * ((nf_s + dn) ** 2 - nf_s ** 2) \
                + 2.0 * g[:, s, 1 - s] * dn * nf_o
        return c

    def pose_batch(s, com_t, quats, coords, com, box, a_ok, excl, sfac_base,
                   cf):
        C, k = quats.shape[:2]
        coms = com_t[:, None, :].expand(C, k, 3)
        ra = evs[s].pose_atoms(coms, quats)
        e_p, ovr = evs[s].pair_energy(coms, ra, coords, com, box, a_ok, excl)
        if use_ewald:
            sf = evs[s].pose_sfac(ra, box[:, None].expand(C, k))
            e_p = e_p + ewald_ops.recip_energy_delta(sfac_base[:, None], sf,
                                                     cf[:, None])
        else:
            sf = torch.zeros((C, k, K, 2), dtype=dtype, device=quats.device)
        return e_p, ovr, sf

    def full_one(com, quat, coords, active0, active1, box):
        """Half the pose pair sums over both species' active slots + the
        reciprocal energy of the active charges + the N-dependent
        constants."""
        a_ok = atom_ok_of(active0, active1)
        e = 0.0
        for s, act in enumerate((active0, active1)):
            sl = slice(m0s[s], m0s[s] + caps[s])
            ra = evs[s].pose_atoms(com[:, sl], quat[:, sl])
            slots = torch.arange(m0s[s], m0s[s] + caps[s],
                                 device=com.device)[None, :]
            e_m, _ = evs[s].pair_energy(com[:, sl], ra, coords, com, box,
                                        a_ok, slots)
            e = e + torch.sum(torch.where(act, e_m, 0.0), dim=1)
        e = 0.5 * e
        nf = tuple(a.sum(1).to(dtype) for a in (active0, active1))
        e = e + nf[0] * evs[0].self_intra(box) + nf[1] * evs[1].self_intra(box)
        q_tot = nf[0] * evs[0].q_t_tot + nf[1] * evs[1].q_t_tot
        e = e + evs[0].wolf_const_coeff(box) * q_tot * q_tot
        if use_lrc:
            g = lrc_gmat(box)
            e = e + g[:, 0, 0] * nf[0] * nf[0] + g[:, 1, 1] * nf[1] * nf[1] \
                + 2.0 * g[:, 0, 1] * nf[0] * nf[1]
        if use_ewald:
            cf = ewald_ops.cfac_coeffs(kv, kw, params.kappa_L / box, box)
            q_eff = torch.where(a_ok, evs[0].charges_flat, 0.0)
            sf = ewald_ops.structure_factor(coords.transpose(1, 2), q_eff,
                                            kv, box, kb)
            e = e + ewald_ops.recip_energy(sf, cf)
        else:
            sf = torch.zeros((com.shape[0], K, 2), dtype=dtype,
                             device=com.device)
        return e, sf

    def poses_to_coords(com, quat):
        """(C, 3, A_pad) atom planes of every slot's pose."""
        C = com.shape[0]
        ra = [evs[s].pose_atoms(com[:, m0s[s]:m0s[s] + caps[s]],
                                quat[:, m0s[s]:m0s[s] + caps[s]])
              .reshape(C, caps[s] * Ps[s], 3) for s in (0, 1)]
        coords = torch.cat(ra, dim=1).transpose(1, 2)
        return torch.nn.functional.pad(coords, (0, A_pad - A)).contiguous()

    def random_quats(generator, n_chains):
        """(C, M, 4) uniform orientations (identities without a
        multi-site species)."""
        return make_trial_quats(max(Ps), dtype)(generator, (n_chains, M))

    def pose_lattice_init(generator, box, n_chains):
        lat = torch.tensor(cubic_lattice(M, float(box)), dtype=dtype,
                           device=device)
        com = lat[None].expand(n_chains, M, 3).contiguous()
        quat = random_quats(generator, n_chains)
        return com, quat, poses_to_coords(com, quat)

    return SimpleNamespace(
        evs=evs, caps=caps, m0s=m0s, a0s=a0s, Ps=Ps, M=M, A=A, A_pad=A_pad,
        K=K, kv=kv, kw=kw, kvecs=kvecs, kweights=kweights,
        use_ewald=use_ewald, atom_ok_of=atom_ok_of, write_pose=write_pose,
        exchange_const=exchange_const, pose_batch=pose_batch,
        full_one=full_one, pose_lattice_init=pose_lattice_init,
        poses_to_coords=poses_to_coords, random_quats=random_quats,
        trial_quats=trial_quats, rosenbluth=rosenbluth, use_lrc=use_lrc,
        lrc_gmat=lrc_gmat)


def make_gcmc_binary(system, params, activities, p_exchange=0.4,
                     dtype=torch.float64, chunk=8, n_orient=1, mega=None,
                     device="cuda", generator=None):
    """Build the binary-muVT functions: (init, run_steps, full_energy).

    system: a System with exactly two species blocks, each internally
    uniform; activities = (z0, z1).  init(box, n_init (n0, n1), n_chains)
    -> BinaryGCMCState; run_steps(state, n_steps) -> state;
    full_energy(state) -> (energy (C,), sfac (C, K, 2)).  Exchange attempts
    split p_exchange equally over the four exchange types (insert / delete
    x species).  The plain route's run_steps carries its step with the
    draws given: run_steps.step(state, draws), draws = run_steps.draw(C).

    mega=True: displacement/rotation sweeps through the activity-masked
    whole-sweep kernel, one launch per species block, with the four
    exchange types on plain steps (a p_exchange = 1 build); needs float32.
    mega="full": both species' exchanges run in the kernel, appended to
    their own block's launch, x_per / 2 each (unbiased, n_orient = 1,
    charge-neutral species, 0 < p_exchange < 1, float32).  device: the card
    unless the caller passes "cpu"; generator: the torch.Generator behind
    every draw, seeded 0 when None."""
    device, generator = check_device(device, generator)
    ms = make_binary_slots(system, params, device, dtype)
    evs, caps, m0s, a0s, Ps = ms.evs, ms.caps, ms.m0s, ms.a0s, ms.Ps
    M, K, use_ewald = ms.M, ms.K, ms.use_ewald
    if len(activities) != 2:
        raise ValueError("activities must be a (z0, z1) pair")
    zs = tuple(float(z) for z in activities)
    beta = 1.0 / params.temperature
    px = float(p_exchange)
    n_or = int(n_orient)
    if n_or < 1:
        raise ValueError("n_orient must be >= 1")
    p_disp = (1.0 - px) * float(params.p_translate)
    p_rot = (1.0 - px) * (1.0 - float(params.p_translate))
    move_on = p_disp + p_rot > 0.0
    q_x = 0.25 * px
    edges = torch.tensor(np.cumsum([p_disp, p_rot, q_x, q_x, q_x]),
                         dtype=dtype, device=device)
    tiny = torch.finfo(dtype).tiny
    log_k = math.log(n_or)

    def rand(*shape):
        return rand_chains(shape, generator, dtype, device)

    def draw(C):
        """The draws of one plain step of C chains, as the JAX step takes
        them from its key: the move type, the slot pick, the displacement,
        the rotation's axis and angle, per species the insertion position,
        its trial orientations, the deletion pick, the deletion's extra
        trials and the trial pick, and the acceptance."""
        axis = randn_chains((C, 3), generator, dtype, device)
        return SimpleNamespace(
            u_move=rand(C), u_sel=rand(C), u_pos=rand(C, 3),
            axis=axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
            u_rot=rand(C), u_ins=rand(C, 2, 3),
            quats_ins=torch.stack([ms.trial_quats[s](generator, (C, n_or))
                                   for s in (0, 1)], 1),
            u_del=rand(C, 2),
            quats_del=torch.stack([ms.trial_quats[s](generator,
                                                     (C, n_or - 1))
                                   for s in (0, 1)], 1),
            u_pick=rand(C, 2), u_acc=rand(C))

    def _one_step(state, dr):
        """One displacement, rotation, insertion or deletion of either
        species per chain on the draws dr (draw); where-selects only."""
        com, quat, coords = state.com, state.quat, state.coords
        actives = (state.active0, state.active1)
        box, sfac, e = state.box, state.sfac, state.energy
        C = com.shape[0]
        ar = torch.arange(C, device=device)
        ns = tuple(a.sum(1) for a in actives)
        # 0 disp, 1 rot, 2 insA, 3 delA, 4 insB, 5 delB
        mt = (dr.u_move[:, None] >= edges[None, :]).sum(1)
        a_ok = ms.atom_ok_of(*actives)
        cf = ewald_ops.cfac_coeffs(ms.kv, ms.kw, params.kappa_L / box, box) \
            if use_ewald else None
        zero_s = torch.zeros((C, K, 2), dtype=dtype, device=device)

        # displacement / rotation: the pick among all active molecules
        active_all = torch.cat(actives, 1)
        n_tot = ns[0] + ns[1]
        csum = torch.cumsum(active_all.to(torch.int64), dim=1)
        target = torch.floor(dr.u_sel * n_tot.to(dtype)).to(torch.int64) + 1
        idx = (csum >= target[:, None]).to(torch.int64).argmax(dim=1)
        is_a = idx < caps[0]
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
            for ev in evs:
                ra_o = ev.pose_atoms(com_i, quat_i)
                ra_n = ev.pose_atoms(com_new, quat_new)
                e2, o2 = ev.pair_energy(
                    torch.stack([com_i, com_new], 1),
                    torch.stack([ra_o, ra_n], 1), coords, com, box, a_ok, idx)
                s_o = ev.pose_sfac(ra_o, box) if use_ewald else zero_s
                s_n = ev.pose_sfac(ra_n, box) if use_ewald else zero_s
                per.append((ra_n, e2[:, 0], e2[:, 1], o2[:, 1], s_o, s_n))
            sel = [torch.where(is_a.reshape((C,) + (1,) * (x.dim() - 1)), x, y)
                   for x, y in zip(per[0][1:], per[1][1:])]
            e_old, e_new, ovr_new, s_old, s_new = sel
            du_move = e_new - e_old
            if use_ewald:
                du_move = du_move + ewald_ops.recip_energy_delta(
                    sfac, s_new - s_old, cf)

        # per-species insertion and deletion
        ins, dele = [], []
        for s in (0, 1):
            nf_s = ns[s].to(dtype)
            com_ins = dr.u_ins[:, s] * box[:, None]
            quats_i = dr.quats_ins[:, s]
            u_i, ovr_i, s_i = ms.pose_batch(s, com_ins, quats_i, coords, com,
                                            box, a_ok, -1, sfac, cf)
            slot = (~actives[s]).to(torch.int64).argmax(dim=1)
            m_i, w_i = rosenbluth(torch.where(
                ovr_i, torch.full_like(u_i, -math.inf), -beta * u_i))
            w_sum_i = w_i.sum(1)
            j_sel = (torch.cumsum(w_i, 1) > (dr.u_pick[:, s]
                                             * w_sum_i)[:, None]) \
                .to(torch.int64).argmax(dim=1)
            quat_ins = quats_i[ar, j_sel]
            ec_ins = ms.exchange_const(box, ns[0], ns[1], s, +1.0)
            ins.append(dict(
                com=com_ins, quat=quat_ins,
                ra=evs[s].pose_atoms(com_ins, quat_ins), sfac=s_i[ar, j_sel],
                slot=slot, full=ns[s] >= caps[s], m=m_i, w_sum=w_sum_i,
                ec=ec_ins, du=u_i[ar, j_sel] + ec_ins, nf=nf_s))
            # deletion: the existing orientation + n_or - 1 fresh trials
            csum_s = torch.cumsum(actives[s].to(torch.int64), dim=1)
            t_s = torch.floor(dr.u_del[:, s] * nf_s).to(torch.int64) + 1
            slot_del = (csum_s >= t_s[:, None]).to(torch.int64).argmax(dim=1)
            mol_d = m0s[s] + slot_del
            com_d, quat_d = com[ar, mol_d], quat[ar, mol_d]
            ra_d = evs[s].pose_atoms(com_d, quat_d)
            e_d, _ = evs[s].pair_energy(com_d[:, None], ra_d[:, None], coords,
                                        com, box, a_ok, mol_d)
            u_exist = e_d[:, 0]
            s_d, sfac_wo = zero_s, sfac
            if use_ewald:
                s_d = evs[s].pose_sfac(ra_d, box)
                sfac_wo = sfac - s_d
                u_exist = u_exist + ewald_ops.recip_energy_delta(sfac_wo, s_d,
                                                                 cf)
            neg_d = (-beta * u_exist)[:, None]
            if n_or > 1:
                u_dd, ovr_dd, _ = ms.pose_batch(s, com_d, dr.quats_del[:, s],
                                                coords, com, box, a_ok, mol_d,
                                                sfac_wo, cf)
                neg_d = torch.cat([neg_d, torch.where(
                    ovr_dd, torch.full_like(u_dd, -math.inf), -beta * u_dd)],
                    1)
            m_d, w_d = rosenbluth(neg_d)
            ec_del = ms.exchange_const(box, ns[0], ns[1], s, -1.0)
            dele.append(dict(slot=slot_del, sfac=s_d, m=m_d,
                             w_sum=w_d.sum(1), ec=ec_del,
                             du=-u_exist + ec_del, nf=nf_s))

        # acceptance, in log space (exact for n_or = 1)
        vol = box ** 3
        ln_u = torch.log(torch.clamp_min(dr.u_acc, tiny))
        ok_m = torch.zeros((C,), dtype=torch.bool, device=device)
        if move_on:
            ok_m = (mt <= 1) & (n_tot > 0) & ~ovr_new \
                & (dr.u_acc < torch.exp(-beta * du_move))
        ok_i, ok_d = [], []
        for s in (0, 1):
            i_s, d_s = ins[s], dele[s]
            ln_acc_i = torch.log(zs[s] * vol / (i_s["nf"] + 1.0)) + i_s["m"] \
                + torch.log(torch.clamp_min(i_s["w_sum"], tiny)) - log_k \
                - beta * i_s["ec"]
            ok_i.append((mt == 2 + 2 * s) & ~i_s["full"]
                        & (i_s["w_sum"] > 0.0) & (ln_u < ln_acc_i))
            ln_acc_d = torch.log(torch.clamp_min(d_s["nf"], 1.0)
                                 / (zs[s] * vol)) + log_k - d_s["m"] \
                - torch.log(torch.clamp_min(d_s["w_sum"], tiny)) \
                - beta * d_s["ec"]
            ok_d.append((mt == 3 + 2 * s) & (ns[s] > 0) & (ln_u < ln_acc_d))

        # apply (the branches exclude each other)
        com, quat = com.clone(), quat.clone()
        if move_on:
            com[ar, idx] = torch.where(ok_m[:, None], com_new, com_i)
            quat[ar, idx] = torch.where(ok_m[:, None], quat_new, quat_i)
            for s in (0, 1):
                mine = is_a if s == 0 else ~is_a
                a0 = torch.where(mine, a0s[s] + (idx - m0s[s]) * Ps[s], 0)
                coords = ms.write_pose(coords, a0, Ps[s], per[s][0],
                                       ok_m & mine)
        new_actives = []
        for s in (0, 1):
            i_s, d_s = ins[s], dele[s]
            mol_i = m0s[s] + i_s["slot"]
            com[ar, mol_i] = torch.where(ok_i[s][:, None], i_s["com"],
                                         com[ar, mol_i])
            quat[ar, mol_i] = torch.where(ok_i[s][:, None], i_s["quat"],
                                          quat[ar, mol_i])
            coords = ms.write_pose(coords, a0s[s] + i_s["slot"] * Ps[s],
                                   Ps[s], i_s["ra"], ok_i[s])
            new_actives.append(clear_slot(
                set_slot(actives[s], i_s["slot"], ok_i[s]), d_s["slot"],
                ok_d[s]))
            sfac = sfac + ok_i[s].to(dtype)[:, None, None] * i_s["sfac"] \
                - ok_d[s].to(dtype)[:, None, None] * d_s["sfac"]
            e = e + torch.where(ok_i[s], i_s["du"], 0.0) \
                + torch.where(ok_d[s], d_s["du"], 0.0)
        if move_on:
            sfac = sfac + ok_m.to(dtype)[:, None, None] * (s_new - s_old)
            e = e + torch.where(ok_m, du_move, 0.0)
        a_row = torch.stack([ok_m & (mt == 0), ok_m & (mt == 1), ok_i[0],
                             ok_d[0], ok_i[1], ok_d[1]], 1)
        t_row = torch.arange(6, device=device)[None, :] == mt[:, None]
        return dataclasses.replace(
            state, com=com, quat=quat, coords=coords,
            active0=new_actives[0], active1=new_actives[1], sfac=sfac,
            energy=e, acc=state.acc + a_row.to(torch.int32),
            att=state.att + t_row.to(torch.int32))

    def full_energy(state):
        return chunked_map(ms.full_one, chunk, state.com, state.quat,
                           state.coords, state.active0, state.active1,
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
            raise ValueError("mega binary GCMC requires dtype=float32 (the "
                             "whole-sweep kernel is f32)")
        if mega not in (True, "full"):
            raise ValueError(f"mega must be True or 'full': {mega!r}")
        if px >= 1.0:
            raise ValueError("mega binary GCMC needs p_exchange < 1")
        # import here: mc.moves imports nothing of this module
        from metropolismontecarlo_tpu_torch.mc.moves import make_mega_sweep_fn

    if mega == "full":
        if not 0.0 < px < 1.0:
            raise ValueError("mega='full' needs 0 < p_exchange < 1")
        if n_or != 1:
            raise ValueError("in-kernel exchanges run the unbiased algorithm "
                             "(n_orient=1); use mega=True for Rosenbluth-"
                             "biased exchanges")
        if any(abs(ev.q_t_tot) > 1e-5 for ev in evs):
            raise ValueError("in-kernel binary exchanges require charge-"
                             "neutral species (the global charge term "
                             "couples the two counts)")
        # the plain route's 0.25 px per species and direction, as a
        # deterministic per-block count of x_per / 2 attempts
        x_half = max(1, int(round(M * px / (1.0 - px) / 2.0)))
        x_per = 2 * x_half
        sweep_x = make_mega_sweep_fn(system, params, ms.kvecs, ms.kweights,
                                     device, with_activity=True,
                                     n_exch=(x_half, x_half))

        def _cycle_full(state):
            C = state.com.shape[0]
            active = torch.cat([state.active0, state.active1], 1)
            z_b = tuple(torch.full((C,), z, dtype=torch.float32,
                                   device=device) for z in zs)
            si_b = tuple(ev.self_intra(state.box) for ev in evs)
            if ms.use_lrc:
                # the own-species tail rides the wc lane, the cross term
                # folds into si from the live other-species count
                g = ms.lrc_gmat(state.box)                        # (C, 2, 2)
                wc_b = (g[:, 0, 0], g[:, 1, 1])
                lrc_cross = (g[:, 0, 1], g[:, 1, 0])
            else:
                wc_b = (torch.zeros((C,), dtype=torch.float32,
                                    device=device),) * 2
                lrc_cross = None
            com, quat, coords, active_o, sfac_o, d_e, acc6, att6 = sweep_x(
                state.com, state.quat, state.coords, active, state.box,
                state.sfac, generator, z_b, si_b, wc_b, lrc_cross=lrc_cross)
            energy, sfac_o = zero_empty(
                state.energy + d_e, sfac_o if use_ewald else state.sfac,
                active_o)
            return dataclasses.replace(
                state, com=com, quat=quat, coords=coords,
                active0=active_o[:, :caps[0]], active1=active_o[:, caps[0]:],
                sfac=sfac_o, energy=energy,
                acc=state.acc + acc6.to(torch.int32),
                att=state.att + att6.to(torch.int32))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (M + x_per))))):
                state = _cycle_full(state)
            return state

        run_steps.x_per = x_per

    elif mega:
        sweep_act = make_mega_sweep_fn(system, params, ms.kvecs, ms.kweights,
                                       device, with_activity=True)
        if px > 0.0:
            run_x = make_gcmc_binary(system, params, activities, 1.0, dtype,
                                     chunk, n_orient, device=device,
                                     generator=generator)[1]
            x_per = max(1, int(round(M * px / (1.0 - px))))
        else:
            run_x, x_per = None, 0

        def _sweep_state(state):
            active = torch.cat([state.active0, state.active1], 1)
            com, quat, coords, sfac, d_e, acc2, att2 = sweep_act(
                state.com, state.quat, state.coords, active, state.box,
                state.sfac, generator)
            pad = torch.nn.functional.pad
            return dataclasses.replace(
                state, com=com, quat=quat, coords=coords,
                sfac=sfac if use_ewald else state.sfac,
                energy=state.energy + d_e,
                acc=state.acc + pad(acc2.to(torch.int32), (0, 4)),
                att=state.att + pad(att2.to(torch.int32), (0, 4)))

        def run_steps(state, n_steps):                # noqa: F811
            for _ in range(max(1, int(round(n_steps / (M + x_per))))):
                state = _sweep_state(state)
                if run_x is not None:
                    state = run_x(state, x_per)
            return state

        run_steps.sweep = _sweep_state

    def init(box, n_init, n_chains):
        """Lattice placement of all M slots; n_init = (n0, n1): the first
        n_s slots of each species block start active."""
        n0, n1 = int(n_init[0]), int(n_init[1])
        if n0 > caps[0] or n1 > caps[1]:
            raise ValueError(f"n_init {n_init} exceeds capacities {caps}")
        if params.strict_min_image and box < 2.0 * max(params.r_cut,
                                                       params.qq_cut):
            raise ValueError(f"box {box} < 2*cutoff violates minimum-image "
                             "(set strict_min_image=False to sample the "
                             "truncated model)")
        com, quat, coords = ms.pose_lattice_init(generator, box, n_chains)

        def first(cap, n):
            return (torch.arange(cap, device=device) < n)[None].expand(
                n_chains, cap).contiguous()

        state = BinaryGCMCState(
            com=com, quat=quat, coords=coords, active0=first(caps[0], n0),
            active1=first(caps[1], n1),
            box=torch.full((n_chains,), float(box), dtype=dtype,
                           device=device),
            sfac=torch.zeros((n_chains, K, 2), dtype=dtype, device=device),
            energy=torch.zeros((n_chains,), dtype=dtype, device=device),
            acc=torch.zeros((n_chains, 6), dtype=torch.int32, device=device),
            att=torch.zeros((n_chains, 6), dtype=torch.int32, device=device))
        e, sf = full_energy(state)
        return dataclasses.replace(state, energy=e, sfac=sf)

    return init, run_steps, full_energy


class BinaryGCMC:
    """The binary muVT app as a class: blocks with the drift invariant and
    per-species N statistics (means, variances, the N0-N1 covariance).

    >>> g = BinaryGCMC(two_block_system, params, activities=(z0, z1))
    >>> st = g.init(box=10.0, n_init=(8, 8), n_chains=64)
    >>> st, stats = g.run_block(st, 2000, drift_tol=1e-9)
    """

    def __init__(self, system, params, activities, p_exchange=0.4,
                 dtype=torch.float64, chunk=8, n_orient=1, mega=None,
                 device="cuda", generator=None):
        self.params = params
        self._init, self.run_steps, self.full_energy = make_gcmc_binary(
            system, params, activities, p_exchange, dtype, chunk, n_orient,
            mega=mega, device=device, generator=generator)
        sl = system.species_slices
        self.capacities = (sl[0][2] - sl[0][1], sl[1][2] - sl[1][1])
        self._system = system

    def init(self, box, n_init, n_chains):
        return self._init(box, n_init, n_chains)

    def atom_mask(self, state):
        """(C, A_pad) per-atom activity mask (for masked observables)."""
        return binary_atom_ok(self._system, state.active0, state.active1)

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
        n0 = state.active0.sum(1).to(torch.float64)
        n1 = state.active1.sum(1).to(torch.float64)
        ratio = (state.acc - acc0) / torch.clamp_min(state.att - att0, 1)
        stats = {
            "n0_mean": float(n0.mean()),
            "n1_mean": float(n1.mean()),
            "n0_var": float(n0.var(unbiased=False)),
            "n1_var": float(n1.var(unbiased=False)),
            "cov01": float(((n0 - n0.mean()) * (n1 - n1.mean())).mean()),
            "full_frac0": float((n0 >= self.capacities[0]).double().mean()),
            "full_frac1": float((n1 >= self.capacities[1]).double().mean()),
            "energy_mean": float(e.mean()),
            "acc_trans": float(ratio[:, 0].mean()),
            "acc_rot": float(ratio[:, 1].mean()),
            "acc_insert0": float(ratio[:, 2].mean()),
            "acc_delete0": float(ratio[:, 3].mean()),
            "acc_insert1": float(ratio[:, 4].mean()),
            "acc_delete1": float(ratio[:, 5].mean()),
            "drift_max_rel": float(drift),
            "sfac_err_max": float(sfac_err),
        }
        if drift_tol is not None and not (
                stats["drift_max_rel"] < drift_tol
                and math.isfinite(stats["energy_mean"])):
            raise RuntimeError(f"energy drift over {drift_tol}: {stats}")
        return dataclasses.replace(state, energy=e, sfac=sf), stats
