"""Widom test-particle insertion: the excess chemical potential
(counterpart of metropolismontecarlo_tpu/mc/widom.py).

    mu_ex = -kT ln < exp(-beta dU_test) >_NVT

dU_test is the energy of inserting one ghost molecule at a uniform random
position and orientation into a sampled configuration.  It is exactly
the sampled model's (models/energy.py, per Coulomb style and cutoff
mode): LJ pairs (and the linear shift), the tail-correction increment,
and per style the real-space pairs, the reciprocal delta through the
carried S(k), the ghost's self and intramolecular terms (and the
surface-dipole delta), or the Wolf self term and reference constant.
The overlap veto acts as a hard core: a vetoed ghost counts 0.

`make_pose_eval` is the single-pose machinery (pair terms with an
activity mask and a molecule exclusion, pose structure factors, the
per-molecule constants), shared with the grand-canonical molecular app
(mc/gcmc_mol.py).  The JAX functions take one configuration and are
vmapped; these take a leading chains axis C and a poses axis n.
`make_widom_fn` samples ghosts with plain tensor code, for every
convention and float64; `make_mega_widom_fn` runs a sweep and the ghosts
inside one sweep-kernel launch.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.ops import wolf as wolf_ops
from metropolismontecarlo_tpu_torch.ops.lj import _shift_coeffs
from metropolismontecarlo_tpu_torch.ops.pbc import min_image
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    random_quaternion,
    rotate_vectors,
)
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR
from metropolismontecarlo_tpu_torch.utils.shard import rand_chains


def mu_excess(boltzmann_mean, temperature):
    """mu_ex = -kT ln <exp(-beta dU)> (energy units of the run, K)."""
    return -temperature * torch.log(boltzmann_mean)


def make_pose_eval(system, params, kvecs, kweights, device="cuda",
                   dtype=torch.float32, species=0):
    """Single-pose energy machinery of one species' rigid molecule; its
    tables live on `device`, the card unless the caller passes "cpu".

    Returns a namespace of functions over C chains and n poses each:

      pose_atoms(com_t (..., 3), quat_t (..., 4)) -> (..., P, 3);
      pair_energy(com_t (C, n, 3), ra (C, n, P, 3), coords_t (C, 3,
                  A_pad), com (C, M, 3), box (C,), atom_ok (C, A_pad)
                  bool, excl int | (C,) | (C, n))
          -> (e_pair (C, n), overlap (C, n)): LJ and the style's pair terms
          of each pose against every atom with atom_ok set whose molecule
          differs from excl (-1: no exclusion, a ghost); com_t is the
          cutoff key of the com/first modes;
      pose_sfac(ra (..., P, 3), box (...)) -> (..., K, 2);
      self_intra(box (...)) -> the per-molecule position-independent
          constant (ewald: self + intramolecular; wolf: self; else 0);
      wolf_const_coeff(box) -> c of E_const = c Q_tot^2 (reference Wolf);
      lrc_delta(box) -> U_lrc(N + 1) - U_lrc(N) (0 with the tail off);
      lrc_self_coeff(box) -> g with U_lrc = g N^2 for this species;
      and the fields P, q_t, q_t_tot, q_sys_tot, body_t, t_vec, use_lrc,
      mol_of_atom, real, charges_flat.
    """
    _, m0, m1, P, a0 = system.species_slices[species]
    A, A_pad, M = system.n_atoms, system.n_atoms_padded, system.n_mol

    def t(x, dt=dtype):
        return torch.tensor(np.array(x), dtype=dt, device=device)

    body_t = t(np.asarray(system.body)[m0, :P])                   # (P, 3)
    q_t_np = np.asarray(system.charges)[m0, :P]
    q_t = t(q_t_np)
    tm = np.asarray(system.type_ids)[m0, :P]

    tid = np.asarray(system.flat(system.type_ids))
    tid_safe = np.concatenate([tid, np.zeros(A_pad - A, tid.dtype)])
    eps_np = np.asarray(system.eps_table)[tm[:, None], tid_safe[None, :]]
    sig_np = np.asarray(system.sig_table)[tm[:, None], tid_safe[None, :]]
    eps_pa, sig2_pa = t(eps_np), t(sig_np ** 2)                   # (P, A_pad)
    charges_pad = np.zeros(A_pad)
    charges_pad[:A] = system.flat(system.charges)
    charges_flat = t(charges_pad)
    mol_of_atom = t(system.mol_of_atom_padded, torch.long)
    mol_a0 = t(system.mol_a0, torch.long)
    mol_safe = mol_of_atom.clamp(0, M - 1)
    real = mol_of_atom >= 0

    site = params.cutoff_mode == "site"
    use_coul = params.coulomb != "none"
    rc2, qrc2 = params.r_cut ** 2, params.qq_cut ** 2
    if params.lj_shift == "linear":
        with np.errstate(divide="ignore", invalid="ignore"):
            l1, l2 = _shift_coeffs(params.r_cut / sig_np)
            lam1_pa = t(np.where(eps_np > 0.0, l1, 0.0))
            lam2_pa = t(np.where(
                eps_np > 0.0, l2 / np.where(sig_np > 0.0, sig_np, 1.0), 0.0))

    counts_np = np.asarray(system.type_counts, np.float64)
    counts_plus_np = counts_np.copy()
    for ti in tm:
        counts_plus_np[ti] += 1.0
    counts, counts_plus = t(counts_np), t(counts_plus_np)
    eps_tab, sig_tab = t(system.eps_table), t(system.sig_table)
    use_lrc = params.use_lrc and params.lj_shift == "none"

    q_sys_tot = float(np.sum(np.asarray(system.flat(system.charges))))
    q_t_tot = float(np.sum(q_t_np))
    kv = None if kvecs is None else t(kvecs, torch.int32)

    def pose_atoms(com_t, quat_t):
        if P > 1:
            return com_t[..., None, :] + rotate_vectors(quat_t, body_t)
        return com_t[..., None, :]

    def pair_energy(com_t, ra, coords_t, com, box, atom_ok, excl):
        C, n = ra.shape[:2]
        b4 = box[:, None, None, None]
        d2 = None
        for d in range(3):
            dd = min_image(ra[:, :, :, d, None]
                           - coords_t[:, None, None, d, :], b4)
            d2 = dd * dd if d2 is None else d2 + dd * dd
        d2 = torch.clamp_min(d2, 1e-4)                         # (C, n, P, A)
        excl = torch.as_tensor(excl, device=ra.device)
        # excl -> (C | 1, n | 1, 1)
        excl = excl.reshape(excl.shape + (1,) * (3 - excl.dim()))
        base = (atom_ok[:, None, :]
                & (mol_of_atom != excl))[:, :, None, :]
        if site:
            mask_lj = base & (d2 < rc2)
            mask_qq = base & (d2 < qrc2)
        else:
            keys = com if params.cutoff_mode == "com" \
                else coords_t[:, :, mol_a0].transpose(1, 2)       # (C, M, 3)
            d2m = torch.sum(min_image(
                com_t[:, :, None, :] - keys[:, None, :, :], b4) ** 2, dim=-1)
            mask_lj = base & (d2m < rc2)[:, :, None, mol_safe]
            mask_qq = mask_lj if params.qq_r_cut is None \
                else base & (d2m < qrc2)[:, :, None, mol_safe]
            mask_lj = mask_lj.expand(C, n, P, A_pad)
            mask_qq = mask_qq.expand(C, n, P, A_pad)

        d2s = torch.where(mask_lj | mask_qq, d2, torch.ones_like(d2))
        s2 = sig2_pa / d2s
        s6 = s2 * s2 * s2
        pot = 4.0 * eps_pa * (s6 * s6 - s6)
        if params.lj_shift == "linear":
            pot = pot + eps_pa * (lam1_pa + lam2_pa * torch.sqrt(d2s))
        e = torch.sum(torch.where(mask_lj, pot, 0.0), dim=(-1, -2))

        overlap = torch.zeros((C, n), dtype=torch.bool, device=ra.device)
        if use_coul:
            kappa = (params.kappa_L / box)[:, None].expand(C, n)
            qq = q_t[:, None] * charges_flat[None, :]
            overlap = ((d2 < params.d2_overlap) & (qq < 0.0)
                       & mask_qq).flatten(2).any(-1)
            if params.coulomb == "ewald":
                e = e + ewald_ops.real_space_sum(d2, qq, mask_qq, kappa)
            elif params.coulomb == "wolf":
                e = e + wolf_ops.wolf_pair_sum(
                    d2, qq, mask_qq, kappa, params.qq_cut,
                    shifted=params.wolf_style == "pairwise")
            elif params.coulomb == "bare":
                e = e + COULOMB_FACTOR * torch.sum(
                    torch.where(mask_qq, qq / torch.sqrt(d2s), 0.0),
                    dim=(-1, -2))
            else:
                raise ValueError(params.coulomb)
        return e, overlap

    def pose_sfac(ra, box):
        return ewald_ops.structure_factor(ra, q_t, kv, box)

    def self_intra(box):
        if not use_coul or params.coulomb == "bare":
            return torch.zeros_like(box)
        kappa = params.kappa_L / box
        if params.coulomb == "ewald":
            e = ewald_ops.ewald_self(q_t, kappa)
            if P > 1:
                # orientation-independent: evaluated on the body frame
                e = e + ewald_ops.ewald_intra(body_t[None], q_t[None], kappa,
                                              box)
            return e
        return wolf_ops.wolf_self(q_t, kappa, params.qq_cut)

    def wolf_const_coeff(box):
        if params.coulomb != "wolf" or params.wolf_style == "pairwise":
            return torch.zeros_like(box)
        kappa = params.kappa_L / box
        return -COULOMB_FACTOR * torch.special.erfc(
            kappa * params.qq_cut) / params.qq_cut

    def lrc_delta(box):
        if not use_lrc:
            return torch.zeros_like(box)
        vol = box ** 3
        return (tail_ops.lrc_energy(counts_plus, eps_tab, sig_tab,
                                    params.r_cut, vol)
                - tail_ops.lrc_energy(counts, eps_tab, sig_tab,
                                      params.r_cut, vol))

    t_vec = np.bincount(tm, minlength=np.asarray(system.eps_table)
                        .shape[0]).astype(np.float64)
    c_mm = tail_ops.mol_tail_coeff(t_vec, t_vec, system.eps_table,
                                   system.sig_table, params.r_cut) \
        if use_lrc else 0.0

    def lrc_self_coeff(box):
        if c_mm == 0.0:
            return torch.zeros_like(box)
        return (tail_ops.LRC_PREFACTOR * c_mm) / box ** 3

    return SimpleNamespace(
        P=P, q_t=q_t, q_t_tot=q_t_tot, q_sys_tot=q_sys_tot, body_t=body_t,
        pose_atoms=pose_atoms, pair_energy=pair_energy, pose_sfac=pose_sfac,
        self_intra=self_intra, wolf_const_coeff=wolf_const_coeff,
        lrc_delta=lrc_delta, lrc_self_coeff=lrc_self_coeff, t_vec=t_vec,
        use_lrc=use_lrc, mol_of_atom=mol_of_atom, real=real,
        charges_flat=charges_flat)


def make_widom_fn(system, params, kvecs, kweights, device="cuda",
                  dtype=torch.float32, species=0, chunk=8):
    """The insertion evaluators of one species, in plain tensor code.

    Returns (widom_du, widom_sample):
      widom_du(state, com_t (C, n, 3), quat_t (C, n, 4))
          -> (du (C, n), overlap (C, n)): insertion energies at given
          ghost poses;
      widom_sample(state, generator, n_insertions)
          -> (C,) mean Boltzmann factor over n uniform random insertions
          per chain (vetoed ghosts count 0).
    chunk: chains per step (each holds an (n, P, A_pad) pair grid)."""
    ev = make_pose_eval(system, params, kvecs, kweights, device, dtype,
                        species)
    P, M = ev.P, system.n_mol
    kv = None if kvecs is None else torch.tensor(
        np.array(kvecs), dtype=torch.int32, device=device)
    kw = None if kweights is None else torch.tensor(
        np.array(kweights), dtype=dtype, device=device)

    def du_chunk(coords_t, com, box, sfac, com_t, quat_t):
        C, n = com_t.shape[:2]
        ra = ev.pose_atoms(com_t, quat_t)                      # (C, n, P, 3)
        du, overlap = ev.pair_energy(com_t, ra, coords_t, com, box,
                                     ev.real[None, :].expand(C, -1), -1)
        du = du + ev.lrc_delta(box)[:, None]
        if params.coulomb == "ewald":
            box_n = box[:, None].expand(C, n)
            cf = ewald_ops.cfac_coeffs(kv, kw, params.kappa_L / box, box)
            s_t = ev.pose_sfac(ra, box_n)                      # (C, n, K, 2)
            du = du + ewald_ops.recip_energy_delta(
                sfac[:, None], s_t, cf[:, None])
            du = du + ev.self_intra(box)[:, None]
            if params.ewald_surface:
                com_all = com[:, ev.mol_of_atom.clamp(0, M - 1)]
                m_tot = ewald_ops.surface_dipole(
                    coords_t.transpose(1, 2), com_all, ev.charges_flat,
                    box)[:, None]                                 # (C, 1, 3)
                mu_t = ewald_ops.surface_dipole(
                    ra, com_t[:, :, None, :], ev.q_t, box_n)
                c_surf = COULOMB_FACTOR * 2.0 * math.pi / (3.0 * box ** 3)
                m_new = m_tot + mu_t
                du = du + c_surf[:, None] * (
                    torch.sum(m_new * m_new, -1)
                    - torch.sum(m_tot * m_tot, -1))
        elif params.coulomb == "wolf":
            # the reference constant c Q^2 grows by (Q + q_t)^2 - Q^2
            dq2 = (ev.q_sys_tot + ev.q_t_tot) ** 2 - ev.q_sys_tot ** 2
            du = du + (ev.self_intra(box)
                       + ev.wolf_const_coeff(box) * dq2)[:, None]
        return du, overlap

    def widom_du(state, com_t, quat_t):
        return chunked_map(du_chunk, chunk, *(x.to(dtype) for x in (
            state.coords, state.com, state.box, state.sfac, com_t, quat_t)))

    def widom_sample(state, generator, n_insertions):
        C = state.com.shape[0]
        # chain-global under a shard context (utils/shard.py)
        u = rand_chains((C, n_insertions, 3), generator, dtype,
                        generator.device)
        com_t = u * state.box.to(dtype)[:, None, None]
        if P > 1:
            quat_t = random_quaternion(generator, (C, n_insertions), dtype)
        else:
            quat_t = torch.zeros((C, n_insertions, 4), dtype=dtype,
                                 device=com_t.device)
            quat_t[..., 0] = 1.0
        du, ovr = widom_du(state, com_t, quat_t)
        beta_du = du / state.temp.to(dtype)[:, None]
        return torch.where(ovr, 0.0, torch.exp(-beta_du)).mean(dim=-1)

    return widom_du, widom_sample


def make_mega_widom_fn(system, params, kvecs, kweights, n_per_sweep,
                       device="cuda"):
    """Widom sampling inside the sweep kernel: one launch runs a full
    move sweep and n_per_sweep ghost insertions per chain on the state the
    sweep left (ops/cuda/sweep_kernel n_widom: an in-kernel insertion
    attempt with the writes removed).

    Returns widom_mega(state, generator) -> (state', b_mean): the
    SimState advanced by one sweep at params.temperature / dr_max /
    dphi_max (the per-chain adapted fields are not read, as in
    mc/gcmc_mol's kernel routes), its step grown by M + n_per_sweep; and
    b_mean (C,), the mean of exp(-beta dU_ins) over the ghosts, for
    `mu_excess(b_mean, params.temperature)`.  dU is widom_du's model: the
    position-independent tail increment is folded in here, vetoed ghosts
    count 0, and the reference-Wolf constant uses the kernel's own-count
    rule (exact for one species).  Needs the whole-sweep route's
    conventions, one species block and no Ewald surface term.  Runs on
    the card unless the caller passes device="cpu" (then the kernel's
    plain version runs)."""
    # import here: mc.moves imports nothing of this module, and this keeps
    # it so
    from metropolismontecarlo_tpu_torch.mc.moves import make_mega_sweep_fn

    if int(n_per_sweep) < 1:
        raise ValueError("n_per_sweep must be >= 1 (with 0 ghost "
                         "insertions make_mega_sweep_fn returns the "
                         "7-argument sweep_act and the call below would "
                         "fail; use the plain sweep route for sweeps "
                         "without sampling)")
    if params.ewald_surface:
        raise ValueError("kernel Widom does not support the Ewald "
                         "surface term (pose-dependent dipole delta)")
    if len(system.species_slices) != 1:
        raise ValueError("kernel Widom supports single-species systems; "
                         "use make_widom_fn for mixtures")
    n_per_sweep = int(n_per_sweep)
    sweep_x = make_mega_sweep_fn(system, params, kvecs, kweights, device,
                                 with_activity=True, n_exch=0,
                                 n_widom=n_per_sweep)
    ev = make_pose_eval(system, params, kvecs, kweights, device,
                        torch.float32)
    M = system.n_mol
    beta = 1.0 / float(params.temperature)
    q2 = ev.q_t_tot ** 2
    use_sfac = params.coulomb == "ewald"

    def widom_mega(state, generator):
        C = state.com.shape[0]
        box = state.box.to(torch.float32)
        active = torch.ones((C, M), dtype=torch.bool, device=box.device)
        si = ev.self_intra(box)
        wc = ev.wolf_const_coeff(box) * q2
        zact = torch.ones_like(box)         # not read when n_exch == 0
        com, quat, coords, _, sfac, d_e, acc, att, wid = sweep_x(
            state.com, state.quat, state.coords, active, box, state.sfac,
            generator, zact, si, wc)
        b_mean = wid[:, 0, 0] / float(n_per_sweep) \
            * torch.exp(-beta * ev.lrc_delta(box))
        dtype = state.com.dtype
        pad = torch.nn.functional.pad       # [trans, rot] -> [t, r, vol]
        state2 = dataclasses.replace(
            state, com=com.to(dtype), quat=quat.to(dtype),
            coords=coords.to(dtype),
            sfac=sfac.to(dtype) if use_sfac else state.sfac,
            energy=state.energy + d_e.to(state.energy.dtype),
            step=state.step + M + n_per_sweep,
            acc=state.acc + pad(acc[:, :2].to(torch.int32), (0, 1)),
            att=state.att + pad(att[:, :2].to(torch.int32), (0, 1)))
        return state2, b_mean

    return widom_mega
