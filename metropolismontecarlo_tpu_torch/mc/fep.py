"""Free-energy perturbation: deletion energies, staged decoupling and the
Bennett acceptance ratio (counterpart of metropolismontecarlo_tpu/mc/fep.py).

Widom insertion (mc/widom.py) estimates mu_ex from one direction only.
The Bennett acceptance ratio (Bennett, J. Comput. Phys. 22, 245 (1976);
Frenkel & Smit ch. 7.2) combines those forward samples with reverse
samples, the energies of deleting real molecules from the (N+1)-molecule
ensemble, into the minimum-variance two-state estimator:

  A = N-system x one ideal ghost uniform in V      Z_A = V * Z_N
  B = (N+1)-system                                  Z_B = Z_{N+1}
  beta * mu_ex = -ln(Z_B / Z_A)

  forward work  w_F = beta * dU_insert   (Widom ghosts, sampled in A)
  reverse work  w_R = -beta * dU_delete  (real molecules, sampled in B;
                                          every molecule of the species
                                          is a valid reverse sample)

`make_deletion_fn` evaluates dU_delete = U(N+1) - U(N without molecule m)
exactly per the sampled model (the Widom ghosts' terms: LJ and the tail
decrement, real / reciprocal / self / intra Ewald with the carried S(k),
the Wolf constants, the surface dipole), so insertion and deletion are
reciprocal number for number.  Staged decoupling: `tag_last_molecule`
builds (N+1)-molecule systems whose last molecule carries lambda-scaled
LJ and charges (ordinary Systems, sampled by the ordinary driver),
`make_deletion_fn(..., species=-1)` on a stage gives U_lambda - U_rest,
and `make_decoupled_insertion_fn` supplies ghost samples of the fully
decoupled first rung; beta mu_ex is the sum of the adjacent-stage BAR
legs.  These run in plain tensor code (no kernel) batched over chains;
the estimators are host numpy in float64.
"""

import dataclasses
import functools
import math

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_ops
from metropolismontecarlo_tpu_torch.ops import tail as tail_ops
from metropolismontecarlo_tpu_torch.utils.chunking import chunked_map
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR


def _lrc_change(system, params, m0, P, device, dtype):
    """lrc(box (C,)) -> U_lrc(N) - U_lrc(N - 1) of removing one molecule
    of the block starting at molecule m0 (0 without the tail)."""
    if not (params.use_lrc and params.lj_shift == "none"):
        return lambda box: torch.zeros_like(box)
    tm = np.asarray(system.type_ids)[m0, :P]
    counts = np.asarray(system.type_counts, np.float64)
    counts_minus = counts.copy()
    for t in tm:
        counts_minus[t] -= 1.0

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    counts, counts_minus = t(counts), t(counts_minus)
    eps_tab, sig_tab = t(system.eps_table), t(system.sig_table)

    def lrc(box):
        vol = box ** 3
        return (tail_ops.lrc_energy(counts, eps_tab, sig_tab, params.r_cut,
                                    vol)
                - tail_ops.lrc_energy(counts_minus, eps_tab, sig_tab,
                                      params.r_cut, vol))

    return lrc


def _kspace(kvecs, kweights, device, dtype):
    kv = None if kvecs is None else torch.tensor(
        np.asarray(kvecs), dtype=torch.int32, device=device)
    kw = None if kweights is None else torch.tensor(
        np.asarray(kweights), dtype=dtype, device=device)
    return kv, kw


def make_deletion_fn(system, params, kvecs, kweights, device="cuda",
                     dtype=torch.float32, species=0, chunk=8,
                     state_system=None):
    """Build deletion_du(state) -> (du (C, n_sp), overlap (C, n_sp)): the
    exact energy attributable to each molecule of the species, dU_m =
    U(state) - U(state minus molecule m), for every molecule and chain.
    overlap mirrors the pair evaluator's hard-core flag (always False on
    configurations the chain itself sampled).  state: a SimState (fields
    coords, com, box, sfac); chunk: chains per step (each holds an (n_sp,
    P, A_pad) pair grid); device: the card unless the caller passes "cpu".

    state_system: the System the state was sampled with, when it differs
    from `system` (staged-FEP cross-lambda works, U_lambda' - U_rest on
    lambda-rung samples).  The state's carried S(k) holds the molecule at
    the state system's charges, so the reciprocal delta strips that
    contribution before adding this system's: E(S_rest + s_eval) -
    E(S_rest) with S_rest = sfac - s_state."""
    ev = make_pose_eval(system, params, kvecs, kweights, device, dtype,
                        species)
    _, m0, m1, P, _ = system.species_slices[species]
    M = system.n_mol
    mols = torch.arange(m0, m1, device=device)
    cols = torch.as_tensor(np.asarray(system.mol_a0)[m0:m1], device=device
                           )[:, None] + torch.arange(P, device=device)
    kv, kw = _kspace(kvecs, kweights, device, dtype)
    q_state_t = None
    if state_system is not None:
        q_state_t = torch.tensor(np.asarray(state_system.charges)[m0, :P],
                                 dtype=dtype, device=device)
    lrc_dec = _lrc_change(system, params, m0, P, device, dtype)

    def chain(coords_t, com, box, sfac):
        C, n = coords_t.shape[0], m1 - m0
        ra = coords_t[:, :, cols].permute(0, 2, 3, 1)          # (C, n, P, 3)
        com_t = com[:, m0:m1]
        du, overlap = ev.pair_energy(com_t, ra, coords_t, com, box,
                                     ev.real[None, :].expand(C, -1),
                                     mols[None, :])
        du = du + lrc_dec(box)[:, None]
        box_n = box[:, None].expand(C, n)
        if params.coulomb == "ewald":
            cf = ewald_ops.cfac_coeffs(kv, kw, params.kappa_L / box,
                                       box)[:, None]
            s_m = ev.pose_sfac(ra, box_n)
            if q_state_t is None:
                # E(S) - E(S - s_m) = -[E(S + (-s_m)) - E(S)]
                du = du - ewald_ops.recip_energy_delta(sfac[:, None], -s_m,
                                                       cf)
            else:
                s_state = ewald_ops.structure_factor(ra, q_state_t, kv,
                                                     box_n)
                du = du + ewald_ops.recip_energy_delta(
                    sfac[:, None] - s_state, s_m, cf)
            du = du + ev.self_intra(box)[:, None]
            if params.ewald_surface:
                com_all = com[:, ev.mol_of_atom.clamp(0, M - 1)]
                m_tot = ewald_ops.surface_dipole(
                    coords_t.transpose(1, 2), com_all, ev.charges_flat, box)
                mu_m = ewald_ops.surface_dipole(ra, com_t[:, :, None, :],
                                                ev.q_t, box_n)
                c_surf = COULOMB_FACTOR * 2.0 * math.pi / (3.0 * box ** 3)
                m_old = m_tot[:, None] - mu_m
                du = du + c_surf[:, None] * (
                    torch.sum(m_tot * m_tot, -1)[:, None]
                    - torch.sum(m_old * m_old, -1))
        elif params.coulomb == "wolf":
            # the reference-convention constant: Q^2 - (Q - q_t)^2
            dq2 = ev.q_sys_tot ** 2 - (ev.q_sys_tot - ev.q_t_tot) ** 2
            du = du + (ev.self_intra(box)
                       + ev.wolf_const_coeff(box) * dq2)[:, None]
        return du, overlap

    def deletion_du(state):
        return chunked_map(chain, chunk, state.coords.to(dtype),
                           state.com.to(dtype), state.box.to(dtype),
                           state.sfac.to(dtype))

    return deletion_du


@functools.lru_cache(maxsize=None)
def tag_last_molecule(system, lj_scale=1.0, q_scale=1.0):
    """A copy of `system` whose LAST molecule is an independent
    single-molecule species block ("<name>_tag") with scaled
    interactions — the staged-decoupling building block:

      U_lambda = U_rest + lj_scale * U_LJ(tag, rest)
                        + q_scale  * U_qq_linear + q_scale^2 * U_qq_self

    Charges scale by q_scale directly.  LJ scaling goes through NEW
    atom types (ids offset by T) whose mixed-table entries carry
    lj_scale on tag-rest rows and lj_scale^2 on tag-tag, with sigmas
    unchanged, so pair energies AND tail corrections scale exactly.

    At lj_scale == 0.0 the tagged sigmas are set to the pad value 1.0:
    a fully decoupled molecule may legally sit on top of another atom
    (distance floored at 1e-4 A^2), where an unscaled sigma overflows
    s12 to +inf in f32 and 0*inf would poison the zero-epsilon product
    with NaN — the same contract pad slots rely on (models/system.py).

    Sampling the returned system with the ordinary driver gives the
    lambda-stage ensemble; `make_deletion_fn(..., species=-1)` gives
    U_lambda - U_rest on its samples (the BAR work ingredient), and the
    lambda = (0, 0) system's total energy is EXACTLY the rest-system
    energy (gated by tests/test_torch_fep_mbar.py).
    """
    m_last = system.n_mol - 1
    t = int(system.eps_table.shape[0])
    charges = np.array(system.charges, np.float64)
    charges[m_last] = q_scale * charges[m_last]
    type_ids = np.array(system.type_ids, np.int32)
    type_ids[m_last] = t + type_ids[m_last]

    eps = np.asarray(system.eps_table, np.float64)
    sig = np.asarray(system.sig_table, np.float64)
    eps_new = np.zeros((2 * t, 2 * t))
    eps_new[:t, :t] = eps
    eps_new[t:, :t] = lj_scale * eps
    eps_new[:t, t:] = lj_scale * eps
    eps_new[t:, t:] = (lj_scale**2) * eps
    sig_new = np.tile(sig, (2, 2))
    if lj_scale == 0.0:
        sig_new[t:, :] = 1.0
        sig_new[:, t:] = 1.0

    blocks = system.species
    if blocks is None:
        blocks = ((system.name, system.n_mol, system.atoms_per_mol),)
    name, count, p = blocks[-1]
    assert count >= 1
    head = blocks[:-1] + (((name, count - 1, p),) if count > 1 else ())
    species = head + ((name + "_tag", 1, p),)

    return dataclasses.replace(
        system, charges=charges, type_ids=type_ids, eps_table=eps_new,
        sig_table=sig_new, species=species,
        name=f"{system.name}_tag[{lj_scale:g},{q_scale:g}]")


def make_decoupled_insertion_fn(sys_tag, params, kvecs, kweights,
                                device="cuda", dtype=torch.float32, chunk=8):
    """Ghost insertions of `sys_tag`'s tagged molecule (its last species
    block, from `tag_last_molecule`) into states sampled from the fully
    decoupled stage (lj_scale = q_scale = 0), where the state's own tagged
    molecule is inert: its pose is uniform and independent, so arbitrary
    ghost poses are extra exact samples of that ensemble (the Widom trick
    on the first rung of a lambda ladder).

    Returns fn(state, com_t (C, n, 3), quat_t (C, n, 4)) -> (du (C, n),
    overlap (C, n)) with du = U_lambda(x with the tag at the pose) - U_0(x):
    the tagged pair terms under sys_tag's scaled parameters (the state's
    inert tagged molecule excluded), the tail increment, and for Ewald the
    reciprocal delta against the state's S(k) (which holds no tagged
    contribution at lambda = 0) plus self / intra; for Wolf the self and
    total-charge-constant increments.  Staged decoupling is defined under
    tinfoil boundaries: the surface term is refused."""
    if params.ewald_surface:
        raise ValueError("staged decoupling is defined under tinfoil "
                         "boundaries")
    species = len(sys_tag.species_slices) - 1
    ev = make_pose_eval(sys_tag, params, kvecs, kweights, device, dtype,
                        species)
    _, m0, m1, P, _ = sys_tag.species_slices[species]
    if m1 - m0 != 1:
        raise ValueError("the tagged block must hold exactly one molecule")
    kv, kw = _kspace(kvecs, kweights, device, dtype)
    lrc_inc = _lrc_change(sys_tag, params, m0, P, device, dtype)
    q_env_tot = ev.q_sys_tot - ev.q_t_tot

    def chain(coords_t, com, box, sfac, com_t, quat_t):
        C, n = com_t.shape[:2]
        ra = ev.pose_atoms(com_t, quat_t)
        du, overlap = ev.pair_energy(com_t, ra, coords_t, com, box,
                                     ev.real[None, :].expand(C, -1), m0)
        du = du + lrc_inc(box)[:, None]
        if params.coulomb == "ewald":
            cf = ewald_ops.cfac_coeffs(kv, kw, params.kappa_L / box,
                                       box)[:, None]
            s_t = ev.pose_sfac(ra, box[:, None].expand(C, n))
            du = du + ewald_ops.recip_energy_delta(sfac[:, None], s_t, cf) \
                + ev.self_intra(box)[:, None]
        elif params.coulomb == "wolf":
            dq2 = (q_env_tot + ev.q_t_tot) ** 2 - q_env_tot ** 2
            du = du + (ev.self_intra(box)
                       + ev.wolf_const_coeff(box) * dq2)[:, None]
        return du, overlap

    def ghost_du(state, com_t, quat_t):
        return chunked_map(chain, chunk, state.coords.to(dtype),
                           state.com.to(dtype), state.box.to(dtype),
                           state.sfac.to(dtype), com_t.to(dtype),
                           quat_t.to(dtype))

    return ghost_du


def lambda_basis(d_ljhalf, d_lj, d_half, d_full):
    """Per-sample (A, A2, B, C) basis of the tagged-molecule
    interaction.

    `tag_last_molecule` scales make every cross-lambda work an EXACT
    low-order polynomial in (lj, q):

        d(lj, q) = U_(lj,q) - U_rest = lj*A + lj^2*A2 + q*B + q^2*C

    A: tag-rest LJ pairs + the tag-rest tail rows (the eps table's
    tag-rest entries carry lj directly, not an LB sqrt, and LJ is
    linear in eps).  A2: the tag-TAG tail-correction self term (the
    doubled table's tag-tag block scales as lj^2) — small (~3 K for an
    SPC/E tag at V ~ 1.7e3 A^3) but measurably there; a 3-term basis
    without it reconstructs works ~0.6 K wrong.  B: real-space coulomb
    cross terms and the linear recip cross 2 q Re(S_rest . s_tag*).
    C: recip |s_tag|^2 plus the self and intra constants.  There is no
    lj*q cross term (LJ and coulomb never multiply).

    Four ladder works per sample recover the basis:
    d_ljhalf = d(1/2, 0), d_lj = d(1, 0), d_half = d(1, 1/2),
    d_full = d(1, 1) — and then the FULL (K, N) MBAR matrix over any
    lambda ladder is closed-form (gated to fp precision by
    tests/test_torch_fep_mbar.py).

    Returns (A, A2, B, C) arrays of the inputs' shape.
    """
    e1 = np.asarray(d_lj, np.float64)            # A + A2
    e2 = np.asarray(d_ljhalf, np.float64)        # A/2 + A2/4
    a = 4.0 * e2 - e1
    a2 = e1 - a
    d2 = np.asarray(d_half, np.float64) - e1     # B/2 + C/4
    d3 = np.asarray(d_full, np.float64) - e1     # B + C
    b = 4.0 * d2 - d3
    c = d3 - b
    return a, a2, b, c


def lambda_work(lj, q, a, a2, b, c):
    """d(lj, q) from a `lambda_basis` decomposition."""
    return lj * a + (lj * lj) * a2 + q * b + (q * q) * c


def _expit(z):
    """Numerically stable logistic 1/(1+exp(-z)) (host NumPy)."""
    return 0.5 * (1.0 + np.tanh(0.5 * z))


def bar_solve(w_f, w_r, tol=1e-12, max_iter=200):
    """Solve Bennett's self-consistent equation for the reduced free-
    energy difference x = beta*(F_B - F_A) given reduced works
    w_f = beta*(U_B - U_A) on A-samples and w_r = beta*(U_A - U_B) on
    B-samples:

        sum_i expit(x - M - w_f_i) = sum_j expit(-x - M' ... )

    i.e. the standard form  sum_F 1/(1+exp(M + w_F - x)) =
    sum_R 1/(1+exp(-M + w_R + x)),  M = ln(n_F/n_R).

    The left side is increasing and the right decreasing in x, so the
    root is unique; solved by bisection (robust to +inf works from
    overlap-vetoed insertions, which contribute zero).
    """
    # works beyond +-1e6 reduced units are indistinguishable from +-inf
    # through the logistic (contribute exactly 0/1 weight) but would
    # inflate the bisection bracket by orders of magnitude — clip.
    w_f = np.clip(np.asarray(w_f, np.float64).ravel(), -1e6, 1e6)
    w_r = np.clip(np.asarray(w_r, np.float64).ravel(), -1e6, 1e6)
    n_f, n_r = w_f.size, w_r.size
    assert n_f > 0 and n_r > 0
    m = np.log(n_f / n_r)

    def g(x):
        lhs = _expit(x - m - w_f)          # 1/(1+exp(M + w_F - x))
        rhs = _expit(m - w_r - x)          # 1/(1+exp(-M + w_R + x))
        return np.sum(lhs) - np.sum(rhs)

    # bracket the root: g is increasing in x
    finite = w_f[np.isfinite(w_f)]
    lo = min(np.min(finite, initial=0.0), np.min(-w_r, initial=0.0)) - 50.0
    hi = max(np.max(finite, initial=0.0), np.max(-w_r, initial=0.0)) + 50.0
    assert g(lo) < 0.0 < g(hi), "BAR root not bracketed (no overlap?)"
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        if g(mid) < 0.0:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


def bar_mu_ex(du_insert, overlap_insert, du_delete, temperature):
    """Excess chemical potential from BAR (energy units of the run).

    du_insert (any shape): Widom ghost insertion energies sampled in the
    N-molecule ensemble (mc/widom.make_widom_fn's widom_du), with
    overlap_insert marking hard-core-vetoed ghosts (infinite work).
    du_delete: per-molecule deletion energies sampled in the
    (N+1)-molecule ensemble (make_deletion_fn).  temperature: kT in the
    same units (per-chain ladders must reweight before pooling).
    """
    beta = 1.0 / float(temperature)
    w_f = np.where(np.asarray(overlap_insert, bool),
                   np.inf, beta * np.asarray(du_insert, np.float64))
    w_r = -beta * np.asarray(du_delete, np.float64)
    return float(temperature) * bar_solve(w_f, w_r)
