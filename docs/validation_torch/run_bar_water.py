"""SPC/E hydration free energy on the card: staged decoupling against the
single-stage estimators.

The excess chemical potential of SPC/E water at 298.15 K and 0.997 g/cc
is a classic free-energy benchmark (literature ~ -24.2 kJ/mol, Hummer et
al., J. Phys. Chem. 100, 1206 (1996)), and a demonstration of why the
method matters more than the sample count: direct Widom insertion is
carried by rare cavity hits, and single-stage BAR (insertions +
deletions) assumes two work distributions that in dense water barely
overlap.  The production answer is staged decoupling: a ladder of
lambda-scaled tagged systems (mc/fep.py tag_last_molecule: the last
water is a species block of its own), each rung sampled by the ordinary
driver on the whole-sweep kernel, adjacent rungs bridged by BAR on exact
cross-lambda works (make_deletion_fn with state_system), and ghosts on
the fully decoupled rung (make_decoupled_insertion_fn).

Each sample (ghost pose or rung state) is evaluated at the four
lambda-basis systems (mc/fep.py lambda_basis: d(lj, q) = lj A + lj^2 A2
+ q B + q^2 C exactly), which gives its work at every rung in closed
form: one collection pass feeds Widom (full-coupling ghosts),
single-stage BAR, staged adjacent-rung BAR (per chain-fold: `staged_bar`)
and the pooled full-ladder MBAR solve.

    python3 docs/validation_torch/run_bar_water.py [--device cpu]
        [--n 216] [--chains 1024] [--equil 10] [--stage-equil 4]
        [--prod 12] [--equil-sweeps 250] [--block 50] [--short-ladder]
        [--seed 1] [--out FILE]

--short-ladder takes the JAX script's smoke ladder (3 LJ + 2 charging
rungs); --seed seeds the sampling (1: the JAX script's PRNGKey(1)), for
a run-to-run spread.  Writes docs/validation_torch/bar_water.txt by
default.
"""

import dataclasses
import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.fep import (
    bar_solve,
    lambda_basis,
    lambda_work,
    make_decoupled_insertion_fn,
    make_deletion_fn,
    tag_last_molecule,
)
from metropolismontecarlo_tpu_torch.mc.mbar import mbar_solve
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    random_quaternion,
    rotate_vectors,
)

KJMOL_PER_K = 1.0 / 120.272236695
N = 216            # rest-system waters
T = 298.15
RHO = 0.997        # g/cc (sets the box from N)
N_CHAINS = 1024
EQUIL_BLOCKS = 10      # stage 0, x250 sweeps
STAGE_EQUIL = 4        # per rung, x BLOCK sweeps
PROD_BLOCKS = 12       # per rung, x BLOCK sweeps
BLOCK = 50
N_INS = 128        # ghost insertions per chain per decoupled-rung block
LIT_KJMOL = -24.2
N_FOLDS = 4        # chain-folds of the error bars
CHUNK = 64         # chains per step of the ghost and deletion evaluations
F32 = torch.float32

# lambda ladder: grow LJ first (geometric at the soft end, where the
# effective core radius ~ lambda^(1/12)), then charge at full LJ
LJ_LADDER = [0.005, 0.025, 0.08, 0.2, 0.4, 0.7, 1.0]
Q_LADDER = [0.25, 0.5, 0.75, 1.0]
SHORT_LJ_LADDER, SHORT_Q_LADDER = [0.02, 0.2, 1.0], [0.5, 1.0]
LAMBDAS = ([(0.0, 0.0)] + [(lj, 0.0) for lj in LJ_LADDER]
           + [(1.0, q) for q in Q_LADDER])


def ladder(short=False):
    """LAMBDAS, or the JAX script's smoke ladder (3 LJ + 2 charging)."""
    if not short:
        return LAMBDAS
    return ([(0.0, 0.0)] + [(x, 0.0) for x in SHORT_LJ_LADDER]
            + [(1.0, x) for x in SHORT_Q_LADDER])


def box_edge(n):
    m_w = 18.01528          # g/mol
    na = 6.02214076e23
    vol_cc = n * m_w / (na * RHO)
    return (vol_cc * 1e24) ** (1.0 / 3.0)   # Angstrom


def leg_works(leg, ov0, wf0, d_at, beta):
    """(w_f (C, S), w_r (C, S')): the reduced works of leg -> leg + 1 per
    chain.  Leg 0's forward works are the decoupled rung's ghosts at rung
    1 (+inf where a ghost's core overlapped), its reverse works the
    deletion works of rung 1's samples; the other legs' are the
    cross-rung works d_at[i][j] (rung i's samples at rung j's
    parameters)."""
    if leg == 0:
        return (np.where(ov0, np.inf, beta * wf0), -beta * d_at[1][1])
    return (beta * (d_at[leg][leg + 1] - d_at[leg][leg]),
            beta * (d_at[leg + 1][leg] - d_at[leg + 1][leg + 1]))


def staged_bar(works, temperature, n_folds=N_FOLDS):
    """Staged BAR over the legs' per-chain reduced works [(w_f (C, S_f),
    w_r (C, S_r)), ...]: (mu, sem, legs, folds) with mu = T * sum of the
    legs' BAR solves on every chain, the legs' reduced dF, and sem the
    standard error of the same sum over n_folds chain-folds (folds: their
    values).  mu, sem and folds in the temperature's units."""
    legs = [bar_solve(w_f.ravel(), w_r.ravel()) for w_f, w_r in works]
    chains = np.arange(works[0][0].shape[0])
    folds = [temperature * sum(bar_solve(w_f[f].ravel(), w_r[f].ravel())
                               for w_f, w_r in works)
             for f in np.array_split(chains, n_folds)]
    sem = float(np.std(folds) / np.sqrt(len(folds)))
    return temperature * float(sum(legs)), sem, legs, folds


def mbar_mu(lambdas, gb, ov0, bases, chains, temperature):
    """F_full - F_decoupled by MBAR over the whole ladder, in the
    temperature's units: rung-0 samples are the ghost (environment, pose)
    pairs (strided to ~120,000), rungs 1.. the sampled states; every u_kn
    row is closed-form from the lambda basis.  Core-vetoed ghost poses are
    legal rung-0 samples with zero weight everywhere else."""
    beta = 1.0 / temperature
    lam_pow = np.asarray([(lj, lj * lj, q, q * q) for lj, q in lambdas])
    stride = max(1, int(np.ceil(ov0[chains].size / 120_000)))
    b0 = np.stack([x[chains].ravel()[::stride] for x in gb])
    o0 = ov0[chains].ravel()[::stride]
    cols = [b0] + [np.stack([x[chains].ravel() for x in bases[i]])
                   for i in range(1, len(lambdas))]
    n_k = [c.shape[1] for c in cols]
    allb = np.concatenate(cols, axis=1)          # (4, N_tot)
    u_kn = beta * (lam_pow @ allb)               # (K, N_tot)
    veto = np.zeros(allb.shape[1], bool)
    veto[:n_k[0]] = o0
    u_kn[1:, veto] = np.inf
    f = mbar_solve(u_kn, n_k, tol=1e-8, max_iter=50_000)
    return temperature * f[-1]


def main(argv=None):
    ap = _common.parser(__doc__, "bar_water.txt")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--stage-equil", type=int, default=STAGE_EQUIL)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--equil-sweeps", type=int, default=250)
    ap.add_argument("--block", type=int, default=BLOCK)
    ap.add_argument("--short-ladder", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_bar_water")
    lambdas = ladder(args.short_ladder)
    n, C = args.n, args.chains
    box = box_edge(n)
    r_cut = min(9.0, 0.45 * box)
    n_stage = len(lambdas)
    n_lj = sum(q == 0.0 for _, q in lambdas) - 1
    rec = _common.Record(
        dev, f"SPC/E hydration free energy by staged decoupling: N = "
        f"{n}(+tag) waters, box {box:.3f} A ({RHO} g/cc), {T} K, Ewald, "
        f"r_cut {r_cut:.1f} A + LRC, f32 whole-sweep sampling, {C} chains; "
        f"ladder {n_stage} rungs ({n_lj} LJ + {n_stage - 1 - n_lj} "
        f"charging); stage 0 {args.equil} x {args.equil_sweeps} sweeps, "
        f"then {args.prod} x {args.block} sweeps per rung after "
        f"{args.stage_equil} x {args.block}; {N_INS} ghosts per chain and "
        "decoupled-rung block" + (f"; seed {args.seed}" if args.seed != 1
                                  else ""))
    params = RunParams(temperature=T, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", use_lrc=True, p_translate=0.5,
                       dr_max=0.3, dphi_max=0.3,
                       strict_min_image=n >= 100)
    gen = _common.generator(dev, args.seed)
    systems = [tag_last_molecule(spce_system(n + 1), lj, q)
               for lj, q in lambdas]
    mcs = [MonteCarlo(s, params, device=dev, generator=gen)
           for s in systems]
    # the lambda-work basis: every cross-lambda work is exactly lj A +
    # lj^2 A2 + q B + q^2 C, so evaluating each sample at four systems,
    # (1/2, 0), (1, 0), (1, 1/2), (1, 1), gives its work at every rung
    i_lj = lambdas.index((1.0, 0.0))
    i_qh = lambdas.index((1.0, 0.5))
    i_qf = lambdas.index((1.0, 1.0))
    systems.append(tag_last_molecule(spce_system(n + 1), 0.5, 0.0))
    mcs.append(MonteCarlo(systems[-1], params, device=dev, generator=gen))
    i_ljh = len(systems) - 1               # evaluation-only system
    basis_cols = (i_ljh, i_lj, i_qh, i_qf)
    rec.gate(f"route: {mcs[0].route} (choose_route of the tagged system: "
             f"species blocks {[b[1] for b in systems[0].species]})",
             all(m.route == "sweep" for m in mcs[:n_stage]))

    dels = {}

    def del_fn(j, i):
        """U_lambda_j - U_rest on states sampled at lambda_i (the carried
        S(k) stripped of the tag at lambda_i's charges when i != j)."""
        if (j, i) not in dels:
            dels[(j, i)] = make_deletion_fn(
                systems[j], params, mcs[j].kvecs, mcs[j].kweights,
                device=dev, dtype=F32, chunk=CHUNK, species=-1,
                state_system=None if i == j else systems[i])
        return dels[(j, i)]

    ghosts_basis = [make_decoupled_insertion_fn(
        systems[j], params, mcs[0].kvecs, mcs[0].kweights, device=dev,
        dtype=F32, chunk=CHUNK) for j in basis_cols]
    m_tag = n
    a0 = int(systems[0].mol_a0[m_tag])
    body_t = torch.tensor(np.asarray(systems[0].body)[m_tag, :3],
                          dtype=F32, device=dev)

    # ---- stage 0: the decoupled rung (environment = n interacting waters)
    st = mcs[0].init_state(cubic_lattice(n + 1, box), box=box, n_chains=C)
    worst, drift_ok = 0.0, True
    stats = {"energy_mean": float("nan"), "dr_max_mean": float("nan")}
    for _ in range(args.equil):
        st, stats = mcs[0].run_block(st, args.equil_sweeps, adjust=True)
    print(f"rung 0 equilibrated: <E>/N = {stats['energy_mean'] / n:.1f} K  "
          f"dr {stats['dr_max_mean']:.2f} {rec.stamp()}", flush=True)
    g_basis, ov0 = [[] for _ in basis_cols], []
    best_com = best_quat = None
    for b in range(args.prod):
        st, stats = mcs[0].run_block(st, args.block, adjust=False)
        worst = max(worst, stats["drift_max_rel"])
        gb_ = _common.folded_generator(dev, 77, b)
        u = torch.rand((C, N_INS, 3), generator=gb_, dtype=F32,
                       device=dev) * st.box[:, None, None]
        qt = random_quaternion(gb_, (C, N_INS), F32)
        dus, o1 = [], None
        for acc, gfn in zip(g_basis, ghosts_basis):
            du, o = gfn(st, u, qt)
            acc.append(du.double().cpu().numpy())
            dus.append(acc[-1])
            o1 = o                       # one mask: the same poses
        ov0.append(o1.cpu().numpy().astype(bool))
        if b == args.prod - 1:
            # rung 1's start: each chain's lowest-energy ghost pose at
            # lambda_1 (core-free; equilibration re-thermalises), its work
            # from the basis
            du1 = lambda_work(*lambdas[1], *lambda_basis(*dus))
            pick = torch.as_tensor(np.argmin(np.where(ov0[-1], np.inf, du1),
                                             axis=1), device=dev)
            rows = torch.arange(C, device=dev)
            best_com, best_quat = u[rows, pick], qt[rows, pick]
    print(f"rung 0: {args.prod} blocks, ghosts done {rec.stamp()}",
          flush=True)

    # ---- rungs 1..K: sample each lambda, collect the 4-work basis
    d_at = [dict() for _ in range(n_stage)]   # d_at[i][j]: works of rung
    #   i's samples at rung j's parameters, (C, S)
    bases = [None] * n_stage                  # (A, A2, B, C) per rung
    for i in range(1, n_stage):
        if i == 1:
            # teleport the inert tag to its start pose
            ra = best_com[:, None, :] + rotate_vectors(best_quat,
                                                       body_t)   # (C, 3, 3)
            com, quat, coords = st.com.clone(), st.quat.clone(), \
                st.coords.clone()
            com[:, m_tag] = best_com
            quat[:, m_tag] = best_quat
            coords[:, :, a0:a0 + 3] = ra.transpose(1, 2)
            st = dataclasses.replace(st, com=com, quat=quat, coords=coords)
        st = mcs[i].resync(st)
        for _ in range(args.stage_equil):
            st, stats = mcs[i].run_block(st, args.block, adjust=True)
        cols = {j: [] for j in basis_cols}
        for b in range(args.prod):
            st, stats = mcs[i].run_block(st, args.block, adjust=False)
            worst = max(worst, stats["drift_max_rel"])
            drift_ok &= stats["drift_max_rel"] < 1e-4
            for j, acc in cols.items():
                acc.append(del_fn(j, i)(st)[0].double().cpu().numpy())
        ba = lambda_basis(*[np.concatenate(cols[j], axis=1)
                            for j in basis_cols])
        bases[i] = ba
        d_at[i] = {j: lambda_work(*lambdas[j], *ba) for j in range(n_stage)}
        lj, q = lambdas[i]
        print(f"rung {i:2d} (lj {lj:g}, q {q:g}): <d_self> = "
              f"{d_at[i][i].mean() * KJMOL_PER_K:+8.2f} kJ/mol  drift "
              f"{stats['drift_max_rel']:.1e} {rec.stamp()}", flush=True)

    # ---- works per leg, BAR per chain-fold, MBAR, the one-stage estimators
    gb = lambda_basis(*[np.concatenate(acc, axis=1) for acc in g_basis])
    ov0 = np.concatenate(ov0, axis=1)           # (C, S0)
    wf0 = lambda_work(*lambdas[1], *gb)         # ghost works at rung 1
    wfull = lambda_work(1.0, 1.0, *gb)          # ... at full coupling
    beta = 1.0 / T
    works = [leg_works(leg, ov0, wf0, d_at, beta)
             for leg in range(n_stage - 1)]
    mu_staged, sem, legs, _ = staged_bar(works, T)
    for leg, ((w_f, w_r), x) in enumerate(zip(works, legs)):
        fin = w_f[np.isfinite(w_f)]
        rec.note(f"leg {leg:2d} {lambdas[leg]} -> {lambdas[leg + 1]}: dF = "
                 f"{x * T * KJMOL_PER_K:+8.3f} kJ/mol   w_f "
                 f"{np.mean(fin):+7.2f} +- {np.std(fin):6.2f}  w_r "
                 f"{np.mean(w_r):+7.2f} +- {np.std(w_r):6.2f} kT")
        print(rec.detail[-1], flush=True)
    all_chains = np.arange(C)
    try:
        mu_mbar = mbar_mu(lambdas, gb, ov0, bases, all_chains, T)
        mbar_folds = [mbar_mu(lambdas, gb, ov0, bases, f, T)
                      for f in np.array_split(all_chains, N_FOLDS)]
        sem_mbar = float(np.std(mbar_folds) / np.sqrt(len(mbar_folds)))
    except RuntimeError as e:            # the solve did not converge
        rec.note(f"MBAR: {e}")
        mu_mbar = sem_mbar = float("nan")
    print(f"BAR and MBAR solved {rec.stamp()}", flush=True)
    boltz = np.where(ov0, 0.0, np.exp(-np.minimum(beta * wfull, 500.0)))
    mu_widom = -T * np.log(boltz.mean())
    w_f_ss = np.where(ov0, np.inf, beta * wfull).ravel()
    w_r_ss = (-beta * d_at[n_stage - 1][n_stage - 1]).ravel()
    mu_ss = T * bar_solve(w_f_ss, w_r_ss)

    to_kj = KJMOL_PER_K
    ok_staged = abs(mu_staged * to_kj - LIT_KJMOL) < max(2.5,
                                                         6.0 * sem * to_kj)
    ok_mbar = abs(mu_mbar * to_kj - LIT_KJMOL) < max(2.5,
                                                     6.0 * sem_mbar * to_kj)
    ok_agree = abs((mu_mbar - mu_staged) * to_kj) < max(
        1.5, 6.0 * (sem + sem_mbar) * to_kj)
    rec.gate(f"decoupled-rung ghosts: {wf0.size / 1e6:.2f}M "
             f"({(~ov0).mean() * 100:.1f}% core-free)")
    rec.gate(f"mu_ex (Widom-only)       = {mu_widom * to_kj:+.2f} kJ/mol "
             "(one-sided, tail-dominated; reported)")
    rec.gate(f"mu_ex (single-stage BAR) = {mu_ss * to_kj:+.2f} kJ/mol "
             "(two-state, overlap-limited; reported)")
    rec.gate(f"mu_ex (staged BAR)       = {mu_staged * to_kj:+.2f} +- "
             f"{sem * to_kj:.2f} kJ/mol ({N_FOLDS} chain-folds; gate: within "
             f"max(2.5, 6 sem) of {LIT_KJMOL})  [{_common.pf(ok_staged)}]",
             ok_staged)
    rec.gate(f"mu_ex (full-ladder MBAR) = {mu_mbar * to_kj:+.2f} +- "
             f"{sem_mbar * to_kj:.2f} kJ/mol (pooled {n_stage}-state solve "
             f"on the same samples; gate: within max(2.5, 6 sem) of "
             f"{LIT_KJMOL})  [{_common.pf(ok_mbar)}]", ok_mbar)
    rec.gate(f"MBAR - staged BAR = {(mu_mbar - mu_staged) * to_kj:+.2f} "
             f"kJ/mol (gate: within max(1.5, 6 (sem + sem_mbar)))  "
             f"[{_common.pf(ok_agree)}]", ok_agree)
    rec.gate(f"literature (SPC/E)       ~ {LIT_KJMOL} kJ/mol")
    rec.gate(f"worst block drift: {worst:.2e} (every rung block < 1e-4)  "
             f"[{_common.pf(drift_ok)}]", drift_ok)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
