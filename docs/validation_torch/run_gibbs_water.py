"""SPC/E liquid-vapour coexistence at 450 K by Gibbs-ensemble MC on the
card, with the LJ tail corrections in every transfer and volume move.

The two-box Gibbs ensemble (mc/gibbs_mol.py MolGibbsEnsemble, in-kernel
transfers: mega="full", csrc/gibbs_kernel.cu) finds both coexistence
densities in one run.  Gates, per state point: a real density gap
(rho_l / rho_v > 8); mu-equality of the two boxes by two-sided BAR
(mc/fep.py bar_mu_ex on per-box ghost insertions and real deletions,
beta mu = ln rho + beta mu_ex); the carried structure factors and
energies against the recompute.  With the tails on (the default), two
full measurements at r_cut 7.5 and 8.5 A must agree on rho_l, rho_v and
dH_vap within their combined error (a tail-corrected model's coexistence
does not depend on where the LJ sum is cut), and land in wide
published-spread windows.  --no-lrc runs the bare truncated model at
r_cut 7.5 against loose bands instead.

    python3 docs/validation_torch/run_gibbs_water.py [--device cpu]
        [--chains 96] [--preeq 25] [--preeq-steps 12000] [--equil 3]
        [--prod 24] [--steps 6000] [--works 256] [--mega full|hybrid]
        [--no-lrc] [--parts 7.5 8.5] [--partials DIR]
        [--out FILE]

--parts runs one of the two state points (saved to --partials); the
process that finds both there writes the record.
Writes docs/validation_torch/gibbs_water_lrc.txt by default
(gibbs_water.txt with --no-lrc).
"""

import dataclasses
import os
import sys
import time

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.fep import bar_mu_ex
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.observables import heat_of_vaporization
from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters
from metropolismontecarlo_tpu_torch.utils.constants import AVOGADRO

T = 450.0
CAP = 256
M_WATER = 18.015268
N_CHAINS = 96
EQUIL_BLOCKS = 3
PROD_BLOCKS = 24
BLOCK_STEPS = 6000
PREEQ_BLOCKS, PREEQ_STEPS = 25, 12000
USE_LRC = True
RHO_L_BAND = (0.68, 0.92)            # the --no-lrc bands
RHO_V_BAND = (0.0, 0.06)
WORKS_BATCHES, WORKS_N = 6, 256      # ghost / deletion batches per block
CHUNK = 48                           # chains per step of recomputes, works
# the state points, (requested r_cut, seed): the second only with the tails
POINTS = {"7.5": (7.5, 3), "8.5": (8.5, 11)}


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def run_one(r_cut_req, seed, args, dev, t0):
    """One full coexistence measurement at a requested r_cut: box-role
    resolved densities (ratio of means), dH_vap, the two-sided-BAR
    mu-equality and the drift / S(k) invariants."""
    n_l, n_v = (2 * CAP) // 3, CAP // 6
    box_l = (n_l / (0.80 / M_WATER * AVOGADRO * 1e-24)) ** (1.0 / 3.0)
    box_v = (n_v / (0.015 / M_WATER * AVOGADRO * 1e-24)) ** (1.0 / 3.0)
    # min-image headroom: the liquid box densifies to ~18 A at 0.85 g/cc
    r_cut = min(r_cut_req, 0.47 * box_l)
    l_max = (box_l**3 + box_v**3) ** (1.0 / 3.0)
    kl, nk, ksq = tune_parameters(l_max, r_cut, 1e-3)
    params = RunParams(temperature=T, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       use_lrc=args.lrc, p_translate=0.5, p_volume=0.01,
                       dr_max=0.4, dphi_max=0.6)
    mega, n_or = {"full": ("full", 1), "hybrid": (True, 8)}[args.mega]
    gen = _common.generator(dev, seed)
    g = MolGibbsEnsemble(spce_system(CAP), params, dv_max=0.03,
                         p_transfer=0.4, dtype=torch.float32,
                         n_orient=n_or, chunk=CHUNK, mega=mega,
                         device=dev, generator=gen)
    st = g.init(boxes=(box_l, box_v), n_init=(n_l, n_v),
                n_chains=args.chains)
    print(f"r_cut {r_cut:.1f}: boxes ({box_l:.2f}, {box_v:.2f}) A, tuned "
          f"kappa_L {kl:.1f} nk {nk}", flush=True)
    # pre-equilibrate each box with exchanges off (a lattice liquid
    # evaporates if transfers open at once), on the same generator
    g_eq = MolGibbsEnsemble(spce_system(CAP),
                            dataclasses.replace(params, p_volume=0.0),
                            dv_max=0.03, p_transfer=0.0,
                            dtype=torch.float32, n_orient=8,
                            chunk=CHUNK, mega=True, device=dev,
                            generator=gen)
    for b in range(args.preeq):
        st, stats = g_eq.run_block(st, args.preeq_steps)
        if b % 10 == 0 or b == args.preeq - 1:
            print(f"  pre-eq {b}: rho_l {g_per_cc(stats['rho_liq']):.4f}  "
                  f"[{time.perf_counter() - t0:.0f} s]", flush=True)
    worst = 0.0
    for b in range(args.equil):
        st, stats = g.run_block(st, args.steps)
        worst = max(worst, stats["drift_max_rel"])
        print(f"  equil {b}: rho_l {g_per_cc(stats['rho_liq']):.4f}  rho_v "
              f"{g_per_cc(stats['rho_vap']):.4f}  accX "
              f"{stats['acc_transfer']:.3f}  [{time.perf_counter() - t0:.0f}"
              " s]", flush=True)
    nsum, vsum = np.zeros(2), np.zeros(2)
    rls, rvs, dmu_blocks, dh_blocks = [], [], [], []
    worst_sfac, full = 0.0, 0.0
    for b in range(args.prod):
        st, stats = g.run_block(st, args.steps)
        worst = max(worst, stats["drift_max_rel"])
        worst_sfac = max(worst_sfac, stats["sfac_err_max"])
        full = max(full, stats["full_frac"])
        dh_blocks.append(float(np.mean(
            heat_of_vaporization(st, g.pressure_fd(st)))))
        n_box = st.active.sum(2).double().cpu().numpy()
        v_box = st.box.double().cpu().numpy() ** 3
        order = np.argsort(-(n_box / v_box), axis=1)           # liq first
        n_o = np.take_along_axis(n_box, order, 1).mean(axis=0)
        v_o = np.take_along_axis(v_box, order, 1).mean(axis=0)
        nsum += n_o
        vsum += v_o
        rho_b = n_o / v_o
        # two-sided BAR works: WORKS_BATCHES x WORKS_N ghosts and deletions
        di_b, ov_b, dd_b = [], [], []
        o3 = order[:, :, None]
        for _ in range(WORKS_BATCHES):
            di, ov, dd = g.widom_works(st, args.works, args.works)
            di_b.append(np.take_along_axis(di.double().cpu().numpy(), o3, 1))
            ov_b.append(np.take_along_axis(ov.cpu().numpy(), o3, 1))
            dd_b.append(np.take_along_axis(dd.double().cpu().numpy(), o3, 1))
        bmu_b = np.empty(2)
        for role in (0, 1):
            du_i = np.concatenate([x[:, role].ravel() for x in di_b])
            ov_i = np.concatenate([x[:, role].ravel() for x in ov_b])
            du_d = np.concatenate([x[:, role].ravel() for x in dd_b])
            # widom_works gives the deletion energy change; BAR wants the
            # molecule's energy content in the (N+1) ensemble, its negative
            mu_ex = bar_mu_ex(du_i, ov_i, -du_d, T)
            bmu_b[role] = np.log(rho_b[role]) + mu_ex / T
        dmu_blocks.append(bmu_b[0] - bmu_b[1])
        rls.append(g_per_cc(stats["rho_liq"]))
        rvs.append(g_per_cc(stats["rho_vap"]))
        print(f"  prod {b}: rho_l {rls[-1]:.4f} rho_v {rvs[-1]:.4f} dmu "
              f"{dmu_blocks[-1]:+.3f} drift {stats['drift_max_rel']:.1e} "
              f"sfac {stats['sfac_err_max']:.1e}  "
              f"[{time.perf_counter() - t0:.0f} s]", flush=True)
    rho = nsum / vsum
    dmu_blocks = np.asarray(dmu_blocks)
    n_b = max(len(rls), 1)
    return dict(
        r_cut=r_cut, kl=kl, nk=nk,
        rho_l=g_per_cc(rho[0]), rho_v=g_per_cc(rho[1]),
        sem_l=float(np.std(rls) / np.sqrt(n_b)),
        sem_v=float(np.std(rvs) / np.sqrt(n_b)),
        dmu=float(dmu_blocks.mean()),
        sem_mu=float(dmu_blocks.std() / np.sqrt(n_b)),
        dh=float(np.mean(dh_blocks) * 8.31446e-3),
        sem_dh=float(np.std(dh_blocks) / np.sqrt(n_b) * 8.31446e-3),
        worst=worst, worst_sfac=worst_sfac, full=full)


def gates_one(r, rec):
    """Per-state-point gates: phases separated, mu-equality, invariants,
    the capacity never full."""
    mu_tol = max(0.2, 4.0 * r["sem_mu"])
    ok = (r["rho_l"] / max(r["rho_v"], 1e-9) > 8.0
          and abs(r["dmu"]) < mu_tol
          and r["worst_sfac"] < 1e-3 and r["worst"] < 5e-3
          and r["full"] == 0.0)
    rec.gate(f"r_cut {r['r_cut']:.1f}: rho_l {r['rho_l']:.4f} +- "
             f"{r['sem_l']:.4f}  rho_v {r['rho_v']:.4f} +- {r['sem_v']:.4f} "
             f"g/cc  dH_vap {r['dh']:.1f} +- {r['sem_dh']:.1f} kJ/mol  dmu "
             f"{r['dmu']:+.3f} +- {r['sem_mu']:.3f} (tol {mu_tol:.2f})  sfac "
             f"{r['worst_sfac']:.1e}  drift {r['worst']:.1e}  full_frac "
             f"{r['full']:.3f}  [{_common.pf(ok)}]", ok)
    return ok


def main(argv=None):
    ap = _common.parser(__doc__, "gibbs_water_lrc.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--preeq", type=int, default=PREEQ_BLOCKS)
    ap.add_argument("--preeq-steps", type=int, default=PREEQ_STEPS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--steps", type=int, default=BLOCK_STEPS)
    ap.add_argument("--mega", choices=("full", "hybrid"), default="full")
    ap.add_argument("--no-lrc", dest="lrc", action="store_false",
                    default=USE_LRC)
    ap.add_argument("--works", type=int, default=WORKS_N,
                    help="ghosts and deletions per works batch")
    _common.add_parts(ap, POINTS)
    args = ap.parse_args(argv)
    if not args.lrc and args.out == os.path.join(_common.HERE,
                                                 "gibbs_water_lrc.txt"):
        args.out = os.path.join(_common.HERE, "gibbs_water.txt")
    dev = _common.device_of(args, "run_gibbs_water")
    t0 = time.perf_counter()
    rec = _common.Record(
        dev, f"{args.chains} chains x 2 boxes, cap {CAP}, T {T} K, transfers "
        + ("in the Gibbs kernel (mega=\"full\", n_orient=1)"
           if args.mega == "full" else "plain Rosenbluth n_orient=8")
        + f", f32; per state point {args.preeq} pre-eq blocks x "
        f"{args.preeq_steps} + {args.equil}+{args.prod} blocks x "
        f"{args.steps} steps/chain, {WORKS_BATCHES} x {args.works} ghosts "
        f"and deletions per production block, {CHUNK} chains per step of "
        "the recomputes and works; "
        + ("LJ tails in every transfer and volume move, r_cut 7.5 and 8.5 A"
           if args.lrc else "bare truncated model, r_cut 7.5 A"))
    parts = _common.run_parts(
        args, list(POINTS) if args.lrc else ["7.5"],
        lambda part: run_one(*POINTS[part], args, dev, t0))
    if parts is None:
        return 0
    rec.gate("state points' wall: " + ", ".join(
        f"r_cut {p} {float(r['wall']):.0f} s" for p, r in parts.items()))
    if not args.lrc:
        r = parts["7.5"]
        gates_one(r, rec)
        ok = (RHO_L_BAND[0] < r["rho_l"] < RHO_L_BAND[1]
              and RHO_V_BAND[0] < r["rho_v"] < RHO_V_BAND[1])
        rec.gate(f"loose bands rho_l {RHO_L_BAND}, rho_v {RHO_V_BAND} "
                 f"[{_common.pf(ok)}] (experiment 0.890 / 0.0048 g/cc)", ok)
        return rec.write(args.out, parts)
    r1, r2 = parts["7.5"], parts["8.5"]
    gates_one(r1, rec)
    gates_one(r2, rec)
    d_rho = abs(r2["rho_l"] - r1["rho_l"])
    tol_rho = max(4.0 * np.hypot(r1["sem_l"], r2["sem_l"]), 0.012)
    d_rv = abs(r2["rho_v"] - r1["rho_v"])
    tol_rv = max(4.0 * np.hypot(r1["sem_v"], r2["sem_v"]), 0.0012)
    d_dh = abs(r2["dh"] - r1["dh"])
    tol_dh = max(4.0 * np.hypot(r1["sem_dh"], r2["sem_dh"]), 1.2)
    inv_ok = d_rho < tol_rho and d_rv < tol_rv and d_dh < tol_dh
    win_ok = (0.80 < r2["rho_l"] < 0.90 and 0.002 < r2["rho_v"] < 0.010
              and 30.0 < r2["dh"] < 42.0)
    rec.gate(f"r_cut-invariance: |d rho_l| {d_rho:.4f} < {tol_rho:.4f}, "
             f"|d rho_v| {d_rv:.4f} < {tol_rv:.4f}, |d dH| {d_dh:.2f} < "
             f"{tol_dh:.2f} kJ/mol  [{_common.pf(inv_ok)}]", inv_ok)
    rec.gate("published-spread windows (rho_l (0.80, 0.90), rho_v (0.002, "
             "0.010) g/cc, dH (30, 42) kJ/mol)  "
             f"[{_common.pf(win_ok)}]", win_ok)
    rec.gate("experiment at 450 K: 0.890 / 0.0048 g/cc, dH 39.6 kJ/mol")
    return rec.write(args.out, parts)


if __name__ == "__main__":
    sys.exit(main())
