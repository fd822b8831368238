"""Molecular muVT against NVT + Widom on the card: supercritical SPC/E.

Two independent routes to the excess chemical potential must meet: the
muVT app (mc/gcmc_mol.py MolGCMC, orientational-bias insertions and
deletions with carried Ewald structure factors) samples <N> at fixed
activity z, beta mu_ex = ln(z / <rho>); the NVT driver (whole-sweep
kernel) at N = round(<N>) in the same box, with Widom ghost insertions
(mc/widom.py), gives beta mu_ex = -ln <exp(-beta dU)>.  Different
ensembles, movers and estimators over one energy model: the exchange
acceptance (self + intra constants, the Rosenbluth correction) in f32.

    python3 docs/validation_torch/run_gcmc_water.py [--device cpu]
        [--chains 256] [--equil 8] [--prod 8] [--steps 1500]
        [--nvt-blocks 4 6] [--nvt-sweeps 100 50] [--out FILE]

Writes docs/validation_torch/gcmc_water.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system

# well supercritical (SPC/E T_c ~ 640 K): at 1000 K the isotherm is steep
# and near-ideal, so the activity pins a moderate density far from the
# capacity (the JAX script's notes on 500 K and 700 K)
T = 1000.0
BOX = 20.0
Z = 2.5e-3          # activity, A^-3
CAP = 96
N_CHAINS = 256
N_ORIENT = 4
EQUIL_BLOCKS, PROD_BLOCKS, STEPS = 8, 8, 1500
NVT_ADJUST, NVT_WIDOM, N_INSERT = 4, 6, 256
NVT_ADJUST_SWEEPS, NVT_WIDOM_SWEEPS = 100, 50


def main(argv=None):
    ap = _common.parser(__doc__, "gcmc_water.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--nvt-blocks", type=int, nargs=2,
                    default=(NVT_ADJUST, NVT_WIDOM))
    ap.add_argument("--nvt-sweeps", type=int, nargs=2,
                    default=(NVT_ADJUST_SWEEPS, NVT_WIDOM_SWEEPS))
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gcmc_water")
    chains = args.chains
    rec = _common.Record(
        dev, f"T = {T} K, box = {BOX} A, z = {Z} A^-3, capacity {CAP}, "
        f"{chains} chains, n_orient = {N_ORIENT}, muVT {args.equil} + "
        f"{args.prod} blocks x {args.steps} steps (plain route, f32); NVT "
        f"{args.nvt_blocks[0]} x {args.nvt_sweeps[0]} adjust + "
        f"{args.nvt_blocks[1]} x ({args.nvt_sweeps[1]} sweeps + {N_INSERT} "
        "ghosts), whole-sweep kernel")
    params = RunParams(temperature=T, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.2, dphi_max=0.7)
    g = MolGCMC(spce_system(CAP), params, activity=Z, p_exchange=0.4,
                dtype=torch.float32, n_orient=N_ORIENT, device=dev,
                generator=_common.generator(dev, 7))
    st = g.init(box=BOX, n_init=24, n_chains=chains)
    for b in range(args.equil):
        st, stats = g.run_block(st, args.steps)
        print(f"equil {b}: <N> {stats['n_mean']:.2f} "
              f"accI {stats['acc_insert']:.3f} accD {stats['acc_delete']:.3f}"
              f" drift {stats['drift_max_rel']:.2e}", flush=True)
    n_mean, worst, full = 0.0, 0.0, 0.0
    for b in range(args.prod):
        st, stats = g.run_block(st, args.steps)
        worst = max(worst, stats["drift_max_rel"])
        full = max(full, stats["full_frac"])
        n_mean += stats["n_mean"] / args.prod
        print(f"prod {b}: <N> {stats['n_mean']:.2f} "
              f"full {stats['full_frac']:.3f} "
              f"drift {stats['drift_max_rel']:.2e}", flush=True)
    rho = n_mean / BOX**3
    bmu_gcmc = float(np.log(Z / rho))
    rec.gate(f"muVT:  <N> = {n_mean:.2f} over {args.prod}x{args.steps} "
             f"steps/chain, rho = {rho:.3e} A^-3, beta*mu_ex = ln(z/rho) = "
             f"{bmu_gcmc:+.4f}")
    rec.gate(f"       final acc: insert {stats['acc_insert']:.3f}, delete "
             f"{stats['acc_delete']:.3f}, trans {stats['acc_trans']:.3f}, "
             f"rot {stats['acc_rot']:.3f}")
    rec.gate(f"       production drift max {worst:.1e} (bound 1e-4 every "
             "block, f32)", worst < 1e-4)
    rec.gate(f"       full_frac max {full:.3f} (bound 0.02: a fluid, not "
             "a saturated capacity)", full < 0.02)

    # independent NVT + Widom at the sampled density
    n = max(1, int(round(n_mean)))
    mc = MonteCarlo(spce_system(n), params, device=dev,
                    generator=_common.generator(dev, 8))
    state = mc.init_state(cubic_lattice(n, BOX), box=BOX, n_chains=chains)
    for _ in range(args.nvt_blocks[0]):
        state, _ = mc.run_block(state, args.nvt_sweeps[0], adjust=True)
    bsum, cnt = 0.0, 0
    for i in range(args.nvt_blocks[1]):
        state, bstats = mc.run_block(state, args.nvt_sweeps[1],
                                     adjust=False)
        w = mc.widom(state, N_INSERT,
                     generator=_common.generator(dev, 200 + i))
        bsum += float(torch.mean(w["boltzmann_mean"].double()))
        cnt += 1
    bmu_widom = float(-np.log(bsum / cnt))
    rec.gate(f"NVT:   N = {n}, Widom over {cnt}x{N_INSERT}x{chains} ghosts: "
             f"beta*mu_ex = {bmu_widom:+.4f} (drift "
             f"{bstats['drift_max_rel']:.1e}; route {mc.route})",
             mc.route == "sweep")
    diff = bmu_gcmc - bmu_widom
    rec.gate(f"difference: {diff:+.4f} kT (bound 0.1; finite-N rounding "
             f"alone is worth ~{1.0 / n_mean:.3f})", abs(diff) < 0.1)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
