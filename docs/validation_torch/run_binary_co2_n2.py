"""Binary muVT on the card: CO2/N2 mixed-gas uptake against NVT + Widom.

The flue-gas separation pair under the two-species grand-canonical app
(mc/gcmc_binary.py BinaryGCMC): both TraPPE species exchange with
reservoirs at their own activities in one box at 300 K, giving the
mixture uptake (<N_CO2>, <N_N2>) and the adsorption selectivity

    S = (<N_CO2>/<N_N2>) / (z_CO2/z_N2).

Cross-check: the per-species excess chemical potentials from two
independent routes must meet:
  * binary muVT:  beta mu_ex_s = ln(z_s / <rho_s>);
  * NVT + Widom:  species-resolved ghost insertions (MonteCarlo.widom,
    species=s) in a fixed-composition mixture at the sampled
    (N_CO2, N_N2).
Different ensembles, movers and estimators over the same energy model
(Ewald quadrupoles + LB-crossed TraPPE LJ).  CO2 is the more strongly
interacting species, so S > 1 is the physical expectation.  The muVT
side runs the JAX script's route: plain exchange steps (mega=None,
n_orient 1).

    python3 docs/validation_torch/run_binary_co2_n2.py [--device cpu]
        [--chains 256] [--equil 8] [--prod 8] [--steps 1500]
        [--nvt-equil 4] [--nvt-blocks 6] [--out FILE]

Writes docs/validation_torch/binary_co2_n2.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMC
from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
from metropolismontecarlo_tpu_torch.models.system import RunParams

T = 300.0
BOX = 26.0
# CO2 at 300 K is 4 K below its critical point: activities must stay
# under the saturation activity or the box condenses
Z = (5e-4, 8e-4)              # (z_CO2, z_N2) A^-3
CAPS = (96, 96)
N_CHAINS = 256
EQUIL_BLOCKS, PROD_BLOCKS, STEPS = 8, 8, 1500


def main(argv=None):
    ap = _common.parser(__doc__, "binary_co2_n2.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--nvt-equil", type=int, default=4)
    ap.add_argument("--nvt-blocks", type=int, default=6,
                    help="at least 1")
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_binary_co2_n2")
    rec = _common.Record(
        dev, f"TraPPE CO2/N2 binary muVT, T = {T} K, box = {BOX} A, z = {Z} "
        f"A^-3, caps {CAPS}, {args.chains} chains, {args.equil} + "
        f"{args.prod} blocks x {args.steps} steps, p_exchange 0.4, plain "
        f"exchange steps, f32; then NVT at the sampled composition, "
        f"{args.nvt_equil} x 100 + {args.nvt_blocks} x 50 sweeps with 128 "
        "ghosts per species per block")
    params = RunParams(temperature=T, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.5, dphi_max=1.0)
    g = BinaryGCMC(co2_n2_system(*CAPS), params, activities=Z,
                   p_exchange=0.4, dtype=torch.float32, device=dev,
                   generator=_common.generator(dev, 17))
    st = g.init(box=BOX, n_init=(12, 14), n_chains=args.chains)
    for b in range(args.equil):
        st, stats = g.run_block(st, args.steps)
        print(f"equil {b}: <N0> {stats['n0_mean']:.2f} "
              f"<N1> {stats['n1_mean']:.2f} "
              f"accX {stats['acc_insert0']:.3f}/{stats['acc_insert1']:.3f} "
              f"drift {stats['drift_max_rel']:.2e} {rec.stamp()}",
              flush=True)
    n0 = n1 = 0.0
    ok_blocks, worst = True, dict(drift=0.0, sfac=0.0, full=0.0)
    for b in range(args.prod):
        st, stats = g.run_block(st, args.steps)
        # vapour chains carry small |E|, so the f32 bookkeeping residue is
        # large endpoint-relative while the acceptance inputs (fresh pose
        # energies + carried S(k)) stay tight: S(k) gated hard, the energy
        # diagnostic loosely
        ok_blocks &= (stats["drift_max_rel"] < 1e-2
                      and stats["sfac_err_max"] < 1e-4
                      and stats["full_frac0"] < 0.02
                      and stats["full_frac1"] < 0.02)
        worst["drift"] = max(worst["drift"], stats["drift_max_rel"])
        worst["sfac"] = max(worst["sfac"], stats["sfac_err_max"])
        worst["full"] = max(worst["full"], stats["full_frac0"],
                            stats["full_frac1"])
        n0 += stats["n0_mean"] / args.prod
        n1 += stats["n1_mean"] / args.prod
        print(f"prod {b}: <N0> {stats['n0_mean']:.2f} "
              f"<N1> {stats['n1_mean']:.2f} {rec.stamp()}", flush=True)
    vol = BOX ** 3
    bmu = [float(np.log(Z[s] / (n / vol))) for s, n in ((0, n0), (1, n1))]
    sel = (n0 / n1) / (Z[0] / Z[1])
    rec.gate("muVT route: plain exchange steps (mega=None), n_orient 1")
    rec.gate(f"muVT:  <N_CO2> = {n0:.2f}, <N_N2> = {n1:.2f}; "
             f"beta*mu_ex = {bmu[0]:+.4f} / {bmu[1]:+.4f}")
    rec.gate(f"production blocks: worst drift {worst['drift']:.2e} (bound "
             f"1e-2), worst S(k) error {worst['sfac']:.2e} (bound 1e-4), "
             f"largest full fraction {worst['full']:.3f} (bound 0.02)  "
             f"[{_common.pf(ok_blocks)}]", ok_blocks)

    # independent NVT + per-species Widom at the sampled composition
    nc, nn = int(round(n0)), int(round(n1))
    mc = MonteCarlo(co2_n2_system(nc, nn), params, device=dev,
                    generator=_common.generator(dev, 18))
    rec.gate(f"NVT route: {mc.route}")
    state = mc.init_state(cubic_lattice(nc + nn, BOX), box=BOX,
                          n_chains=args.chains)
    for _ in range(args.nvt_equil):
        state, _ = mc.run_block(state, 100, adjust=True)
    bsum, cnt = [0.0, 0.0], 0
    for i in range(args.nvt_blocks):
        state, bstats = mc.run_block(state, 50, adjust=False)
        for s in (0, 1):
            w = mc.widom(state, n_insertions=128, species=s,
                         generator=_common.generator(dev, 300 + 2 * i + s))
            bsum[s] += float(w["boltzmann_mean"].mean())
        cnt += 1
    bmu_w = [float(-np.log(b / cnt)) for b in bsum]
    rec.gate(f"NVT:   (N_CO2, N_N2) = ({nc}, {nn}), Widom "
             f"beta*mu_ex = {bmu_w[0]:+.4f} / {bmu_w[1]:+.4f} "
             f"(drift {bstats['drift_max_rel']:.1e})")
    d = [bmu[s] - bmu_w[s] for s in (0, 1)]
    ok_d = all(abs(x) < 0.1 for x in d)
    rec.gate(f"differences: {d[0]:+.4f} / {d[1]:+.4f} kT (bound 0.1; "
             f"finite-N rounding ~{1.0 / n1:.3f})  "
             f"[{_common.pf(ok_d)}]", ok_d)
    rec.gate(f"selectivity S = (N0/N1)/(z0/z1) = {sel:.3f} (CO2-philic "
             f"expectation: S > 1)  [{_common.pf(sel > 1.0)}]", sel > 1.0)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
