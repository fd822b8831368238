"""SPC/E static dielectric constant at 298.15 K on the card.

The dipole-fluctuation machinery (observables.py DipoleAccumulator, the
tinfoil formula) against a replicated literature number: eps ~ 68-73
under conducting boundaries (Reddy & Berkowitz, J. Chem. Phys. 90, 3483
(1989): 71); the Kirkwood factor follows from eps via eps - 1 = 3 y g_K.
2048 NVT chains of 216 waters, pooled.  Equilibration is per chain: the
collective dipole relaxes over thousands of sweeps, so 600 blocks of 50
sweeps come before sampling opens.  PASS needs eps inside the band, a
production trace that does not climb, and the block drift.

    python3 docs/validation_torch/run_spce_dielectric.py [--device cpu]
        [--chains 2048] [--equil 600] [--prod 150] [--sweeps 50]
        [--out FILE]

Writes docs/validation_torch/spce_dielectric.txt by default.
"""

import sys

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.observables import DipoleAccumulator

N_MOL = 216          # box 18.64 A at 0.998 g/cc; r_cut 9 min-image-legal
N_CHAINS = 2048
T = 298.15
RHO_G_CC = 0.998     # experimental ambient density
M_WATER = 18.015268
EQUIL_BLOCKS, PROD_BLOCKS, SWEEPS_PER_BLOCK = 600, 150, 50
ADJUST_BLOCKS = 20
SEED = 7


def main(argv=None):
    ap = _common.parser(__doc__, "spce_dielectric.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS_PER_BLOCK)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_spce_dielectric")
    rec = _common.Record(
        dev, f"{N_MOL} waters x {args.chains} chains, T = {T} K, rho = "
        f"{RHO_G_CC} g/cc (NVT), Ewald, f32, whole-sweep kernel, "
        f"equil/production {args.equil}/{args.prod} blocks x {args.sweeps} "
        "sweeps, dipoles sampled once per block")
    system = spce_system(N_MOL)
    n_dens = RHO_G_CC / M_WATER * 6.02214076e23 * 1e-24   # 1/A^3
    box = (N_MOL / n_dens) ** (1.0 / 3.0)
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3)
    gen = _common.generator(dev, SEED)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    dip = DipoleAccumulator(system)
    state = mc.init_state(cubic_lattice(N_MOL, box), box=box,
                          n_chains=args.chains)
    trace, worst_drift = [], 0.0
    for b in range(args.equil + args.prod):
        prod = b >= args.equil
        state, stats = mc.run_block(state, args.sweeps,
                                    adjust=b < ADJUST_BLOCKS and not prod)
        if not prod:
            if b % 10 == 0:
                print(f"equil {b:3d}: dr_max {stats['dr_max_mean']:.3f} "
                      f"drift {stats['drift_max_rel']:.1e} {rec.stamp()}",
                      flush=True)
        else:
            worst_drift = max(worst_drift, stats["drift_max_rel"])
            dip.update(state)
            pb = b - args.equil + 1
            if pb % 10 == 0:
                r = dip.result()
                trace.append((pb, r["epsilon"], r["g_kirkwood"]))
                print(f"prod {pb:4d}/{args.prod}: eps = {r['epsilon']:.1f} "
                      f"g_K = {r['g_kirkwood']:.2f} ({r['n_samples']} "
                      f"samples) {rec.stamp()}", flush=True)
    res = dip.result()
    eps, g_k = res["epsilon"], res["g_kirkwood"]
    if not trace:             # a production shorter than 10 blocks
        trace.append((args.prod, eps, g_k))
    # the uncertainty from the last-half vs full-run difference; PASS
    # needs eps inside the literature band (with a +-0.5 margin) and no
    # systematic climb across the production trace (an under-equilibrated
    # run's signature), as in the JAX script
    half = abs(trace[len(trace) // 2][1] - eps)
    climb = abs(trace[-1][1] - trace[0][1])
    # dipole density y = (eps - 1) / (3 g_K) by the tinfoil relation, from
    # the accumulator's own outputs: the g_K band follows from the eps band
    y = (eps - 1.0) / (3.0 * g_k)
    rec.gate(f"route: {mc.route}", mc.route == "sweep")
    rec.gate(f"samples: {res['n_samples']} (chains x blocks)")
    rec.gate(f"epsilon = {eps:.1f}  (band 67.5-73.5; half-run delta "
             f"{half:.1f})", 67.5 < eps < 73.5)
    rec.gate(f"production-trace climb {climb:+.1f} (bound 0.5)",
             climb < 0.5)
    rec.gate(f"g_kirkwood = {g_k:.2f}  (band "
             f"{0.95 * (67.0 - 1.0) / (3.0 * y):.2f}-"
             f"{1.05 * (73.0 - 1.0) / (3.0 * y):.2f}, derived from the eps "
             f"band at this run's dipole density y = {y:.2f})")
    rec.gate("literature: eps(SPC/E) ~ 68-73 tinfoil (Reddy-Berkowitz, "
             "J. Chem. Phys. 90, 3483 (1989): 71)")
    rec.gate(f"worst block drift: {worst_drift:.2e} (bound 5e-5)",
             worst_drift < 5e-5)
    rec.note("running trace (blocks, eps, g_K): "
             + "; ".join(f"({int(b)}, {e:.1f}, {g:.2f})"
                         for b, e, g in trace))
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
