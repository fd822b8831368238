"""NPT density of SPC/E water at 298.15 K and 1 bar on the card.

The NPT path end to end (whole-sweep kernel, ln-V volume moves with a
full recompute, Ewald with box-dependent kappa / cfac / self): the
ambient density of SPC/E is a literature number (~0.994-1.00 g/cc;
experiment 0.997) that nothing in the port was fitted to.

    python3 docs/validation_torch/run_npt_density.py [--device cpu]
        [--chains 128] [--equil 50] [--prod 24] [--sweeps 250] [--out FILE]

Writes docs/validation_torch/npt_density.txt by default.
"""

import sys

import numpy as np

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.utils.constants import (
    AVOGADRO,
    BOLTZMANN,
)

N_MOL = 216   # box ~18.7 A at 1 g/cc: r_cut 9 stays min-image-legal
N_CHAINS = 128
T = 298.15
P_BAR = 1.0e5 / BOLTZMANN * 1e-30          # 1 bar in K/Angstrom^3
M_WATER = 18.015268                         # g/mol
EQUIL_BLOCKS, PROD_BLOCKS, SWEEPS_PER_BLOCK = 50, 24, 250
SEED = 42


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def main(argv=None):
    ap = _common.parser(__doc__, "npt_density.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS_PER_BLOCK)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_npt_density")
    rec = _common.Record(
        dev, f"{N_MOL} waters x {args.chains} chains, T = {T} K, P = 1 bar "
        f"({P_BAR:.4e} K/A^3), Ewald, f32, whole-sweep kernel + ln-V volume "
        f"moves, equil/production {args.equil}/{args.prod} blocks x "
        f"{args.sweeps} sweeps")
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3, pressure=P_BAR, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(spce_system(N_MOL), params, device=dev,
                    generator=_common.generator(dev, SEED))
    box0 = (N_MOL / 0.0334) ** (1.0 / 3.0)    # the experimental density
    state = mc.init_state(cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=args.chains)
    equil_trace = []
    for b in range(args.equil):
        state, stats = mc.run_block(state, args.sweeps, adjust=True)
        rho = g_per_cc(N_MOL / float((state.box.double() ** 3).mean()))
        equil_trace.append(rho)
        print(f"equil {b:2d}: rho = {rho:.4f} g/cc  "
              f"drift {stats['drift_max_rel']:.1e} {rec.stamp()}", flush=True)
    dens = []
    worst_drift = 0.0
    for b in range(args.prod):
        state, stats = mc.run_block(state, args.sweeps, adjust=False)
        worst_drift = max(worst_drift, stats["drift_max_rel"])
        dens.append(N_MOL / state.box.double().cpu().numpy() ** 3)
        print(f"prod {b:2d}: rho = {g_per_cc(dens[-1].mean()):.4f} g/cc  "
              f"drift {stats['drift_max_rel']:.1e}  acc_vol "
              f"{stats['acc_vol']:.3f} {rec.stamp()}", flush=True)
    rho = g_per_cc(np.concatenate(dens))    # per (block, chain) samples
    blocks = g_per_cc(np.stack([d.mean() for d in dens]))
    mean, sem = float(rho.mean()), float(blocks.std() / np.sqrt(len(blocks)))
    rec.gate(f"route: {mc.route}", mc.route == "sweep")
    rec.gate(f"density: {mean:.4f} +/- {sem:.4f} g/cc (block SEM over "
             "chains; gate |rho - 0.998| < max(0.02, 5 sem))",
             abs(mean - 0.998) < max(0.02, 5 * sem))
    rec.gate("equilibration trace (every 5th block, chain-mean rho g/cc): "
             + " ".join(f"{r:.4f}" for r in equil_trace[::5])
             + (f" ... {equil_trace[-1]:.4f}" if equil_trace else ""))
    rec.gate("reference values: experiment 0.997; SPC/E literature "
             "~0.994-1.00")
    rec.gate(f"worst block drift: {worst_drift:.2e} (bound 5e-5)",
             worst_drift < 5e-5)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
