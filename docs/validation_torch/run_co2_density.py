"""NPT density of TraPPE CO2 at 240 K on the saturation line, on the card.

The rigid linear molecule's path end to end (models/linear.py co2_system:
two LJ types with Lorentz-Berthelot cross terms and point charges) through
the whole-sweep kernel with ln-V volume moves: the saturated liquid
density of CO2 at 240 K is a literature number (experiment 1.0889 g/cc at
P_sat = 12.83 bar) that TraPPE was fitted to reproduce within ~1% (Potoff
& Siepmann, AIChE J. 47, 1676 (2001)); nothing in the port was tuned to
it.

    python3 docs/validation_torch/run_co2_density.py [--device cpu]
        [--chains 512] [--equil 40] [--prod 20] [--sweeps 250] [--out FILE]

Writes docs/validation_torch/co2_density.txt by default.
"""

import sys

import numpy as np

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.linear import co2_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.utils.constants import (
    AVOGADRO,
    BOLTZMANN,
)

N_MOL = 256
N_CHAINS = 512
T = 240.0
P_BAR = 12.83                                # saturation pressure, bar
P = P_BAR * 1.0e5 / BOLTZMANN * 1e-30        # K / Angstrom^3
M_CO2 = 44.0095                              # g/mol
RHO_LIT = 1.0889                             # g/cc, experiment at 240 K
EQUIL_BLOCKS = 40
PROD_BLOCKS = 20
SWEEPS = 250
SEED = 24


def g_per_cc(n_density):
    return n_density * M_CO2 / AVOGADRO * 1e24


def main(argv=None):
    ap = _common.parser(__doc__, "co2_density.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_co2_density")
    rec = _common.Record(
        dev, f"{N_MOL} CO2 x {args.chains} chains, T = {T} K, P = {P_BAR} "
        "bar (sat. line), Ewald, f32, whole-sweep kernel + ln-V volume "
        f"moves, equil/production {args.equil}/{args.prod} blocks x "
        f"{args.sweeps} sweeps")
    params = RunParams(temperature=T, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.3,
                       dphi_max=0.3, pressure=P, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(co2_system(N_MOL), params, device=dev,
                    generator=_common.generator(dev, SEED))
    print(f"route: {mc.route}", flush=True)
    box0 = (N_MOL * M_CO2 / AVOGADRO / RHO_LIT * 1e24) ** (1.0 / 3.0)
    state = mc.init_state(cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=args.chains)
    equil_trace = []
    for b in range(args.equil):
        state, stats = mc.run_block(state, args.sweeps, adjust=True)
        rho = g_per_cc(N_MOL / float((state.box.double() ** 3).mean()))
        equil_trace.append(rho)
        print(f"equil {b:2d}: rho = {rho:.4f} g/cc  "
              f"drift {stats['drift_max_rel']:.1e} {rec.stamp()}", flush=True)
    dens, worst = [], 0.0
    for b in range(args.prod):
        state, stats = mc.run_block(state, args.sweeps, adjust=False)
        worst = max(worst, stats["drift_max_rel"])
        dens.append(N_MOL / state.box.double().cpu().numpy() ** 3)
        print(f"prod {b:2d}: rho = {g_per_cc(dens[-1].mean()):.4f} g/cc  "
              f"drift {stats['drift_max_rel']:.1e}  acc_vol "
              f"{stats['acc_vol']:.3f} {rec.stamp()}", flush=True)
    rho = g_per_cc(np.concatenate(dens))    # per (block, chain) samples
    blocks = g_per_cc(np.stack([d.mean() for d in dens]))
    mean, sem = float(rho.mean()), float(blocks.std() / np.sqrt(len(blocks)))
    rec.gate(f"route: {mc.route}", mc.route == "sweep")
    rec.gate(f"density: {mean:.4f} +/- {sem:.4f} g/cc (block SEM; gate "
             f"|rho - {RHO_LIT}| < max(0.033, 5 sem))",
             abs(mean - RHO_LIT) < max(0.033, 5 * sem))
    rec.gate(f"reference: experiment {RHO_LIT} g/cc; TraPPE reproduces "
             "coexistence densities within ~1%")
    rec.gate("equilibration trace (every 5th block, chain-mean rho g/cc): "
             + " ".join(f"{r:.4f}" for r in equil_trace[::5])
             + (f" ... {equil_trace[-1]:.4f}" if equil_trace else ""))
    rec.gate(f"worst block drift: {worst:.2e} (bound 5e-5)", worst < 5e-5)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
