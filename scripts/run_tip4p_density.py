"""TIP4P/2005 NPT density at 298.15 K and 1 bar on the card, through the
PyTorch port: docs/validation/run_tip4p_density.py's protocol (216
waters x 128 chains, r_cut 9 A, Ewald, p_volume 0.2, dv_max 0.02, 50
equilibration blocks with step-size adaptation and 40 production blocks
of 250 sweeps, from a lattice at the experimental density).

    python3 scripts/run_tip4p_density.py [--equil 50] [--prod 40]
        [--sweeps 250] [--out FILE]

Prints the card's name and power limit, one line per block, then the
production density with its standard error over the production blocks'
chain means, the worst block drift and the wall time; --out also writes
the summary to FILE.  The literature value is 0.9979 g/cc (Abascal and
Vega 2005; experiment 0.997).  Needs a CUDA device.
"""

import argparse
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice  # noqa
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo  # noqa
from metropolismontecarlo_tpu_torch.models.system import RunParams  # noqa
from metropolismontecarlo_tpu_torch.models.water import (  # noqa
    tip4p2005_system,
)
from metropolismontecarlo_tpu_torch.utils.constants import (  # noqa
    AVOGADRO,
    BOLTZMANN,
)

N_MOL, N_CHAINS, T = 216, 128, 298.15
P_BAR = 1.0e5 / BOLTZMANN * 1e-30          # 1 bar in K / A^3
M_WATER = 18.015268                         # g/mol


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--equil", type=int, default=50)
    ap.add_argument("--prod", type=int, default=40)
    ap.add_argument("--sweeps", type=int, default=250)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("run_tip4p_density: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3, pressure=P_BAR, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(tip4p2005_system(N_MOL), params, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(42))
    box0 = (N_MOL / 0.0334) ** (1.0 / 3.0)     # the experimental density
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=N_CHAINS)
    worst, dens = 0.0, []
    for b in range(args.equil + args.prod):
        prod = b >= args.equil
        state, stats = mc.run_block(state, args.sweeps, adjust=not prod)
        rho = g_per_cc(N_MOL / state.box.double() ** 3).cpu().numpy()
        line = (f"{'prod' if prod else 'equil'} {b:3d}: rho "
                f"{rho.mean():.4f} g/cc, drift {stats['drift_max_rel']:.1e}")
        if prod:
            worst = max(worst, stats["drift_max_rel"])
            dens.append(rho)
            line += f", acc_vol {stats['acc_vol']:.3f}"
        print(line, flush=True)
    wall = time.perf_counter() - t0
    blocks = np.array([d.mean() for d in dens])
    mean = float(np.concatenate(dens).mean())
    sem = float(blocks.std() / math.sqrt(len(blocks)))
    lines = [
        "TIP4P/2005 water NPT density, PyTorch port",
        f"device: {smi}",
        f"protocol: {N_MOL} waters x {N_CHAINS} chains, T = {T} K, P = 1 "
        f"bar, Ewald, f32, whole-sweep kernel (P = 4) + ln V volume moves, "
        f"{args.equil} + {args.prod} blocks x {args.sweeps} sweeps",
        f"density: {mean:.4f} +/- {sem:.4f} g/cc (SEM over the production "
        f"blocks' chain means)",
        "reference: TIP4P/2005 literature 0.9979, experiment 0.997",
        f"worst production block drift: {worst:.2e}",
        f"wall: {wall:.1f} s",
    ]
    text = "\n".join(lines) + "\n"
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
