"""REMC against independent NVT on the card: ladder averages.

Parallel tempering must not change single-temperature equilibrium
averages, only mixing.  The same 64-replica LJ temperature ladder runs
twice through the whole-sweep kernel: (a) REMC, an exchange round
(parallel/remc.py exchange, alternating even/odd phases) every SWEEPS
sweeps; (b) the control, identical chains never exchanged.  The
per-temperature mean energies must agree: the swap acceptance, the
configuration / S(k) swap plumbing and the per-temperature step sizes at
once.

    python3 docs/validation_torch/run_remc_ladder.py [--device cpu]
        [--equil 400] [--rounds 300] [--sweeps 5] [--out FILE]

Writes docs/validation_torch/remc_ladder.txt by default.
"""

import dataclasses
import sys

import numpy as np

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import (
    lj_box_for_density,
    lj_system,
)
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.parallel.remc import (
    exchange,
    temperature_ladder,
)

N, RHO = 256, 0.75
C = 64                      # replicas
T_LO, T_HI = 0.9, 2.0
EQUIL, ROUNDS, SWEEPS = 400, 300, 5


def run(mc, state, do_exchange, gen, equil, rounds, sweeps):
    state = mc.run_steps(state, equil, False)
    e_sum = np.zeros(state.energy.shape[0])
    swaps = []
    for r in range(rounds):
        state = mc.run_steps(state, sweeps, False)
        if do_exchange:
            state, frac = exchange(state, gen, r % 2)
            swaps.append(float(frac))
        e_sum += state.energy.double().cpu().numpy()
    return e_sum / rounds, (float(np.mean(swaps)) if swaps else 0.0), state


def main(argv=None):
    ap = _common.parser(__doc__, "remc_ladder.txt")
    ap.add_argument("--equil", type=int, default=EQUIL)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_remc_ladder")
    rec = _common.Record(
        dev, f"N={N} rho={RHO}, {C} replicas T in [{T_LO}, {T_HI}], "
        f"{args.equil} equil + {args.rounds}x{args.sweeps} sweeps, exchange "
        f"every {args.sweeps} sweeps (alternating phases), whole-sweep "
        "kernel, f32")
    box = lj_box_for_density(N, RHO)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=box / 30)
    results = {}
    for label, do_x, seed in (("remc", True, 0), ("control", False, 1)):
        mc = MonteCarlo(lj_system(N), params, device=dev,
                        generator=_common.generator(dev, seed))
        state = mc.init_state(cubic_lattice(N, box), box=box, n_chains=C)
        ladder = temperature_ladder(T_LO, T_HI, C, dtype=state.temp.dtype,
                                    device=dev)
        state = dataclasses.replace(state, temp=ladder)
        e_mean, swap, _ = run(mc, state, do_x, _common.generator(dev, 99),
                              args.equil, args.rounds, args.sweeps)
        results[label] = (e_mean, swap, mc.route)

    e_r, swap_frac, route = results["remc"]
    e_c = results["control"][0]
    d = (e_r - e_c) / N
    rms = float(np.sqrt(np.mean(d ** 2)))
    worst = float(np.max(np.abs(d)))
    mono = float(np.mean(np.sign(np.diff(e_r))))  # E must rise with T
    rec.gate(f"route: {route}", route == "sweep")
    rec.gate(f"swap fraction: {swap_frac:.3f} (must discriminate: in (0,1))",
             0.0 < swap_frac < 1.0)
    rec.gate(f"per-T energy difference REMC - NVT (per particle): rms "
             f"{rms:.4f}, worst {worst:.4f} (bounds 0.03 / 0.10)",
             rms < 0.03 and worst < 0.10)
    rec.gate(f"energy monotone in T: fraction {mono:.2f} (bound 0.9)",
             mono > 0.9)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
