"""MBAR temperature reweighting of a REMC run on the card.

A 64-replica LJ ladder (whole-sweep kernel, an exchange round every
SWEEPS sweeps, slot temperatures fixed so slot k samples T_k) logs the
per-slot energies each round, and mc/mbar.py reweight_temperature is
gated three ways: (1) reweighting at each rung reproduces that rung's
direct average; (2) the MBAR fluctuation heat capacity Var(E)/T^2 at the
interior rungs matches the finite-difference slope d<E>/dT of the direct
rung averages; (3) between-rung targets keep a large Kish effective
sample size while a far extrapolation's collapses.

    python3 docs/validation_torch/run_remc_mbar.py [--device cpu]
        [--equil 400] [--rounds 400] [--sweeps 5] [--out FILE]

Writes docs/validation_torch/remc_mbar.txt by default.
"""

import dataclasses
import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.mbar import reweight_temperature
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
C = 64                      # replicas / ladder rungs
T_LO, T_HI = 0.9, 2.0
EQUIL, ROUNDS, SWEEPS = 400, 400, 5


def main(argv=None):
    ap = _common.parser(__doc__, "remc_mbar.txt")
    ap.add_argument("--equil", type=int, default=EQUIL)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_remc_mbar")
    rounds = args.rounds
    rec = _common.Record(
        dev, f"N={N} rho={RHO}, {C} rungs T in [{T_LO}, {T_HI}], "
        f"{args.equil} equil + {rounds}x{args.sweeps} sweeps, exchange every "
        "round, whole-sweep kernel f32")
    box = lj_box_for_density(N, RHO)
    params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=box / 30)
    ladder = temperature_ladder(T_LO, T_HI, C, dtype=torch.float64).numpy()

    mc = MonteCarlo(lj_system(N), params, device=dev,
                    generator=_common.generator(dev, 0))
    state = mc.init_state(cubic_lattice(N, box), box=box, n_chains=C)
    state = dataclasses.replace(state, temp=temperature_ladder(
        T_LO, T_HI, C, dtype=state.temp.dtype, device=dev))
    state = mc.run_steps(state, args.equil, False)
    gen = _common.generator(dev, 99)
    e_rounds = np.empty((rounds, C))
    swaps = []
    for r in range(rounds):
        state = mc.run_steps(state, args.sweeps, False)
        state, frac = exchange(state, gen, r % 2)
        swaps.append(float(frac))
        e_rounds[r] = state.energy.double().cpu().numpy()
    swap_frac = float(np.mean(swaps))
    e_kn = e_rounds.T                      # (K=C rungs, S=rounds samples)
    direct = e_kn.mean(axis=1)
    sem = e_kn.std(axis=1) / np.sqrt(rounds)

    # (1) reweight at the rungs
    at = reweight_temperature(e_kn, ladder, ladder)
    z = (at["e_mean"] - direct) / np.maximum(sem, 1e-9)
    rms_z = float(np.sqrt(np.mean(z ** 2)))

    # (2) C_v identity at the interior rungs against the centred finite
    # difference of the direct means, half-width 4 rungs (the JAX
    # script's stride: a 1-rung difference amplifies the rung SEM)
    w = 4
    interior = np.arange(w, C - w)
    fd = (direct[interior + w] - direct[interior - w]) / (
        ladder[interior + w] - ladder[interior - w])
    rel = np.abs(at["c"][interior] - fd) / np.abs(fd)
    med_rel = float(np.median(rel))
    mids = 0.5 * (ladder[:-1] + ladder[1:])
    mid = reweight_temperature(e_kn, ladder, mids)

    # (3) ESS honesty
    ess_mid_min = float(np.min(mid["ess"]))
    far = reweight_temperature(e_kn, ladder, [5.0 * T_HI])
    ess_far = float(far["ess"][0])

    n_pool = e_kn.size
    rec.gate(f"route: {mc.route}", mc.route == "sweep")
    rec.gate(f"pooled samples {n_pool}")
    rec.gate(f"swap fraction: {swap_frac:.3f} (must discriminate: in (0,1))",
             0.0 < swap_frac < 1.0)
    rec.gate(f"(1) rung self-consistency: rms z-score {rms_z:.2f} "
             "(bound 3.0)", rms_z < 3.0)
    rec.gate(f"(2) C_v identity: median |Cv_mbar - d<E>/dT| / |d<E>/dT| "
             f"= {med_rel:.3f} over {interior.size} interior rungs "
             f"(centered FD half-width {w} rungs; bound 0.15)",
             med_rel < 0.15)
    rec.gate(f"(3) ESS: min between-rung {ess_mid_min:.0f} "
             f"(> {0.05 * n_pool:.0f}); far extrapolation T={5.0 * T_HI:.1f} "
             f"-> {ess_far:.1f} (< {0.01 * n_pool:.0f})",
             ess_mid_min > 0.05 * n_pool and ess_far < 0.01 * n_pool)
    e_123 = reweight_temperature(e_kn, ladder, [1.23])["e_mean"][0] / N
    rec.gate(f"example curve: <E>/N at T=1.23 (never sampled) = "
             f"{e_123:.4f}")
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
