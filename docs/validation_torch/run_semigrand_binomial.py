"""Semigrand identity flips on the card: the interacting-identical-species
Binomial closed form.

Two species blocks that are physically identical (both SPC/E water, full
Ewald) sampled semigrand at fugacity ratio xi: relabelling cannot change
the physics, so the composition is exactly

    N_B ~ Binomial(N_tot, xi / (1 + xi))

at any interaction strength, mean and variance in closed form with no
reference implementation in the loop.  This validates the identity-flip
acceptance rule (with the Rosenbluth orientational bias and the carried
structure-factor updates) in f32 on both flip paths against the same
closed form:
  plain    the plain flip steps (mega=None), Rosenbluth n_orient 4;
  kernel   the in-kernel flips (mega="full", csrc/flip_kernel.cu).

    python3 docs/validation_torch/run_semigrand_binomial.py [--device cpu]
        [--chains 256] [--equil 3] [--prod 8] [--steps 1200]
        [--parts plain kernel] [--partials DIR] [--out FILE]

--parts runs one segment (saved to --partials); the process that finds
both there writes the record.  Writes
docs/validation_torch/semigrand_binomial.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
from metropolismontecarlo_tpu_torch.models.system import RunParams, System
from metropolismontecarlo_tpu_torch.models.water import spce_system

N_TOT, XI = 16, 2.0
CAPS = 24
N_CHAINS = 256
EQUIL_BLOCKS, PROD_BLOCKS, STEPS = 3, 8, 1200
SEED = 3
# segment: (label, mega, n_orient)
SEGMENTS = {"plain": ("plain Rosenbluth n_orient=4", None, 4),
            "kernel": ("in-kernel flips (mega='full')", "full", 1)}


def water_two_blocks(cap_a, cap_b):
    w = spce_system(cap_a + cap_b)
    return System(n_mol=cap_a + cap_b, atoms_per_mol=3, body=w.body,
                  masses=w.masses, charges=w.charges,
                  type_ids=w.type_ids, eps_table=w.eps_table,
                  sig_table=w.sig_table, name="sg-spce",
                  species=(("wA", cap_a, 3), ("wB", cap_b, 3)))


def run_segment(dev, part, chains, equil, prod, steps):
    label, mega, n_or = SEGMENTS[part]
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.0, dphi_max=0.7)
    g = Semigrand(water_two_blocks(CAPS, CAPS), params, fugacity_ratio=XI,
                  p_flip=0.5, dtype=torch.float32, n_orient=n_or, mega=mega,
                  device=dev, generator=_common.generator(dev, SEED))
    st = g.init(box=20.0, n_a=8, n_b=8, n_chains=chains)
    for _ in range(equil):
        st, stats = g.run_block(st, steps)
    means, varis, worst, drift_ok = [], [], 0.0, True
    for b in range(prod):
        st, stats = g.run_block(st, steps)
        worst = max(worst, stats["drift_max_rel"])
        drift_ok &= stats["drift_max_rel"] < 2e-3
        means.append(stats["nb_mean"])
        varis.append(stats["nb_var"])
        print(f"[{label}] prod {b}: <N_B> {stats['nb_mean']:.3f} "
              f"var {stats['nb_var']:.3f} "
              f"accAB {stats['acc_flip_ab']:.3f} "
              f"drift {stats['drift_max_rel']:.1e}", flush=True)
    conserved = bool((st.active.sum(1) == N_TOT).all())
    return dict(means=np.asarray(means), varis=np.asarray(varis),
                worst=worst, drift_ok=drift_ok, conserved=conserved)


def main(argv=None):
    ap = _common.parser(__doc__, "semigrand_binomial.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    _common.add_parts(ap, SEGMENTS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_semigrand_binomial")
    p = XI / (1.0 + XI)
    rec = _common.Record(
        dev, f"2 x SPC/E blocks (cap {CAPS} each), N_tot = {N_TOT}, box 20 "
        f"A, 600 K, full Ewald, f32, xi = {XI}, p_flip 0.5, {args.chains} "
        f"chains, {args.equil} + {args.prod} blocks x {args.steps} steps per "
        "segment; closed form Binomial(N, xi/(1+xi)): mean "
        f"{N_TOT * p:.3f}, var {N_TOT * p * (1 - p):.3f}")
    res = _common.run_parts(args, SEGMENTS, lambda part: run_segment(
        dev, part, args.chains, args.equil, args.prod, args.steps))
    if res is None:
        return 0
    for part, r in res.items():
        label = SEGMENTS[part][0]
        means = np.atleast_1d(r["means"])
        mean, var = float(np.mean(means)), float(np.mean(r["varis"]))
        sem = float(np.std(means) / np.sqrt(len(means)))
        ok = abs(mean - N_TOT * p) < max(0.03 * N_TOT * p, 5 * sem) \
            and abs(var - N_TOT * p * (1 - p)) < 0.2 * N_TOT * p * (1 - p)
        rec.gate(f"[{label}] measured <N_B> = {mean:.3f} +- {sem:.3f}, "
                 f"var = {var:.3f}, worst drift {float(r['worst']):.2e} "
                 f"[{_common.pf(ok)}]", ok)
        rec.gate(f"[{label}] every production block's drift < 2e-3: "
                 f"{_common.pf(bool(r['drift_ok']))}; N_tot conserved: "
                 f"{_common.pf(bool(r['conserved']))}",
                 bool(r["drift_ok"]) and bool(r["conserved"]))
    return rec.write(args.out, res)


if __name__ == "__main__":
    sys.exit(main())
