"""MBAR activity pooling of an interacting-LJ muVT activity-ladder run on
the card.

mc/mbar.py reweight_activity_mbar pools muVT samples taken at several
activities: at fixed T, V the beta U term is common to every activity
state and cancels out of MBAR, so only the N series is needed.  One
8-rung x 32-chain activity ladder (mc/gcmc.py with a (n_chains,)
activity), MBAR-pooled, predicts <N> at two activities between rungs,
gated against direct muVT runs at those activities.

    python3 docs/validation_torch/run_gcmc_mbar.py [--device cpu]
        [--per-rung 32] [--direct-chains 256] [--blocks 8] [--steps 1500]
        [--equil 4] [--out FILE]

Writes docs/validation_torch/gcmc_mbar.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gcmc import GCMC
from metropolismontecarlo_tpu_torch.mc.mbar import reweight_activity_mbar
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams

BOX, T = 7.0, 2.0
Z_RUNGS = np.geomspace(0.15, 0.50, 8)        # ratio ~1.19 per rung
PER_RUNG = 32
Z_TARGETS = [0.22, 0.40]
CAP = 256
BLOCKS, STEPS, EQUIL_BLOCKS = 8, 1500, 4
DIRECT_CHAINS = 256


def _params():
    return RunParams(strict_min_image=False, temperature=T, r_cut=2.5,
                     cutoff_mode="site", coulomb="none", p_translate=0.5,
                     dr_max=0.4, use_lrc=False)


def run(activity, n_chains, seed, dev, blocks, steps, equil):
    """One muVT run (scalar z or ladder): (blocks, C) N samples and the
    block-mean trace; full_frac of every block."""
    g = GCMC(lj_system(1), _params(), activity=activity, capacity=CAP,
             dtype=torch.float32, device=dev,
             generator=_common.generator(dev, seed))
    st = g.init(box=BOX, n_init=32, n_chains=n_chains)
    for _ in range(equil):
        st, _ = g.run_block(st, steps)
    samples, means, full = [], [], 0.0
    for _ in range(blocks):
        st, stats = g.run_block(st, steps, drift_tol=1e-4)
        full = max(full, stats["full_frac"])
        samples.append(st.active.sum(1).cpu().numpy())
        means.append(stats["n_mean"])
    return np.stack(samples), means, full


def main(argv=None):
    ap = _common.parser(__doc__, "gcmc_mbar.txt")
    ap.add_argument("--per-rung", type=int, default=PER_RUNG)
    ap.add_argument("--direct-chains", type=int, default=DIRECT_CHAINS)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gcmc_mbar")
    depth = (dev, args.blocks, args.steps, args.equil)
    per, K = args.per_rung, len(Z_RUNGS)
    rec = _common.Record(
        dev, f"box={BOX} T={T} r_cut=2.5 no-LRC, one ladder run of {K} rungs "
        f"x {per} chains (z in [{Z_RUNGS[0]:.2f}, {Z_RUNGS[-1]:.2f}] "
        f"geometric), {args.blocks} blocks x {args.steps} steps after "
        f"{args.equil * args.steps} equil, direct runs of "
        f"{args.direct_chains} chains, plain route, f32")
    ladder = np.repeat(Z_RUNGS, per)
    samp, _, full = run(ladder, ladder.size, 11, *depth)     # (B, K*per)
    # regroup to (K, S): rung k owns chains [k*per, (k+1)*per)
    n_kn = (samp.reshape(args.blocks, K, per).transpose(1, 0, 2)
            .reshape(K, -1))
    out = reweight_activity_mbar(n_kn, Z_RUNGS, Z_TARGETS)
    rec.gate(f"pooled samples {n_kn.size}; rung <N>: "
             f"{np.round(n_kn.mean(axis=1), 1).tolist()}")
    for j, z in enumerate(Z_TARGETS):
        _, d_means, full_j = run(z, args.direct_chains, 50 + j, *depth)
        full = max(full, full_j)
        d_mean = float(np.mean(d_means))
        d_sem = float(np.std(d_means) / np.sqrt(len(d_means)))
        m, ess = out["n_mean"][j], out["ess"][j]
        err = abs(m - d_mean)
        tol = max(5.0 * d_sem, 0.01 * d_mean)
        rec.gate(f"z={z}: MBAR <N> {m:.2f} (ess {ess:.0f} of {n_kn.size}) "
                 f"vs direct {d_mean:.2f} +- {d_sem:.2f} [|d| {err:.2f} < "
                 f"{tol:.2f}; ess > {0.02 * n_kn.size:.0f}]",
                 err < tol and ess > 0.02 * n_kn.size)
    rec.gate(f"capacity never saturated: full_frac max {full:.3f} (bound 0)",
             full == 0.0)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
