"""In-kernel Widom insertions (the sweep kernel's n_widom) on the card.

The sweep kernel evaluates Widom ghost insertions inside the launch (the
in-kernel exchange evaluator with the state writes removed, depositing
sum exp(-beta dU_ins) per chain).  CPU tests hold the ghost energy to
the plain pose evaluator at fixed poses; this gates the sampled
estimator.  Segments:
  0. the NIST SPC/E configuration's Ewald energy (models/energy.py
     energy_breakdown) against its published total: the reference's
     data file is not in the repository, so the segment reports WAITS
     and takes no part in the result until the file is there;
  1. kernel against plain mu_ex on one equilibrated SPC/E NVT
     trajectory: widom_mega (kernel sweeps + in-kernel ghosts), then the
     plain ghost sampler (mc/widom.py widom_sample) after kernel sweeps
     on the continuing trajectory; the two estimates must agree within
     their combined error;
  2. wall time per (sweep + n_g ghosts) on both paths.

    python3 docs/validation_torch/run_widom_kernel.py [--device cpu]
        [--chains 256] [--equil 300] [--blocks 16] [--sweeps 10]
        [--nist FILE] [--out FILE]

Writes docs/validation_torch/widom_kernel.txt by default.
"""

import os
import sys
import time

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.widom import (
    make_mega_widom_fn,
    make_widom_fn,
)
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    spce_from_nist,
    spce_system,
)
from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

# the reference's data directory, as bench.py's REF (not in the repository)
NIST = os.path.join(os.sep, "root", "reference", "Ewald",
                    "spce_sample_config_periodic1.txt")
GOLD = -4.88596e5          # NIST SRSW config 1 (print precision), K
N_MOL, BOX, TEMP = 96, 16.0, 600.0      # 0.70 g/cc liquid-ish water
N_CHAINS, N_GHOSTS = 256, 32
EQ_SWEEPS, BLOCKS, SWEEPS_PB = 300, 16, 10


def nist_segment(path, rec):
    """Segment 0: the NIST configuration's total energy, or WAITS."""
    if not os.path.exists(path):
        rec.gate(f"[0] NIST golden anchor (config 1): WAITS: {path} not in "
                 "the repository")
        return
    sys_n, coords, com, box = spce_from_nist(path)
    kv, kw = make_kvectors(5, 27)
    f64 = torch.float64
    out = energy_breakdown(sys_n, RunParams(cutoff_mode="site",
                                            coulomb="ewald"),
                           torch.as_tensor(coords, dtype=f64),
                           torch.as_tensor(com, dtype=f64),
                           torch.as_tensor(box, dtype=f64), kv, kw)
    tot = float(out["total"])
    ok = abs(tot - GOLD) / abs(GOLD) < 5e-5
    rec.gate(f"[0] NIST golden anchor (config 1): total = {tot:.6e} K  vs  "
             f"{GOLD:.6e} K  [{_common.pf(ok)}]", ok)


def mu_se(bs):
    m = bs.mean()
    se = bs.std(ddof=1) / np.sqrt(len(bs))
    return -np.log(m), se / m          # delta method on beta*mu


def main(argv=None):
    ap = _common.parser(__doc__, "widom_kernel.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--equil", type=int, default=EQ_SWEEPS)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS_PB)
    ap.add_argument("--nist", default=NIST)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_widom_kernel")
    C, n_g, blocks, spb = args.chains, N_GHOSTS, args.blocks, args.sweeps
    rec = _common.Record(
        dev, f"SPC/E NVT: {N_MOL} waters, box {BOX}, T {TEMP} K, {C} chains, "
        f"{args.equil} adjusting sweeps, then {blocks}x{spb} sweeps x "
        f"{n_g} ghosts in the kernel and {blocks}x{spb} (sweep + {n_g} "
        "plain ghosts), f32")
    nist_segment(args.nist, rec)

    params = RunParams(temperature=TEMP, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", dr_max=0.35, dphi_max=0.45,
                       p_translate=0.5)
    system = spce_system(N_MOL)
    gen = _common.generator(dev, 0)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    state = mc.init_state(cubic_lattice(N_MOL, BOX), box=BOX, n_chains=C)
    t0 = time.perf_counter()
    state = mc.run_steps(state, args.equil, True)
    float(state.energy.sum())
    t_eq = time.perf_counter() - t0
    widom_mega = make_mega_widom_fn(system, params, mc.kvecs, mc.kweights,
                                    n_g, dev)
    _, widom_sample = make_widom_fn(system, params, mc.kvecs, mc.kweights,
                                    dev)

    # kernel phase: blocks x sweeps, n_g in-kernel ghosts per sweep
    bk = []
    t0 = time.perf_counter()
    for _ in range(blocks):
        acc = 0.0
        for _ in range(spb):
            state, bmean = widom_mega(state, gen)
            acc = acc + bmean
        bk.append(float(torch.mean(acc.double())) / spb)
    t_kernel = time.perf_counter() - t0
    bk = np.asarray(bk)

    # plain phase: the same cadence on the continuing trajectory (driver
    # sweeps between samples), ghosts from a generator of their own
    gen_w = _common.generator(dev, 7000)
    bj = []
    t0 = time.perf_counter()
    for _ in range(blocks):
        acc = 0.0
        for _ in range(spb):
            state = mc.run_steps(state, 1, False)
            acc = acc + widom_sample(state, gen_w, n_g)
        bj.append(float(torch.mean(acc.double())) / spb)
    t_plain = time.perf_counter() - t0
    bj = np.asarray(bj)

    mu_k, se_k = mu_se(bk)
    mu_j, se_j = mu_se(bj)
    gap = abs(mu_k - mu_j)
    tol = 3.0 * np.hypot(se_k, se_j)
    mu_ok = bool(gap < tol)
    rec.gate(f"[1] route {mc.route}; equilibration: {args.equil} sweeps, "
             f"{t_eq:.1f} s", mc.route == "sweep")
    rec.gate(f"    beta*mu_ex kernel: {mu_k:+.4f} +/- {se_k:.4f}   "
             f"({blocks}x{spb} sweeps x {C} chains x {n_g} ghosts)")
    rec.gate(f"    beta*mu_ex plain:  {mu_j:+.4f} +/- {se_j:.4f}")
    rec.gate(f"    |gap| = {gap:.4f}  <  3*combined = {tol:.4f}  "
             f"[{_common.pf(mu_ok)}]", mu_ok)
    n_eval = blocks * spb * C * n_g
    rec.gate(f"[2] throughput, per (sweep + {n_g} ghosts) x {C} chains: "
             f"kernel {t_kernel / (blocks * spb) * 1e3:.1f} ms/cycle "
             f"({n_eval / t_kernel:,.0f} ghost evals/s incl. sweeps); plain "
             f"{t_plain / (blocks * spb) * 1e3:.1f} ms/cycle "
             f"({n_eval / t_plain:,.0f}); speedup {t_plain / t_kernel:.1f}x")
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
