"""Two-particle Boltzmann check of the whole-sweep CUDA kernel.

For two LJ particles the pair-distance density is analytic,
p(r) dr ~ r^2 exp(-u(r)/T) dr for r < L/2.  The histogram sampled
through the sweep kernel (`kernel="sweep"`, csrc/sweep_kernel.cu, two
atoms in a block of 256 threads, the cutoff just under L/2) must match
it: proposal uniformity, the periodic wrap, acceptance and the random
stream end to end, with no reference implementation in the loop.  The
plain route (`kernel="plain"`) runs the same protocol and its acceptance
must agree; the two routes draw from generators of different seeds.
Every sampling round's run_steps draws fresh uniforms from its generator
(checked: no two draws repeat).

    python3 docs/validation_torch/run_mega_boltzmann.py [--device cpu]
        [--chains 512] [--rounds 80] [--gap 5] [--decorrelate 100]
        [--out FILE]

Writes docs/validation_torch/mega_prng_boltzmann.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc import driver, moves
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams

T, BOX, RC = 1.2, 8.0, 3.9
N_CHAINS, N_ROUNDS, SWEEP_GAP = 512, 80, 5
LO, HI, NB = 0.85, 3.6, 40
DECORRELATE = 100
SEED = 20


class DrawLog:
    """Wraps draw_uniforms where both routes call it (mc/moves.py for the
    sweep kernel, mc/driver.py for the plain route) and keeps the first
    row of each draw, to show that consecutive run_steps calls draw fresh
    uniforms."""

    def __init__(self):
        self.rows = []
        self._orig = moves.draw_uniforms

    def __enter__(self):
        def logged(*a, **k):
            u = self._orig(*a, **k)
            self.rows.append(tuple(u[0, 0].double().cpu().tolist()))
            return u
        moves.draw_uniforms = driver.draw_uniforms = logged
        return self

    def __exit__(self, *exc):
        moves.draw_uniforms = driver.draw_uniforms = self._orig

    def distinct(self):
        return len(set(self.rows)), len(self.rows)


def sample_histogram(kernel, dev, chains=N_CHAINS, rounds=N_ROUNDS,
                     gap=SWEEP_GAP, decorrelate=DECORRELATE,
                     dtype=torch.float32, seed=None):
    """(hist, edges, acceptance, route, (distinct, draws)) of one run; the
    generator seeded `seed`, by default SEED for the kernel route and
    SEED + 1 for the others (two streams, as the JAX script's on-core and
    jax.random streams: on one stream the two routes take the same
    decisions, and the acceptance gate would compare a run with itself)."""
    if seed is None:
        seed = SEED if kernel == "sweep" else SEED + 1
    params = RunParams(temperature=T, r_cut=RC, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=1.2,
                       use_lrc=False)
    mc = MonteCarlo(lj_system(2), params, device=dev, dtype=dtype,
                    generator=_common.generator(dev, seed),
                    recompute_chunk=8, kernel=kernel)
    com0 = np.array([[2.0, 2.0, 2.0], [4.0, 4.0, 4.0]])
    state = mc.init_state(com0, box=BOX, n_chains=chains)
    state = mc.run_steps(state, decorrelate, False)
    hist = np.zeros(NB)
    edges = None
    with DrawLog() as log:
        for _ in range(rounds):
            state = mc.run_steps(state, gap, False)
            d = (state.com[:, 0] - state.com[:, 1]).double().cpu().numpy()
            d = d - BOX * np.round(d / BOX)
            r = np.linalg.norm(d, axis=1)
            h, edges = np.histogram(r, bins=NB, range=(LO, HI))
            hist += h
    att = float(state.att.sum())
    acc = float(state.acc.sum()) / max(att, 1.0)
    return hist, edges, acc, mc.route, log.distinct()


def gates(hist, edges, acc_kernel, acc_plain):
    """The JAX script's three gates: (chi2/bin, max |z|, peak offset, ok,
    centers, p_meas, p_exact, z)."""
    centers = 0.5 * (edges[1:] + edges[:-1])
    u = np.where(centers < RC, 4.0 * (centers**-12 - centers**-6), 0.0)
    p_exact = centers**2 * np.exp(-u / T)
    p_exact /= p_exact.sum()
    n_tot = hist.sum()
    p_meas = hist / n_tot
    sigma = np.sqrt(np.maximum(p_exact * n_tot, 1.0)) / n_tot
    z = (p_meas - p_exact) / sigma
    chi2 = float(np.mean(z**2))
    peak_off = int(abs(np.argmax(p_meas) - np.argmax(p_exact)))
    ok = chi2 < 9.0 and peak_off <= 3 and abs(acc_kernel - acc_plain) < 0.02
    return chi2, float(np.abs(z).max()), peak_off, ok, centers, p_meas, \
        p_exact, z


def main(argv=None):
    ap = _common.parser(__doc__, "mega_prng_boltzmann.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--rounds", type=int, default=N_ROUNDS)
    ap.add_argument("--gap", type=int, default=SWEEP_GAP)
    ap.add_argument("--decorrelate", type=int, default=DECORRELATE)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_mega_boltzmann")
    depth = (args.chains, args.rounds, args.gap, args.decorrelate)
    rec = _common.Record(
        dev, f"{args.chains} chains x {args.rounds} rounds x {args.gap} "
        f"sweeps after {args.decorrelate}, T={T}, box={BOX}, rc={RC}, f32, "
        "whole-sweep kernel (kernel=\"sweep\") against the plain route")
    hist, edges, acc_k, route, (n_dist, n_draw) = sample_histogram(
        "sweep", dev, *depth)
    _, _, acc_p, route_p, (n_dist_p, n_draw_p) = sample_histogram(
        "plain", dev, *depth)
    chi2, zmax, peak_off, ok, centers, p_meas, p_exact, z = gates(
        hist, edges, acc_k, acc_p)
    rec.gate(f"routes: {route} and {route_p}",
             route == "sweep" and route_p == "plain")
    rec.gate(f"samples: {int(hist.sum())}")
    rec.gate(f"chi2/bin vs analytic p(r) ~ r^2 exp(-u/T): {chi2:.3f} "
             "(bound 9.0, Poisson errors, correlated samples)",
             chi2 < 9.0)
    rec.gate(f"max |z|: {zmax:.2f}")
    rec.gate(f"peak-bin offset: {peak_off} (bound 3)", peak_off <= 3)
    rec.gate(f"acceptance: sweep kernel {acc_k:.4f} vs plain {acc_p:.4f} "
             "(bound |diff| < 0.02)", abs(acc_k - acc_p) < 0.02)
    fresh = n_dist == n_draw and n_dist_p == n_draw_p
    rec.gate(f"fresh uniforms per run_steps call: {n_dist} of {n_draw} "
             f"draws distinct (kernel), {n_dist_p} of {n_draw_p} (plain)",
             fresh)
    rec.note("bin_center  p_measured  p_exact  z")
    for c, pm, pe, zz in zip(centers, p_meas, p_exact, z):
        rec.note(f"{c:10.4f}  {pm:.6f}  {pe:.6f}  {zz:+.2f}")
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
