"""LJ vapour-liquid phase diagram from TMMC on the card: the coexistence
curve and a critical-point estimate from four flat-histogram runs.

At each temperature one biased muVT run (mc/tmmc.py TMMC) gives ln Pi(N)
over the whole density range, and the equal-basin-weight solve gives
(z*, rho_vap, rho_liq).  The law of rectilinear diameters and 3-D Ising
scaling,

    (rho_l + rho_v)/2 = rho_c + A (T_c - T)
    (rho_l - rho_v)   = B (T_c - T)^0.326,

extrapolate the critical point.  Gates: monotone branches, basin-weight
residuals ~ 0, coverage, a Binder surface tension positive and falling,
the T = 0.95 run's ln Pi extended to T = 1.00 against the direct run, and
(T_c, rho_c) in the band of this truncated model (cut LJ r_cut 2.5, no
shift, no LRC: between the truncated-shifted ~1.09 and full LJ ~1.31).

    python3 docs/validation_torch/run_lj_phase_diagram.py [--device cpu]
        [--chains 256] [--steps 5000] [--blocks-cold 64] [--blocks 48]
        [--parts T ...] [--partials DIR] [--out FILE]

--parts runs some of the temperatures (saved to --partials); the process
that finds all four there writes the record, so the temperatures can run
as processes of their own.  Writes docs/validation_torch/
lj_phase_diagram.txt by default.
"""

import sys
import time

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.tmmc import (
    TMMC,
    coexistence,
    reweight_lnpi_temperature,
    surface_tension,
)
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams

TEMPS = [0.85, 0.95, 1.00, 1.05]
BOX, CAP, Z0 = 6.0, 192, 0.03
CHAINS, STEPS = 256, 5000
BETA_ISING = 0.326
BLOCKS_COLD, BLOCKS = 64, 48      # below T = 0.9, and at the others


def coexist(lnpi_fn, temp):
    """coexistence() and the surface tension of lnpi_fn()'s ln Pi (the
    scalars only), NaNs and the reason where it has no transitions or one
    basin."""
    keys = ("z_coex", "rho_vap", "rho_liq", "dlnw")
    try:
        res = coexistence(lnpi_fn(), Z0, BOX**3)
        return dict({k: float(res[k]) for k in keys}, gamma=surface_tension(
            res["lnpi_coex"], BOX, temp), error="")
    except ValueError as e:
        nan = float("nan")
        return dict({k: nan for k in keys}, gamma=nan, error=str(e))


def run_one(temp, seed, dev, chains, steps, blocks):
    params = RunParams(strict_min_image=False, temperature=temp, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.4,
                       dr_max=0.35, use_lrc=False)
    t = TMMC(lj_system(1), params, activity=Z0, capacity=CAP,
             dtype=torch.float32, device=dev,
             generator=_common.generator(dev, seed))
    # stratified starts: walkers blanket the N axis so the collection
    # matrix covers both basins from block 0
    n_init = np.linspace(2, CAP - 12, chains).astype(np.int32)
    st = t.init(box=BOX, n_init=n_init, n_chains=chains)
    # burn-in discard: deposits of walkers still on their init lattice
    # fabricate ln Pi structure at the high-N frontier; the bias learned
    # during burn-in is kept, only the collection restarts
    discard = blocks // 4
    t0 = time.perf_counter()
    for b in range(blocks):
        st, stats = t.run_block(st, steps, drift_tol=1e-3)
        if b == discard - 1:
            t.reset_collection()
        if b % 8 == 7:
            print(f"  T={temp} block {b}: visited {stats['visited_frac']:.2f}"
                  f" [{time.perf_counter() - t0:.0f} s]", flush=True)
    res = coexist(t.lnpi, temp)
    res["visited"] = stats["visited_frac"]
    # the ln Pi and energy moments, for the temperature extension
    res["lnpi"], res["uhist"] = t.lnpi() if not res["error"] else \
        np.zeros(0), t.uhist.copy()
    return res


def fit_critical(temps, rho_v, rho_l):
    """Least squares on diameters (linear) + order parameter (0.326
    scaling): returns (t_c, rho_c, A, B)."""
    from scipy.optimize import least_squares
    t = np.asarray(temps)
    dm = 0.5 * (rho_l + rho_v)
    op = rho_l - rho_v

    def resid(p):
        tc, rc, a, b = p
        dt = np.maximum(tc - t, 1e-9)
        return np.concatenate([dm - (rc + a * dt),
                               op - b * dt**BETA_ISING])

    p0 = (1.2, 0.32, 0.1, 0.55)
    sol = least_squares(resid, p0, bounds=([1.0, 0.1, 0.0, 0.0],
                                           [2.0, 0.6, 2.0, 3.0]))
    return sol.x


def main(argv=None):
    ap = _common.parser(__doc__, "lj_phase_diagram.txt")
    ap.add_argument("--chains", type=int, default=CHAINS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--blocks-cold", type=int, default=BLOCKS_COLD)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    _common.add_parts(ap, [str(t) for t in TEMPS])
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_lj_phase_diagram")
    rec = _common.Record(
        dev, f"cut LJ r_cut=2.5, no shift, no LRC; box={BOX} cap={CAP}; per "
        f"T in {TEMPS}, {args.chains} stratified walkers x "
        f"{args.blocks}-{args.blocks_cold} x{args.steps} steps, bias per "
        f"block, 1/4 burn-in discard, plain route, f32, z0={Z0}")
    def run(part):
        i = [str(t) for t in TEMPS].index(part)
        temp = TEMPS[i]
        r = run_one(temp, 100 + i, dev, args.chains, args.steps,
                    args.blocks_cold if temp < 0.9 else args.blocks)
        print(f"  T={temp}: z* {r['z_coex']:.5f} rho_v {r['rho_vap']:.4f} "
              f"rho_l {r['rho_liq']:.4f} visited {r['visited']:.2f} "
              f"{rec.stamp()}", flush=True)
        return r

    parts = _common.run_parts(args, [str(t) for t in TEMPS], run)
    if parts is None:
        return 0
    results = [parts[str(t)] for t in TEMPS]

    rho_v = np.asarray([r["rho_vap"] for r in results])
    rho_l = np.asarray([r["rho_liq"] for r in results])
    zs = np.asarray([r["z_coex"] for r in results])
    gam = np.asarray([r["gamma"] for r in results])
    found = not any(str(r["error"]) for r in results)
    tc, rc = (fit_critical(TEMPS, rho_v, rho_l)[:2] if found
              else (float("nan"), float("nan")))

    mono = bool(np.all(np.diff(rho_v) > 0) and np.all(np.diff(rho_l) < 0)
                and np.all(np.diff(zs) > 0))
    resid_ok = all(abs(r["dlnw"]) < 1e-6 for r in results)
    cover_ok = all(r["visited"] > 0.85 for r in results)
    tc_ok = bool(1.05 < tc < 1.35 and 0.25 < rc < 0.40)
    # Binder single-box estimate: positive, vanishing toward T_c, and
    # order-of-magnitude sane at the lowest T
    gamma_ok = bool(np.all(gam > 0) and np.all(np.diff(gam) < 0)
                    and 0.1 < gam[0] < 1.5)
    # temperature extension: the T = 0.95 run's ln Pi extended to T = 1.00
    # by its per-slice energy moments (first order: f32 collection has no
    # usable var(U)) must land near the direct T = 1.00 row
    r95 = results[TEMPS.index(0.95)]
    rex = coexist(lambda: reweight_lnpi_temperature(
        r95["lnpi"], r95["uhist"], 0.95, 1.00, second_order=False), 1.00)
    r10 = results[TEMPS.index(1.00)]
    ex_ok = bool(abs(rex["rho_liq"] - r10["rho_liq"]) < 0.05
                 and abs(rex["rho_vap"] - r10["rho_vap"]) < 0.02
                 and abs(np.log(rex["z_coex"] / r10["z_coex"])) < 0.15)

    for r, temp in zip(results, TEMPS):
        if str(r["error"]):
            rec.gate(f"T={temp}: {r['error']}", False)
    rec.gate("  T      z*        rho_vap   rho_liq   gamma     wall (s)")
    for t, r in zip(TEMPS, results):
        rec.gate(f"  {t:<6} {r['z_coex']:<9.5f} {r['rho_vap']:<9.4f} "
                 f"{r['rho_liq']:<9.4f} {r['gamma']:<9.4f} "
                 f"{float(r['wall']):.0f}")
    rec.gate(f"branches monotone in T: {mono}; basin residuals < 1e-6: "
             f"{resid_ok}; coverage > 0.85: {cover_ok}",
             mono and resid_ok and cover_ok)
    rec.gate("surface tension (Binder, single box): positive, decreasing, "
             f"gamma(0.85) in 0.1-1.5: {gamma_ok}", gamma_ok)
    rec.gate(f"T-extension 0.95 -> 1.00 (per-slice <U>, 1st order): z* "
             f"{rex['z_coex']:.5f} rho_v {rex['rho_vap']:.4f} rho_l "
             f"{rex['rho_liq']:.4f} vs direct {r10['z_coex']:.5f}/"
             f"{r10['rho_vap']:.4f}/{r10['rho_liq']:.4f}: {ex_ok}", ex_ok)
    rec.gate(f"rectilinear-diameter + Ising-0.326 fit: T_c = {tc:.3f}, "
             f"rho_c = {rc:.3f} (bands 1.05-1.35 / 0.25-0.40; "
             "truncated-shifted LJ ~1.09, full LJ ~1.31)", tc_ok)
    return rec.write(args.out, parts)


if __name__ == "__main__":
    sys.exit(main())
