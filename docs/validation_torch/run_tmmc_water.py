"""SPC/E water vapour-liquid coexistence from molecular TMMC on the card.

Flat-histogram muVT for a rigid molecular fluid with full Ewald
electrostatics: one transition-matrix run (mc/tmmc.py TMMCMol, in-kernel
exchanges and collection deposits: mega="full") yields ln Pi(N) over the
whole density range at 500 K; the equal-basin-weight solve gives the
saturation activity and both coexistence densities, the barrier a Binder
surface-tension estimate, and the run's per-slice energy moments a
first-order temperature extension to 480 K and 520 K.

The sampled model is the truncated one (r_cut 6 A, kappa = 5.6/box, no
LRC) in a 13 A box, so the numbers carry finite-size and truncation
shifts against full-Ewald literature (SPC/E at 500 K: rho_l ~ 0.83 g/cc,
rho_v ~ 0.006 g/cc, gamma ~ 25 mN/m); the gates are banded, plus the
exact internal invariants (S(k), basin residual).  Protocol: stratified
walkers melt at fixed N (p_exchange 0, kernel sweeps), then TMMC blocks
with the first quarter discarded.  `coexistence_run` is the protocol;
chip_smoke.py phase 10 runs it too.

    python3 docs/validation_torch/run_tmmc_water.py [--device cpu]
        [--chains 128] [--melt 10] [--blocks 60] [--steps 2500] [--out FILE]

Writes docs/validation_torch/tmmc_water.txt by default.
"""

import sys
import time

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu_torch.mc.tmmc import (
    TMMCMol,
    coexistence,
    reweight_lnpi_temperature,
    surface_tension,
)
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system

T = 500.0
BOX = 13.0
CAP = 80
Z0 = 2e-4            # near the measured 500 K saturation activity
CHAINS = 128
BLOCKS, STEPS = 60, 2500
EQUIL_BLOCKS = 10
N_ORIENT = 1         # the in-kernel exchange path is unbiased
MEGA = "full"        # exchanges + deposits inside the sweep kernel
G_CC = 18.01528 * 1.66053907  # (N/V A^-3) -> g/cc for water
SEED = 11


def coexistence_run(dev, cap=CAP, box=BOX, chains=CHAINS, melt=EQUIL_BLOCKS,
                    blocks=BLOCKS, steps=STEPS, seed=SEED,
                    mark=lambda stage: None, tag=""):
    """The protocol: melt, TMMC blocks, the coexistence solve and its
    gates.  mark(stage) is called just before the melt ("melt"), the TMMC
    blocks ("tmmc") and just after them ("end"), for launch counts.
    Returns a dict of the results, the gate values and `ok` (gate ->
    bool)."""
    params = RunParams(strict_min_image=False, temperature=T, r_cut=6.0,
                       cutoff_mode="site", coulomb="ewald", use_lrc=False,
                       p_translate=0.5, dr_max=1.0, dphi_max=0.7)
    system = spce_system(cap)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    t0 = time.perf_counter()
    # the stratified lattice starts melt at fixed N (p_exchange = 0): a hot
    # lattice otherwise evaporates before it relaxes, draining every
    # liquid slice
    g = MolGCMC(system, params, activity=Z0, p_exchange=0.0,
                dtype=torch.float32, mega=True, device=dev, generator=gen)
    st = g.init(box, np.linspace(1, cap * 7 // 8, chains).astype(np.int64),
                chains)
    mark("melt")
    for b in range(melt):
        st, stats = g.run_block(st, steps, drift_tol=1e-3)
    out = dict(melt_s=time.perf_counter() - t0,
               melt_energy=stats["energy_mean"] if melt else float("nan"),
               melt_acc=stats["acc_trans"] if melt else float("nan"))
    t = TMMCMol(system, params, activity=Z0, p_exchange=0.4,
                dtype=torch.float32, n_orient=N_ORIENT, mega=MEGA,
                device=dev, generator=gen)
    mark("tmmc")
    max_drift = max_sfac = 0.0
    for b in range(blocks):
        st, stats = t.run_block(st, steps)
        max_drift = max(max_drift, stats["drift_max_rel"])
        max_sfac = max(max_sfac, stats["sfac_err_max"])
        if b == blocks // 4 - 1:
            t.reset_collection()
        if b % 10 == 0 or b == blocks - 1:
            print(f"{tag}block {b}: N [{stats['n_min']},{stats['n_max']}] "
                  f"mean {stats['n_mean']:.1f} visited "
                  f"{stats['visited_frac']:.2f} accI "
                  f"{stats['acc_insert']:.4f} accD {stats['acc_delete']:.4f}"
                  f" drift {stats['drift_max_rel']:.1e} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    mark("end")
    res = coexistence(t.lnpi(), Z0, box ** 3)
    gamma = surface_tension(res["lnpi_coex"], box, T) * 1.380649  # mN/m
    rho_v, rho_l = res["rho_vap"] * G_CC, res["rho_liq"] * G_CC
    cover = stats["visited_frac"]
    # temperature extension: the same run's per-slice energy moments
    # extrapolate ln Pi (first order); the binodal must widen on cooling
    ext = {}
    for t_to in (480.0, 520.0):
        lp = reweight_lnpi_temperature(t.lnpi(), t.uhist, T, t_to,
                                       second_order=False)
        r = coexistence(lp, Z0, box ** 3)
        ext[t_to] = (r["z_coex"], r["rho_vap"] * G_CC, r["rho_liq"] * G_CC)
    out.update(z_coex=res["z_coex"], rho_v=rho_v, rho_l=rho_l, gamma=gamma,
               cover=cover, dlnw=res["dlnw"], max_drift=max_drift,
               max_sfac=max_sfac, ext=ext)
    # 0.25: the carried energy's f32 residue over whole-ladder N
    # excursions, endpoint-relative (acceptance never reads it: every
    # exchange uses fresh pose energies and the carried S(k), gated 1e-3)
    out["ok"] = {
        "rho bands": 0.45 < rho_l < 1.0 and rho_v < 0.05
        and rho_v < rho_l / 5.0,
        "gamma 2-60 mN/m": 2.0 < gamma < 60.0,
        "residual": abs(res["dlnw"]) < 1e-6,
        "coverage > 0.8": cover > 0.8,
        "drift/sfac": max_drift < 0.25 and max_sfac < 1e-3,
        "T-extension": ext[480.0][2] > rho_l > ext[520.0][2]
        and ext[480.0][1] < rho_v < ext[520.0][1]
        and ext[480.0][0] < res["z_coex"] < ext[520.0][0]}
    return out


def main(argv=None):
    ap = _common.parser(__doc__, "tmmc_water.txt")
    ap.add_argument("--chains", type=int, default=CHAINS)
    ap.add_argument("--melt", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_tmmc_water")
    rec = _common.Record(
        dev, f"SPC/E, Ewald kappa = 5.6/box nk 5, r_cut 6 A, no LRC; box "
        f"{BOX} A, cap {CAP}, T = {T} K, {args.chains} stratified walkers, "
        f"{args.melt} x {args.steps} fixed-N melt (mega=True) + "
        f"{args.blocks} x {args.steps} TM steps, n_orient {N_ORIENT}, "
        f"mega={MEGA!r} (in-kernel exchanges + deposits), 1/4 burn-in "
        f"discard, f32, z0 = {Z0}")
    try:
        r = coexistence_run(dev, chains=args.chains, melt=args.melt,
                            blocks=args.blocks, steps=args.steps)
    except ValueError as e:      # no transitions, or a single basin
        rec.gate(f"coexistence solve failed: {e}", False)
        return rec.write(args.out)
    ok, ext = r["ok"], r["ext"]
    rec.gate(f"z* = {r['z_coex']:.4e} A^-3")
    rec.gate(f"rho_vap = {r['rho_v']:.4f} g/cc   rho_liq = "
             f"{r['rho_l']:.4f} g/cc (SPC/E full-Ewald lit at 500 K: ~0.006 "
             f"/ ~0.83; bands rho_l 0.45-1.0, rho_v < 0.05 and < rho_l/5)  "
             f"[{_common.pf(ok['rho bands'])}]", ok["rho bands"])
    rec.gate(f"surface tension (Binder, single box) = {r['gamma']:.1f} "
             f"mN/m (lit ~25; band 2-60)  "
             f"[{_common.pf(ok['gamma 2-60 mN/m'])}]", ok["gamma 2-60 mN/m"])
    rec.gate(f"coverage {r['cover']:.2f} (> 0.8) "
             f"[{_common.pf(ok['coverage > 0.8'])}]; basin residual "
             f"{r['dlnw']:.1e} (< 1e-6) [{_common.pf(ok['residual'])}]",
             ok["coverage > 0.8"] and ok["residual"])
    rec.gate(f"max block drift {r['max_drift']:.1e} (< 0.25), max sfac err "
             f"{r['max_sfac']:.1e} (< 1e-3; acceptance reads fresh pose "
             f"energies + carried S(k), never the carried E)  "
             f"[{_common.pf(ok['drift/sfac'])}]", ok["drift/sfac"])
    rec.gate(f"T-extension (per-slice <U>, 1st order, same run): 480 K -> "
             f"rho_v {ext[480.0][1]:.4f} rho_l {ext[480.0][2]:.4f}; 520 K -> "
             f"rho_v {ext[520.0][1]:.4f} rho_l {ext[520.0][2]:.4f} g/cc; "
             f"binodal widens on cooling  [{_common.pf(ok['T-extension'])}]",
             ok["T-extension"])
    rec.gate(f"route: melt kernel sweeps (mega=True, {r['melt_s']:.1f} s), "
             f"TMMC in-kernel exchanges + deposits (mega={MEGA!r})")
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
