"""SPC/E compressed-liquid equation of state in one run on the card.

A per-chain pressure ladder runs eight isobars (1 to 3000 bar at 298.15
K) in one NPT run: 512 chains, 64 per pressure, every chain on its own
isobar.  Gates: the 1-bar density on the ambient SPC/E value; the ladder
slope d(ln rho)/dP over 1-1000 bar (the isothermal compressibility)
against experiment; the same kappa_T from the volume fluctuations of the
same run (<dV^2> / T <V>), the fluctuation-dissipation self-consistency;
rho rising with P; the block drift.

    python3 docs/validation_torch/run_spce_eos.py [--device cpu]
        [--chains-per-p 64] [--equil 36] [--prod 20] [--sweeps 250]
        [--out FILE]

Writes docs/validation_torch/spce_eos.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.utils.constants import (
    AVOGADRO,
    BOLTZMANN,
)

N_MOL = 216
T = 298.15
M_WATER = 18.015268
BAR = 1.0e5 / BOLTZMANN * 1e-30            # 1 bar in K/Angstrom^3
P_BARS = np.array([1.0, 250.0, 500.0, 750.0, 1000.0, 1500.0, 2000.0,
                   3000.0])
CHAINS_PER_P = 64
EQUIL_BLOCKS = 36
PROD_BLOCKS = 20
SWEEPS = 250
KAPPA_EXP = 4.52e-5                         # 1/bar, water 25 C
RHO_EXP_1BAR = 0.997
SEED = 11


def g_per_cc(n_density):
    return n_density * M_WATER / AVOGADRO * 1e24


def main(argv=None):
    ap = _common.parser(__doc__, "spce_eos.txt")
    ap.add_argument("--chains-per-p", type=int, default=CHAINS_PER_P)
    ap.add_argument("--equil", type=int, default=EQUIL_BLOCKS)
    ap.add_argument("--prod", type=int, default=PROD_BLOCKS)
    ap.add_argument("--sweeps", type=int, default=SWEEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_spce_eos")
    cpp, n_p = args.chains_per_p, len(P_BARS)
    n_chains = cpp * n_p
    rec = _common.Record(
        dev, f"{N_MOL} waters, {T} K, Ewald r_cut 9 A, {n_chains} chains = "
        f"{n_p} isobars x {cpp}, {args.equil}/{args.prod} blocks x "
        f"{args.sweeps} sweeps, whole-sweep kernel + ln-V volume moves, "
        "f32")
    ladder = np.repeat(P_BARS, cpp) * BAR                 # (C,) K/A^3
    params = RunParams(temperature=T, r_cut=9.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.25,
                       dphi_max=0.3, pressure=None, p_volume=0.2,
                       dv_max=0.02)
    mc = MonteCarlo(spce_system(N_MOL), params, device=dev,
                    generator=_common.generator(dev, SEED),
                    pressure_ladder=torch.as_tensor(ladder, device=dev))
    box0 = (N_MOL / 0.0334) ** (1.0 / 3.0)
    state = mc.init_state(cubic_lattice(N_MOL, box0), box=box0,
                          n_chains=n_chains)
    for b in range(args.equil):
        state, stats = mc.run_block(state, args.sweeps, adjust=True)
        if b % 6 == 0 or b == args.equil - 1:
            rho = g_per_cc(N_MOL / state.box.double().cpu().numpy() ** 3)
            by_p = rho.reshape(n_p, cpp).mean(axis=1)
            print(f"equil {b:2d}: rho(1 bar) {by_p[0]:.4f}  "
                  f"rho(3 kbar) {by_p[-1]:.4f}  "
                  f"drift {stats['drift_max_rel']:.1e} {rec.stamp()}",
                  flush=True)
    vols, worst = [], 0.0
    for b in range(args.prod):
        state, stats = mc.run_block(state, args.sweeps, adjust=False)
        worst = max(worst, stats["drift_max_rel"])
        vols.append(state.box.double().cpu().numpy() ** 3)
    prod = len(vols)
    vols = np.stack(vols)                                # (B, C)
    byp = vols.reshape(prod, n_p, cpp)
    v_mean = byp.mean(axis=(0, 2))                       # (P,)
    rho = g_per_cc(N_MOL / byp)                          # (B, P, CpP)
    rho_mean = (N_MOL / byp).mean(axis=(0, 2)) * M_WATER / AVOGADRO * 1e24
    rho_sem = rho.mean(axis=2).std(axis=0) / np.sqrt(prod)

    # ladder route: kappa_T = d ln rho / dP from the 1..1000 bar points
    lo = slice(0, 5)
    slope, _ = np.polyfit(P_BARS[lo], np.log(rho_mean[lo]), 1)
    # fluctuation route on the same samples, pooled per isobar
    var_v = vols.reshape(-1, n_p, cpp).transpose(1, 0, 2) \
        .reshape(n_p, -1).var(axis=1)
    kappa_fluct = var_v / (T * v_mean) * BAR             # 1/bar per isobar
    kappa_fl_lo = float(np.mean(kappa_fluct[lo]))

    rec.gate(f"route: {mc.route}", mc.route == "sweep")
    rec.gate("P(bar)   rho(g/cc)  +-sem      kappa_fluct(1/bar)")
    for p, r, s, k in zip(P_BARS, rho_mean, rho_sem, kappa_fluct):
        rec.gate(f"{p:7.0f}  {r:.4f}    {s:.4f}     {k:.2e}")
    rec.gate(f"ladder kappa_T (d ln rho/dP, 1-1000 bar) = {slope:.2e} /bar "
             "(bound |slope / experiment - 1| < 0.40)",
             abs(slope / KAPPA_EXP - 1.0) < 0.40)
    rec.gate(f"fluctuation kappa_T (same range)         = {kappa_fl_lo:.2e} "
             "/bar (bound |slope / fluctuation - 1| < 0.35)",
             abs(slope / kappa_fl_lo - 1.0) < 0.35)
    rec.gate(f"experiment 25 C                           = {KAPPA_EXP:.2e} "
             "/bar")
    rec.gate(f"rho(1 bar) = {rho_mean[0]:.4f} g/cc (experiment "
             f"{RHO_EXP_1BAR}; bound 0.015)",
             abs(rho_mean[0] - RHO_EXP_1BAR) < 0.015)
    rec.gate(f"rho rising with P: {bool(np.all(np.diff(rho_mean) > 0.0))}",
             np.all(np.diff(rho_mean) > 0.0))
    rec.gate(f"worst block drift: {worst:.2e} (bound 5e-5)", worst < 5e-5)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
