"""Constant-pressure (NPT) Gibbs ensemble on the card: CO2/N2 at 240 K
and fixed P, the cross-method anchor against the NVT-Gibbs record.

The JAX package's NVT-Gibbs record (docs/validation/gibbs_co2_n2.txt,
same model and protocol) measured the sampled model's coexistence state
at fixed total volume.  The NPT-Gibbs ensemble (BinaryGibbsEnsemble with
npt_pressure: per-box ln-V volume moves against a pressure bath, and
per-species transfers in the Gibbs kernel, mega="full") run at that
measured pressure must reproduce the same coexistence compositions and
densities: two ensembles, one sampled model, no literature input.  The
overall composition z_N2 = 0.1 lies inside the measured two-phase
envelope, so the two-box NPT-Gibbs state is lever-rule stable.

Gates: liquid x_N2 and vapour y_N2 within +-50% of the anchors; rho_liq
within +-10% of 0.918 g/cc; the vapour box's production-averaged
pressure_fd equal to P_bath within max(3 sem, 5%); every block's drift
and structure-factor invariants.  The liquid box's pressure is reported,
not gated (its error bar at this run length spans any gate).  The
divergence of ROADMAP queue 3 (the port passes npt_pressure on the
hybrid route, JAX does not) does not apply: this protocol runs
mega="full".

    python3 docs/validation_torch/run_gibbs_npt_co2_n2.py [--device cpu]
        [--chains 64] [--melt 6] [--blocks 36] [--steps 2000] [--out FILE]

Writes docs/validation_torch/gibbs_npt_co2_n2.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
    BinaryGibbsEnsemble,
)
from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

T = 240.0
P_BAR = 27.3                    # the NVT-Gibbs record's vapour-box
BAR = 1.0e5 / 1.380649e-23 * 1e-30   # pressure (K/A^3 per bar)
BOXES = (17.0, 28.0)
CAPS = (96, 16)
N_INIT = [[72, 18], [2, 8]]
N_CHAINS = 64
MELT_BLOCKS, BLOCKS, STEPS = 6, 36, 2000
M_CO2, M_N2 = 44.0095, 28.0134
AMU = 1.66053907

# NVT-Gibbs anchors (the JAX package's gibbs_co2_n2.txt protocol)
X_N2_REF, Y_N2_REF, RHO_L_REF = 0.0271, 0.3959, 0.918


def mass_rho(n0, n1, v):
    return (n0 * M_CO2 + n1 * M_N2) * AMU / v


def main(argv=None):
    ap = _common.parser(__doc__, "gibbs_npt_co2_n2.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--melt", type=int, default=MELT_BLOCKS)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gibbs_npt_co2_n2")
    # tuned at a generous upper box: per-box NPT volumes fluctuate, and
    # the consistency guard re-checks at every block end
    kappa_l, nk, ksq = tune_parameters(1.35 * max(BOXES), 7.5, 1e-3)
    params = RunParams(temperature=T, r_cut=7.5,
                       cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=0.9,
                       dphi_max=0.9, p_volume=0.01, kappa_L=kappa_l,
                       nk=nk, ksq_max=ksq, strict_min_image=False)
    sys_ = co2_n2_system(*CAPS)
    p_bath = P_BAR * BAR
    rec = _common.Record(
        dev, f"NPT-Gibbs TraPPE CO2/N2, T = {T} K, P_bath = {P_BAR} bar (the "
        f"NVT-Gibbs record's bubble pressure), totals CO2 "
        f"{sum(N_INIT[0])}, N2 {sum(N_INIT[1])} (z_N2 = 0.10, inside the "
        f"envelope [{X_N2_REF}, {Y_N2_REF}]); {args.chains} chains; tuned "
        f"Ewald kappa_L {kappa_l:.2f}, nk {nk}, ksq {ksq}; melt "
        f"{args.melt} x {args.steps} plain steps, then {args.blocks} x "
        f"{args.steps} steps (in-kernel transfers, mega='full'; per-box "
        f"ln-V volume moves against the bath), the last "
        f"{args.blocks - args.blocks // 3} production; f32")
    gen = _common.generator(dev, 29)
    g0 = BinaryGibbsEnsemble(sys_, params, dv_max=0.0, p_transfer=0.0,
                             dtype=torch.float32, device=dev, generator=gen)
    st = g0.init(boxes=BOXES, n_init=N_INIT, n_chains=args.chains)
    for b in range(args.melt):
        st, stats = g0.run_block(st, args.steps)
        if b % 2 == 0:
            print(f"melt {b}: accD {stats['acc_disp']:.3f} "
                  f"drift {stats['drift_max_rel']:.2e} {rec.stamp()}",
                  flush=True)

    g = BinaryGibbsEnsemble(sys_, params, dv_max=0.04, p_transfer=0.35,
                            dtype=torch.float32, mega="full",
                            npt_pressure=p_bath, device=dev, generator=gen)
    prod_from = args.blocks // 3
    acc = {"rho_liq": [], "x": [], "y": [], "p_liq": [], "p_vap": []}
    ok_blocks, worst_drift, worst_sfac = True, 0.0, 0.0
    for b in range(args.blocks):
        st, stats = g.run_block(st, args.steps)
        ok_blocks &= (stats["sfac_err_max"] < 1e-3
                      and stats["drift_max_rel"] < 3e-2)
        worst_drift = max(worst_drift, stats["drift_max_rel"])
        worst_sfac = max(worst_sfac, stats["sfac_err_max"])
        n0 = st.active0.sum(2).double().cpu().numpy()
        n1 = st.active1.sum(2).double().cpu().numpy()
        v = st.box.double().cpu().numpy() ** 3
        rho_m = mass_rho(n0, n1, v)
        liq = rho_m.argmax(axis=1)
        ch = np.arange(rho_m.shape[0])
        xn2 = n1 / np.maximum(n0 + n1, 1.0)
        p_box = g.pressure_fd(st).double().cpu().numpy() / BAR
        if b >= prod_from:
            acc["rho_liq"].append(rho_m[ch, liq].mean())
            acc["x"].append(xn2[ch, liq].mean())
            acc["y"].append(xn2[ch, 1 - liq].mean())
            acc["p_liq"].append(p_box[ch, liq].mean())
            acc["p_vap"].append(p_box[ch, 1 - liq].mean())
        if b % 4 == 0:
            print(f"block {b}: rho_l {rho_m[ch, liq].mean():.3f}  "
                  f"x {xn2[ch, liq].mean():.4f}  "
                  f"y {xn2[ch, 1 - liq].mean():.4f}  "
                  f"P {p_box[ch, 0].mean():.1f}/{p_box[ch, 1].mean():.1f}"
                  f"  accX {stats['acc_transfer0']:.3f}/"
                  f"{stats['acc_transfer1']:.3f}  "
                  f"accV {stats['acc_vol']:.2f}  "
                  f"drift {stats['drift_max_rel']:.1e} {rec.stamp()}",
                  flush=True)

    rho_l = float(np.mean(acc["rho_liq"]))
    x = float(np.mean(acc["x"]))
    y = float(np.mean(acc["y"]))
    p_l = float(np.mean(acc["p_liq"]))
    p_v = float(np.mean(acc["p_vap"]))
    sem_pl = float(np.std(acc["p_liq"]) / np.sqrt(len(acc["p_liq"])))
    sem_pv = float(np.std(acc["p_vap"]) / np.sqrt(len(acc["p_vap"])))
    ok_x = 0.5 * X_N2_REF < x < 1.5 * X_N2_REF
    ok_y = 0.5 * Y_N2_REF < y < 1.5 * Y_N2_REF
    ok_rho = abs(rho_l - RHO_L_REF) < 0.10 * RHO_L_REF
    # the vapour box's FD pressure is tight and constrains equality with
    # the bath; the ~90-molecule liquid's fluctuates by tens of bar
    ok_p = abs(p_v - P_BAR) < max(3 * sem_pv, 0.05 * P_BAR)
    rec.gate(f"production ({args.blocks - prod_from} blocks):")
    rec.gate(f"rho_liq = {rho_l:.3f} g/cc (NVT-Gibbs anchor {RHO_L_REF}; "
             f"band +-10%)  [{_common.pf(ok_rho)}]", ok_rho)
    rec.gate(f"liquid x_N2 = {x:.4f} (anchor {X_N2_REF}; band +-50% rel)  "
             f"[{_common.pf(ok_x)}]", ok_x)
    rec.gate(f"vapor  y_N2 = {y:.4f} (anchor {Y_N2_REF}; band +-50% rel)  "
             f"[{_common.pf(ok_y)}]", ok_y)
    rec.gate(f"bath equilibrium (gated on the vapour box, band max(3 sem, "
             f"5%)): P_vap = {p_v:.1f} +- {sem_pv:.1f} bar vs bath {P_BAR}  "
             f"[{_common.pf(ok_p)}]", ok_p)
    rec.gate(f"P_liq = {p_l:.1f} +- {sem_pl:.1f} bar (reported, not gated)")
    rec.gate(f"every block: S(k) error < 1e-3 (worst {worst_sfac:.1e}), "
             f"drift < 3e-2 (worst {worst_drift:.1e})  "
             f"[{_common.pf(ok_blocks)}]", ok_blocks)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
