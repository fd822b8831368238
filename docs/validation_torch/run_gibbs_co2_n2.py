"""Binary Gibbs ensemble on the card: CO2/N2 vapour-liquid equilibrium at
240 K.

The two-component Gibbs ensemble (mc/gibbs_binary.py BinaryGibbsEnsemble)
on the TraPPE CO2 + N2 mixture: fixed totals (90 CO2, 10 N2) in two boxes
exchanging volume and molecules of either species.  At 240 K the boxes
split into a dense CO2-rich liquid and a vapour in which the
supercritical N2 (T_c = 126 K) concentrates: the K-factor K_N2 = y_N2 /
x_N2 >> 1 is the physics of flue-gas liquefaction.

Gates: mass-density bands (liquid 0.6-1.15, vapour < half the liquid),
N2 vapour enrichment K_N2 > 1.5, the two boxes' pressures (pressure_fd:
the exact dU/dV of the sampled model per box; the vapour box's is the
mixture bubble pressure) equal within 4 combined errors and in 2-60 bar,
per-species mu-equality by Widom ghosts (N2 within 0.4 kT, the
fat-tailed CO2 within 1.0 kT), and every production block's drift and
structure-factor invariants.  Ewald is tuned for the largest box; the
liquid box melts with transfers off first (plain steps, fixed
composition).  Transfers then run in the Gibbs kernel (mega="full"), or
as plain Rosenbluth steps with --mega plain (n_orient 4).  Liquid-box
Kirkwood-Buff integrals of site-site RDFs are reported, not gated.

    python3 docs/validation_torch/run_gibbs_co2_n2.py [--device cpu]
        [--chains 64] [--melt 6] [--blocks 36] [--steps 2000]
        [--mega full|plain] [--out FILE]

Writes docs/validation_torch/gibbs_co2_n2.txt by default.
"""

import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import binary_atom_ok
from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
    BinaryGibbsEnsemble,
)
from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.observables import (
    MaskedRDFAccumulator,
    kirkwood_buff_integral,
)
from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

# 240 K: the sampled model truncates LJ at 7.5 A with no LRC, which lowers
# the mixture critical point by ~10%; at 240 K it is solidly subcritical
T = 240.0
BOXES = (17.0, 28.0)
CAPS = (96, 16)                 # per-box slots (CO2, N2)
N_INIT = [[72, 18], [2, 8]]     # [species][box]
N_CHAINS = 64
MELT_BLOCKS, BLOCKS, STEPS = 6, 36, 2000
N_ORIENT = 4
M_CO2, M_N2 = 44.0095, 28.0134
AMU = 1.66053907
K_PER_A3_TO_BAR = 138.065      # the JAX script's factor
N_GHOSTS = 128                 # Widom ghosts per box, species and block


def mass_rho(n0, n1, v):
    return (n0 * M_CO2 + n1 * M_N2) * AMU / v


def take_box(x, liq):
    """x (C, 2, ...) -> (C, ...): each chain's box `liq` (C,)."""
    return x[torch.arange(x.shape[0], device=x.device), liq]


def main(argv=None):
    ap = _common.parser(__doc__, "gibbs_co2_n2.txt")
    ap.add_argument("--chains", type=int, default=N_CHAINS)
    ap.add_argument("--melt", type=int, default=MELT_BLOCKS)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--mega", choices=("full", "plain"), default="full")
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gibbs_co2_n2")
    kappa_l, nk, ksq = tune_parameters(33.0, 7.5, 5e-3)
    params = RunParams(strict_min_image=False, temperature=T, r_cut=7.5,
                       cutoff_mode="site", coulomb="ewald",
                       use_lrc=False, p_translate=0.5, dr_max=0.9,
                       dphi_max=0.9, p_volume=0.01, kappa_L=kappa_l,
                       nk=nk, ksq_max=ksq)
    sys_ = co2_n2_system(*CAPS)
    mega, n_or = {"full": ("full", 1), "plain": (None, N_ORIENT)}[args.mega]
    rec = _common.Record(
        dev, f"TraPPE CO2/N2 binary Gibbs, T = {T} K, boxes {BOXES} A, "
        f"totals CO2 {sum(N_INIT[0])}, N2 {sum(N_INIT[1])}, caps {CAPS}; "
        f"{args.chains} chains; tuned Ewald kappa_L {kappa_l:.2f}, nk {nk}, "
        f"ksq {ksq}, r_cut 7.5, no LRC; melt {args.melt} x {args.steps} "
        f"plain steps at fixed composition, then {args.blocks} x "
        f"{args.steps} steps (dv_max 0.04, p_transfer 0.35, p_volume 0.01), "
        f"the last {args.blocks - args.blocks // 3} production; f32")
    gen = _common.generator(dev, 23)

    # phase 0: melt the lattice starts at fixed composition
    g0 = BinaryGibbsEnsemble(sys_, params, dv_max=0.0, p_transfer=0.0,
                             dtype=torch.float32, device=dev, generator=gen)
    st = g0.init(boxes=BOXES, n_init=N_INIT, n_chains=args.chains)
    for b in range(args.melt):
        st, stats = g0.run_block(st, args.steps)
        if b % 2 == 0:
            print(f"melt {b}: accD {stats['acc_disp']:.3f} "
                  f"drift {stats['drift_max_rel']:.2e} {rec.stamp()}",
                  flush=True)

    # phase 1: full Gibbs moves
    g = BinaryGibbsEnsemble(sys_, params, dv_max=0.04, p_transfer=0.35,
                            dtype=torch.float32, n_orient=n_or, mega=mega,
                            device=dev, generator=gen)
    rec.gate("transfers: " + ("in-kernel unbiased (mega='full')" if mega
                              else f"plain Rosenbluth n_orient={n_or}"))
    prod_from = args.blocks // 3
    acc = {"rho_liq": [], "rho_vap": [], "x": [], "p_liq": [], "p_vap": []}
    # liquid-box structure: one site per molecule (C of CO2, type 0; the M
    # site of N2, type 3) under the activity mask
    rdfs = {k: MaskedRDFAccumulator(sys_, a, b, r_max=8.0, n_bins=160)
            for k, a, b in (("CO2-CO2", 0, 0), ("CO2-N2", 0, 3),
                            ("N2-N2", 3, 3))}
    ok_blocks, worst_drift, worst_sfac = True, 0.0, 0.0
    for b in range(args.blocks):
        st, stats = g.run_block(st, args.steps)
        ok_blocks &= (stats["sfac_err_max"] < 1e-3
                      and stats["drift_max_rel"] < 3e-2)
        worst_drift = max(worst_drift, stats["drift_max_rel"])
        worst_sfac = max(worst_sfac, stats["sfac_err_max"])
        n0 = st.active0.sum(2).double().cpu().numpy()         # (C, 2)
        n1 = st.active1.sum(2).double().cpu().numpy()
        v = st.box.double().cpu().numpy() ** 3
        rho_m = mass_rho(n0, n1, v)
        liq = rho_m.argmax(axis=1)
        ch = np.arange(rho_m.shape[0])
        xn2 = n1 / np.maximum(n0 + n1, 1.0)
        if b >= prod_from:
            liq_t = torch.as_tensor(liq, device=st.box.device)
            ok_l = binary_atom_ok(sys_, take_box(st.active0, liq_t),
                                  take_box(st.active1, liq_t))
            for rdf in rdfs.values():
                rdf.update(take_box(st.coords, liq_t),
                           take_box(st.box, liq_t), ok_l)
            acc["rho_liq"].append(rho_m[ch, liq].mean())
            acc["rho_vap"].append(rho_m[ch, 1 - liq].mean())
            acc["x"].append((xn2[ch, liq].mean(), xn2[ch, 1 - liq].mean()))
            p = g.pressure_fd(st).double().cpu().numpy() * K_PER_A3_TO_BAR
            acc["p_liq"].append(p[ch, liq].mean())
            acc["p_vap"].append(p[ch, 1 - liq].mean())
            # per-species Widom ghosts: number density and <e^-b dU> per
            # (box, species), phase-sorted: the mu-equality data
            for s, nsp in ((0, n0), (1, n1)):
                w = g.widom_boltzmann(st, N_GHOSTS, s).double() \
                    .cpu().numpy()
                rho_s = nsp / v
                for ph, idx in (("liq", liq), ("vap", 1 - liq)):
                    acc.setdefault(("w", s, ph), []).append(
                        w[ch, idx].mean())
                    acc.setdefault(("rho", s, ph), []).append(
                        rho_s[ch, idx].mean())
        if b % 4 == 0 or b == args.blocks - 1:
            print(f"blk {b}: rho_l {rho_m[ch, liq].mean():.3f} "
                  f"rho_v {rho_m[ch, 1 - liq].mean():.3f} g/cc  "
                  f"xN2 l/v {xn2[ch, liq].mean():.3f}/"
                  f"{xn2[ch, 1 - liq].mean():.3f}  "
                  f"accX {stats['acc_transfer0']:.3f}/"
                  f"{stats['acc_transfer1']:.3f}  "
                  f"accV {stats['acc_vol']:.3f}  "
                  f"drift {stats['drift_max_rel']:.1e} {rec.stamp()}",
                  flush=True)

    rho_l = float(np.mean(acc["rho_liq"]))
    rho_v = float(np.mean(acc["rho_vap"]))
    x_l = float(np.mean([a[0] for a in acc["x"]]))
    y_v = float(np.mean([a[1] for a in acc["x"]]))
    k_n2 = y_v / max(x_l, 1e-6)
    nb = len(acc["p_liq"])
    p_liq, p_vap = float(np.mean(acc["p_liq"])), float(np.mean(acc["p_vap"]))
    p_liq_sem = float(np.std(acc["p_liq"]) / np.sqrt(nb))
    p_vap_sem = float(np.std(acc["p_vap"]) / np.sqrt(nb))
    ok_p = (abs(p_liq - p_vap) < 4 * (p_liq_sem + p_vap_sem)
            and 2.0 < p_vap < 60.0)

    def bmu(s, ph):
        return float(np.log(np.mean(acc[("rho", s, ph)]))
                     - np.log(np.mean(acc[("w", s, ph)])))

    dmu = [bmu(s, "liq") - bmu(s, "vap") for s in (0, 1)]
    ok_mu = abs(dmu[1]) < 0.4 and abs(dmu[0]) < 1.0
    ok_rho = 0.6 < rho_l < 1.15 and rho_v < 0.5 * rho_l
    ok_k = k_n2 > 1.5 and y_v > x_l

    rec.gate(f"production ({args.blocks - prod_from} blocks): rho_liq = "
             f"{rho_l:.3f} g/cc (CO2 expt ~1.09 pure at 240 K), rho_vap = "
             f"{rho_v:.3f} g/cc; bands liquid 0.6-1.15, vapour < half the "
             f"liquid  [{_common.pf(ok_rho)}]", ok_rho)
    rec.gate(f"N2 mole fractions: liquid x = {x_l:.4f}, vapor y = {y_v:.4f}"
             f"; K_N2 = y/x = {k_n2:.1f} (gate > 1.5 and y > x)  "
             f"[{_common.pf(ok_k)}]", ok_k)
    rec.gate(f"coexistence pressure (dU/dV per box, production-averaged): "
             f"liquid {p_liq:.1f} +- {p_liq_sem:.1f} bar, vapor {p_vap:.1f} "
             f"+- {p_vap_sem:.1f} bar (gate: equal within 4 combined sem, "
             f"vapour in 2-60 bar; pure-CO2 expt P_sat(240 K) = 12.8)  "
             f"[{_common.pf(ok_p)}]", ok_p)
    rec.gate(f"per-species mu-equality (Widom, liq - vap): CO2 "
             f"{dmu[0]:+.3f} kT (bound 1.0), N2 {dmu[1]:+.3f} kT (bound "
             f"0.4)  [{_common.pf(ok_mu)}]", ok_mu)
    rec.gate(f"every block: S(k) error < 1e-3 (worst {worst_sfac:.1e}), "
             f"drift < 3e-2 (worst {worst_drift:.1e})  "
             f"[{_common.pf(ok_blocks)}]", ok_blocks)
    rec.gate("liquid-box Kirkwood-Buff integrals (site-site masked RDFs "
             "to r = 8 A; reported, not gated): " + ", ".join(
                 f"G_{k} = {kirkwood_buff_integral(*rdf.result()):.0f} A^3"
                 for k, rdf in rdfs.items()))
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
