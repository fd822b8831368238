"""LJ vapour-liquid coexistence two ways on the card: TMMC against the
Gibbs ensemble.

Transition-matrix MC (mc/tmmc.py TMMC: ln Pi(N) from a biased one-box
muVT run, coexistence by equal basin weights) and the Gibbs ensemble
(mc/gibbs.py GibbsEnsemble: two boxes exchanging particles and volume)
share only the model (cut LJ, r_cut 2.5, no LRC, T = 1.0); their
coexistence densities must agree (finite-size differences aside: TMMC
at V = 216, Gibbs at a total V ~ 725).  Also reported: beta mu at
coexistence from ln z* against the Gibbs boxes' Widom averages.

    python3 docs/validation_torch/run_tmmc_coexistence.py [--device cpu]
        [--tm-chains 256] [--tm-blocks 48] [--tm-steps 5000]
        [--g-chains 64] [--g-equil 6] [--g-blocks 8] [--g-steps 10000]
        [--parts tmmc gibbs] [--partials DIR] [--out FILE]

--parts runs one side (saved to --partials); the process that finds both
there writes the record.  Writes docs/validation_torch/
tmmc_coexistence.txt by default.
"""

import sys
import time

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gibbs import GibbsEnsemble
from metropolismontecarlo_tpu_torch.mc.tmmc import TMMC, coexistence
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams

TEMP = 1.0
# --- TMMC side ---
BOX, CAP, Z0 = 6.0, 192, 0.03
TM_CHAINS, TM_BLOCKS, TM_STEPS = 256, 48, 5000
# --- Gibbs side (the configs/gibbs_lj.json state point) ---
G_BOX, G_INIT, G_CAP = 7.13, 108, 256
G_CHAINS, G_EQUIL, G_BLOCKS, G_STEPS = 64, 6, 8, 10000
PARTS = ("tmmc", "gibbs")


def run_tmmc(dev, chains, blocks, steps):
    params = RunParams(strict_min_image=False, temperature=TEMP, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.4,
                       dr_max=0.35, use_lrc=False)
    t = TMMC(lj_system(1), params, activity=Z0, capacity=CAP,
             dtype=torch.float32, device=dev,
             generator=_common.generator(dev, 0))
    # mid-range start: walkers diffuse toward both basins at once
    st = t.init(box=BOX, n_init=96, n_chains=chains)
    t0 = time.perf_counter()
    for b in range(blocks):
        st, stats = t.run_block(st, steps, drift_tol=1e-3)
        if b % 8 == 7:
            print(f"  tmmc block {b}: N [{stats['n_min']},{stats['n_max']}] "
                  f"visited {stats['visited_frac']:.2f} "
                  f"[{time.perf_counter() - t0:.0f} s]", flush=True)
    keys = ("z_coex", "rho_vap", "rho_liq", "dlnw")
    try:
        lnpi = t.lnpi()
        fin = np.where(np.isfinite(lnpi))[0]
        print(f"  tmmc ln Pi spans N = {fin[0]} .. {fin[-1]}", flush=True)
        res = coexistence(lnpi, Z0, BOX**3)
        return {k: float(res[k]) for k in keys}, stats, ""
    except ValueError as e:     # no transitions, or a single basin
        return {k: float("nan") for k in keys}, stats, str(e)


def run_gibbs(dev, chains, equil, blocks, steps):
    params = RunParams(strict_min_image=False, temperature=TEMP, r_cut=2.5,
                       cutoff_mode="site", coulomb="none", p_translate=0.6,
                       p_volume=0.02, dr_max=0.35, use_lrc=False)
    g = GibbsEnsemble(lj_system(1), params, capacity=G_CAP, dv_max=0.03,
                      dtype=torch.float32, device=dev,
                      generator=_common.generator(dev, 1))
    st = g.init(boxes=(G_BOX, G_BOX), n_init=(G_INIT, G_INIT),
                n_chains=chains)
    for _ in range(equil):
        st, _ = g.run_block(st, steps)
    # ratio-of-means densities (mean-of-ratios has a Jensen bias from
    # small-box volume fluctuations) over the liquid/vapour split
    n_l = n_v = v_l = v_v = 0.0
    w_l, w_v = [], []
    for b in range(blocks):
        st, stats = g.run_block(st, steps, drift_tol=1e-3)
        n = st.active.sum(2).double().cpu().numpy()           # (C, 2)
        v = st.box.double().cpu().numpy() ** 3
        liq = np.argmax(n / v, axis=1)     # which box is the liquid, per
        idx = np.arange(n.shape[0])        # chain (roles can swap)
        n_l += n[idx, liq].sum()
        v_l += v[idx, liq].sum()
        n_v += n[idx, 1 - liq].sum()
        v_v += v[idx, 1 - liq].sum()
        w = g.widom_boltzmann(st, 64).double().cpu().numpy()  # (C, 2)
        w_l.append(w[idx, liq])
        w_v.append(w[idx, 1 - liq])
    rho_l, rho_v = n_l / v_l, n_v / v_v
    w = np.asarray([np.mean(w_l), np.mean(w_v)])   # [liquid, vapour]
    return rho_v, rho_l, w, stats


def main(argv=None):
    ap = _common.parser(__doc__, "tmmc_coexistence.txt")
    ap.add_argument("--tm-chains", type=int, default=TM_CHAINS)
    ap.add_argument("--tm-blocks", type=int, default=TM_BLOCKS)
    ap.add_argument("--tm-steps", type=int, default=TM_STEPS)
    ap.add_argument("--g-chains", type=int, default=G_CHAINS)
    ap.add_argument("--g-equil", type=int, default=G_EQUIL)
    ap.add_argument("--g-blocks", type=int, default=G_BLOCKS)
    ap.add_argument("--g-steps", type=int, default=G_STEPS)
    _common.add_parts(ap, PARTS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_tmmc_coexistence")
    rec = _common.Record(
        dev, f"cut LJ r_cut=2.5, no shift, no LRC, T={TEMP}; TMMC box={BOX} "
        f"cap={CAP} z0={Z0}, {args.tm_chains} walkers x "
        f"{args.tm_blocks}x{args.tm_steps} steps, bias refreshed per block; "
        f"Gibbs boxes {G_BOX}^3 x2, N={2 * G_INIT}, {args.g_chains} chains x "
        f"{args.g_blocks}x{args.g_steps} steps after {args.g_equil} equil "
        "blocks; plain routes, f32")
    def run(part):
        if part == "tmmc":
            res, stats, err = run_tmmc(dev, args.tm_chains, args.tm_blocks,
                                       args.tm_steps)
            return dict(res, visited=stats["visited_frac"], error=err)
        rho_v, rho_l, w, _ = run_gibbs(dev, args.g_chains, args.g_equil,
                                       args.g_blocks, args.g_steps)
        return dict(rho_v=rho_v, rho_l=rho_l, w=w)

    parts = _common.run_parts(args, PARTS, run)
    if parts is None:
        return 0
    res, g = parts["tmmc"], parts["gibbs"]
    err, t_tm, t_g = str(res["error"]), float(res["wall"]), float(g["wall"])
    rho_v_g, rho_l_g, wid = float(g["rho_v"]), float(g["rho_l"]), g["w"]
    # beta mu = ln(rho_box) - ln <exp(-beta dU)>_box (reduced units,
    # Lambda = 1 so z = exp(beta mu))
    bmu_tm = float(np.log(res["z_coex"]))
    bmu_g_liq = float(np.log(rho_l_g) - np.log(wid[0]))
    bmu_g_vap = float(np.log(rho_v_g) - np.log(wid[1]))
    d_v = abs(res["rho_vap"] - rho_v_g)
    d_l = abs(res["rho_liq"] - rho_l_g)
    if err:
        rec.gate(f"TMMC coexistence: {err}", False)
    rec.gate(f"TMMC: visited {float(res['visited']):.2f} of N-range "
             f"(bound 0.8), {t_tm:.0f} s; Gibbs {t_g:.0f} s",
             res["visited"] > 0.8)
    rec.gate(f"rho_vap: TMMC {res['rho_vap']:.4f} vs Gibbs {rho_v_g:.4f} "
             f"(|d| {d_v:.4f} < 0.02)", d_v < 0.02)
    rec.gate(f"rho_liq: TMMC {res['rho_liq']:.4f} vs Gibbs {rho_l_g:.4f} "
             f"(|d| {d_l:.4f} < 0.05)", d_l < 0.05)
    rec.gate(f"beta*mu at coexistence: TMMC ln z* = {bmu_tm:.3f} vs Gibbs "
             f"Widom (vapor box) {bmu_g_vap:.3f}, (liquid box) "
             f"{bmu_g_liq:.3f} (vapor-box bound 0.25)",
             abs(bmu_tm - bmu_g_vap) < 0.25)
    rec.gate(f"TMMC z* = {res['z_coex']:.5f}, equal-weight residual "
             f"{res['dlnw']:.1e}")
    return rec.write(args.out, parts)


if __name__ == "__main__":
    sys.exit(main())
