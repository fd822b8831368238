"""In-kernel Gibbs transfers (mega="full", csrc/gibbs_kernel.cu) on the
card: the sampled distribution, the Gibbs-ensemble analogue of
gcmc_kernel_exchange.txt.

The kernel's transfer path (per-chain direction pick, slot selection,
Shoemake poses, log-space acceptance) is held against closed forms with
no reference implementation in the loop:

[0] ideal single-species Gibbs (eps = 0, q = 0, fixed volumes): dU = 0,
    so each molecule independently occupies box 0 with p = V0/(V0+V1):
    N_box0 ~ Binomial(N_tot, p), mean and variance (Frenkel & Smit ch. 8).
[1] ideal binary Gibbs (mc/gibbs_binary.py, one kernel launch per
    species block): each species partitions as an independent Binomial,
    and corr(N_A,box0, N_B,box0) vanishes.
[2] SPC/E water at 500 K: <N_liq-box> through mega="full" against the
    hybrid route (kernel sweeps + plain Rosenbluth transfers, n_orient
    1) at the same state point, within combined errors; the block-end
    drift and S(k) invariants.

    python3 docs/validation_torch/run_gibbs_kernel_exchange.py
        [--device cpu] [--scale 1.0] [--samples 4] [--blocks 3]
        [--parts 0 1 2] [--partials DIR] [--out FILE]

--scale multiplies every chain count and step count (1.0: the JAX
script's protocol); --parts runs some segments (saved to --partials), the
process that finds all three there writes the record.  Writes
docs/validation_torch/gibbs_kernel_exchange.txt by default.
"""

import dataclasses
import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
    BinaryGibbsEnsemble,
)
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams, System
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

F32 = torch.float32
MEGA_FULL = "full"
MEGA_HYB = True
STEPS_EQ = 3000
CHUNK = 256          # chains per step of segment [2]'s plain transfers
SEGMENTS = ("0", "1", "2")
IDEAL_PARAMS = dict(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                    coulomb="none", p_translate=1.0, dr_max=0.5,
                    p_volume=0.0, use_lrc=False, strict_min_image=False)


def zgate(name, measured, sem, exact, tol_sig=4.0):
    """(line, ok): |measured - exact| within tol_sig standard errors."""
    z = abs(measured - exact) / max(sem, 1e-12)
    ok = z < tol_sig
    return (f"    {name}: {measured:.4f} +- {sem:.4f} vs exact "
            f"{exact:.4f}  (z = {z:.2f} < {tol_sig})  [{_common.pf(ok)}]",
            ok)


def seg_ideal_single(dev, sc, samples):
    cap, n_tot = 96, 64
    b0, b1 = 8.0, 11.0
    g = MolGibbsEnsemble(lj_system(cap, eps=0.0), RunParams(**IDEAL_PARAMS),
                         p_transfer=0.5, dtype=F32, mega=MEGA_FULL,
                         device=dev, generator=_common.generator(dev, 1))
    chains = sc(2048)
    st = g.init(boxes=(b0, b1), n_init=(n_tot // 2, n_tot - n_tot // 2),
                n_chains=chains)
    st = g.run_steps(st, sc(STEPS_EQ))                 # equilibrate
    n0 = []
    for _ in range(samples):
        st = g.run_steps(st, sc(800))
        n0.append(st.active[:, 0].sum(1).double().cpu().numpy())
    conserved = bool((st.active.sum((1, 2)) == n_tot).all())
    return dict(n0=np.concatenate(n0), conserved=conserved,
                chains=chains)


def ideal2_system(caps):
    """Two ideal one-site species (eps = 0, q = 0) in blocks of caps."""
    M = caps[0] + caps[1]
    return System(n_mol=M, atoms_per_mol=1, body=np.zeros((M, 1, 3)),
                  masses=np.ones((M, 1)), charges=np.zeros((M, 1)),
                  type_ids=np.zeros((M, 1), np.int32),
                  eps_table=np.zeros((1, 1)), sig_table=np.ones((1, 1)),
                  name="ideal2",
                  species=(("a", caps[0], 1), ("b", caps[1], 1)))


def seg_ideal_binary(dev, sc, samples):
    caps, n_tots = (64, 64), (40, 28)
    b0, b1 = 8.0, 11.0
    g = BinaryGibbsEnsemble(ideal2_system(caps), RunParams(**IDEAL_PARAMS),
                            p_transfer=0.5, dtype=F32, mega=MEGA_FULL,
                            device=dev, generator=_common.generator(dev, 2))
    st = g.init(boxes=(b0, b1),
                n_init=np.array([[n_tots[0] // 2, n_tots[0] - n_tots[0] // 2],
                                 [n_tots[1] // 2,
                                  n_tots[1] - n_tots[1] // 2]]),
                n_chains=sc(2048))
    st = g.run_steps(st, sc(STEPS_EQ))
    s0, s1 = [], []
    for _ in range(samples):
        st = g.run_steps(st, sc(800))
        s0.append(st.active0[:, 0].sum(1).double().cpu().numpy())
        s1.append(st.active1[:, 0].sum(1).double().cpu().numpy())
    conserved = bool((st.active0.sum((1, 2)) == n_tots[0]).all()
                     and (st.active1.sum((1, 2)) == n_tots[1]).all())
    return dict(n0=np.concatenate(s0), n1=np.concatenate(s1),
                conserved=conserved)


def seg_water_cross(dev, sc, blocks):
    cap = 48
    b_l, b_v = 12.0, 16.0
    r_cut = 5.0
    kl, nk, ksq = tune_parameters(16.5, r_cut, 1e-3)
    params = RunParams(temperature=500.0, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       p_translate=0.5, dr_max=0.35, dphi_max=0.5,
                       p_volume=0.0, use_lrc=False, strict_min_image=False)
    out = {}
    for label, mega in (("full", MEGA_FULL), ("hybrid", MEGA_HYB)):
        chains = sc(256)
        g = MolGibbsEnsemble(spce_system(cap), params, p_transfer=0.3,
                             dtype=F32, n_orient=1, chunk=min(CHUNK, chains),
                             mega=mega, device=dev,
                             generator=_common.generator(dev, 7))
        st = g.init(boxes=(b_l, b_v), n_init=(30, 8), n_chains=chains)
        st = g.run_steps(st, sc(4000))
        # the block-end resync of MolGibbsEnsemble.run_block: the f32
        # carried-energy residue scales with the exchange traversal, so
        # the per-block residue is gated (and the tight S(k) invariant)
        drift = sferr = 0.0
        samples = []
        for _ in range(blocks):
            st = g.run_steps(st, sc(1200))
            e_fresh, sf = g.full_energy(st)
            scale = e_fresh.abs().clamp_min(1.0)
            drift = max(drift, float(((e_fresh - st.energy).abs()
                                      / scale).max()))
            sferr = max(sferr, float((sf - st.sfac).abs().max()))
            st = dataclasses.replace(st, energy=e_fresh, sfac=sf)
            samples.append(st.active.sum(2).max(1).values.double()
                           .cpu().numpy())
        nl = np.concatenate(samples)
        out[f"{label}_nl"] = nl
        out[f"{label}_drift"] = drift
        out[f"{label}_sfac"] = sferr
    return out


RUNS = {"0": seg_ideal_single, "1": seg_ideal_binary, "2": seg_water_cross}


def main(argv=None):
    ap = _common.parser(__doc__, "gibbs_kernel_exchange.txt")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--samples", type=int, default=4,
                    help="N samples per chain in [0] and [1]")
    ap.add_argument("--blocks", type=int, default=3,
                    help="resync blocks per route in [2]")
    _common.add_parts(ap, SEGMENTS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gibbs_kernel_exchange")

    def sc(n, least=1):
        return max(least, int(round(n * args.scale)))

    rec = _common.Record(
        dev, f"[0] ideal LJ (eps 0) cap 96, 64 molecules, boxes 8 / 11, "
        f"{sc(2048)} chains, {sc(STEPS_EQ)} + {args.samples} x {sc(800)} "
        f"steps; [1] two "
        f"ideal species caps 64 + 64, totals 40 / 28, same boxes and depth; "
        f"[2] SPC/E 500 K cap 48, boxes 12 / 16, r_cut 5, tuned Ewald, "
        f"{sc(256)} chains, {sc(4000)} + {args.blocks} x {sc(1200)} steps, "
        f"mega='full' "
        f"vs hybrid (n_orient 1); f32, p_volume 0 (scale {args.scale})")
    res = _common.run_parts(args, SEGMENTS, lambda part: RUNS[part](
        dev, sc, args.blocks if part == "2" else args.samples))
    if res is None:
        return 0
    b0, b1 = 8.0, 11.0
    p0 = b0 ** 3 / (b0 ** 3 + b1 ** 3)

    rec.gate("[0] ideal single-species Gibbs: Binomial partition")
    n0 = res["0"]["n0"]
    n_tot, n_eff = 64, len(n0)
    for line, ok in (
            zgate("<N_box0>", n0.mean(), n0.std() / np.sqrt(n_eff),
                  n_tot * p0),
            zgate("Var[N_box0]", n0.var(), n0.var() * np.sqrt(2.0 / n_eff),
                  n_tot * p0 * (1 - p0))):
        rec.gate(line, ok)
    ok = bool(res["0"]["conserved"])
    rec.gate(f"    N conserved across {int(res['0']['chains'])} chains  "
             f"[{_common.pf(ok)}]", ok)

    rec.gate("[1] ideal binary Gibbs: independent per-species Binomials")
    n0, n1 = res["1"]["n0"], res["1"]["n1"]
    n_eff = len(n0)
    n_tots = (40, 28)
    for line, ok in (
            zgate("<N_A,box0>", n0.mean(), n0.std() / np.sqrt(n_eff),
                  n_tots[0] * p0),
            zgate("<N_B,box0>", n1.mean(), n1.std() / np.sqrt(n_eff),
                  n_tots[1] * p0),
            zgate("Var[N_A,box0]", n0.var(), n0.var() * np.sqrt(2.0 / n_eff),
                  n_tots[0] * p0 * (1 - p0))):
        rec.gate(line, ok)
    corr = float(np.corrcoef(n0, n1)[0, 1]) if n0.std() * n1.std() > 0 \
        else float("nan")
    ok_c = abs(corr) < 4.0 / np.sqrt(n_eff)
    rec.gate(f"    corr(N_A, N_B) = {corr:+.4f} (|corr| < "
             f"{4.0 / np.sqrt(n_eff):.4f})  [{_common.pf(ok_c)}]", ok_c)
    ok = bool(res["1"]["conserved"])
    rec.gate(f"    both species' totals conserved  [{_common.pf(ok)}]", ok)

    rec.gate("[2] SPC/E water 500 K: mega='full' vs hybrid <N_liq>")
    w, stats = res["2"], {}
    for label in ("full", "hybrid"):
        nl = w[f"{label}_nl"]
        stats[label] = (nl.mean(), nl.std() / np.sqrt(len(nl)))
        drift, sferr = float(w[f"{label}_drift"]), float(w[f"{label}_sfac"])
        ok = sferr < 1e-3 and drift < 2e-2
        rec.gate(f"    {label}: <N_liq> = {nl.mean():.3f} +- "
                 f"{stats[label][1]:.3f}, worst block drift {drift:.1e} "
                 f"(bound 2e-2), sfac {sferr:.1e} (bound 1e-3)  "
                 f"[{_common.pf(ok)}]", ok)
    (mf, sf_), (mh, sh) = stats["full"], stats["hybrid"]
    gap = abs(mf - mh)
    tol = 4.0 * np.hypot(sf_, sh) + 0.02 * mh
    rec.gate(f"    |gap| = {gap:.3f} < {tol:.3f}  [{_common.pf(gap < tol)}]",
             gap < tol)
    return rec.write(args.out, res)


if __name__ == "__main__":
    sys.exit(main())
