"""LJ tail corrections in muVT exchange acceptance: the exact-reweight
gate on the card, plain route and in-kernel exchanges (mega="full").

U_lrc = g N^2 is configuration-independent at fixed N, so the
tail-corrected muVT distribution is an exact reweighting of the
uncorrected one, P_lrc(N) = P_off(N) exp(-beta g N^2) / Z.  Monatomic LJ
with sigma near r_cut (a large tail): (1) the plain route with use_lrc
off gives the N-histogram and the reweighted prediction; (2) the plain
route with use_lrc on and (3) the sweep kernel's in-kernel exchanges
(mega="full", the tail on the kernel's quadratic wc lane) must both
match it, inside 4-sigma bands, with the shift itself resolved.  The
carried-vs-recomputed energy of every chain is gated every block.

    python3 docs/validation_torch/run_gcmc_lrc.py [--device cpu]
        [--chains 1024] [--blocks 8] [--steps 1500] [--equil 2500]
        [--out FILE]

Writes docs/validation_torch/gcmc_lrc.txt by default.
"""

import dataclasses
import sys

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gcmc import (
    GCMC,
    make_slot_lj,
    n_counts,
)
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams

BOX, CAP, Z, T = 12.0, 64, 0.004, 1.5
CHAINS = 1024
BLOCKS = 8
STEPS = 1500
EQUIL_STEPS = 2500


def params(use_lrc):
    return RunParams(strict_min_image=False, temperature=T, r_cut=2.5,
                     cutoff_mode="site", coulomb="none", lj_shift="none",
                     use_lrc=use_lrc, p_translate=0.4, dr_max=1.0)


def soft_system():
    return dataclasses.replace(lj_system(1), eps_table=np.full((1, 1), 0.5),
                               sig_table=np.full((1, 1), 2.2))


def run(use_lrc, mega, seed, dev, chains, blocks, steps, equil):
    """(hist, q98 drift, max drift): run_steps, not run_block, so the
    carried energy is compared with the recompute before the resync."""
    g = GCMC(soft_system(), params(use_lrc), activity=Z, capacity=CAP,
             dtype=torch.float32, mega=mega, device=dev,
             generator=_common.generator(dev, seed))
    st = g.init(box=BOX, n_init=8, n_chains=chains)
    st, _ = g.run_block(st, equil)
    hist = np.zeros(CAP + 1)
    q98 = wmax = 0.0
    for _ in range(blocks):
        st = g.run_steps(st, steps)
        e_t = g.full_energy(st)
        e = e_t.double().cpu().numpy()
        carried = st.energy.double().cpu().numpy()
        rel = np.abs(e - carried) / np.maximum(np.abs(e), 1.0)
        q98 = max(q98, float(np.quantile(rel, 0.98)))
        wmax = max(wmax, float(rel.max()))
        st = dataclasses.replace(st, energy=e_t)
        hist += n_counts(st, CAP)
    return hist, q98, wmax


def moments(hist):
    n = np.arange(len(hist))
    w = hist / hist.sum()
    m = float((n * w).sum())
    v = float((n * n * w).sum() - m * m)
    return m, v


def main(argv=None):
    ap = _common.parser(__doc__, "gcmc_lrc.txt")
    ap.add_argument("--chains", type=int, default=CHAINS)
    ap.add_argument("--blocks", type=int, default=BLOCKS)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--equil", type=int, default=EQUIL_STEPS)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gcmc_lrc")
    depth = (dev, args.chains, args.blocks, args.steps, args.equil)
    g_val = float(make_slot_lj(soft_system(), params(True), CAP,
                               torch.float64, "cpu")[3](BOX))
    rec = _common.Record(
        dev, f"{args.chains} chains, cap {CAP}, box {BOX}, z {Z}, T {T}; "
        f"soft-sphere sigma 2.2 / r_cut 2.5, g(box) = {g_val:.5f}; "
        f"{args.equil} equil + {args.blocks} x {args.steps} steps per leg: "
        "plain off, plain on, in-kernel (mega=\"full\") on, f32")
    h_off, q_off, w_off = run(False, None, 0, *depth)
    h_pln, q_pln, w_pln = run(True, None, 1, *depth)
    h_krn, q_krn, w_krn = run(True, "full", 2, *depth)

    n = np.arange(CAP + 1)
    logw = -(1.0 / T) * g_val * n.astype(np.float64) ** 2
    logw -= logw[h_off > 0].max()
    wts = np.where(h_off > 0, h_off * np.exp(logw), 0.0)
    mean_pred = float((n * wts).sum() / wts.sum())
    var_pred = float((n * n * wts).sum() / wts.sum() - mean_pred**2)

    m_off, v_off = moments(h_off)
    m_pln, v_pln = moments(h_pln)
    m_krn, v_krn = moments(h_krn)
    # ~CHAINS correlated samples per block x BLOCKS; effective ~2000
    se = float(np.sqrt(var_pred / 2000.0))
    tol = 4.0 * se + 0.05
    shift = mean_pred - m_off
    rec.gate(f"LRC-off <N> = {m_off:.3f} (var {v_off:.2f}); exact reweight "
             f"prediction for LRC-on: <N> = {mean_pred:.3f} (var "
             f"{var_pred:.2f}), tail shift = +{shift:.3f} (bound > 0.8)",
             shift > 0.8)
    for name, m, v in (("plain LRC-on ", m_pln, v_pln),
                       ("KERNEL LRC-on", m_krn, v_krn)):
        ok_m = abs(m - mean_pred) < tol
        ok_v = abs(v - var_pred) < 0.35 * var_pred + 0.5
        rec.gate(f"{name} <N> = {m:.3f} (var {v:.2f})  [tol {tol:.3f}; var "
                 f"tol {0.35 * var_pred + 0.5:.2f}]  [{_common.pf(ok_m)}]",
                 ok_m and ok_v)
    rec.gate(f"drift q98 (gated < 1e-4 plain / 2e-3 kernel): off "
             f"{q_off:.1e}, plain-on {q_pln:.1e}, kernel-on {q_krn:.1e}; max "
             f"(same gates): off {w_off:.1e}, plain-on {w_pln:.1e}, "
             f"kernel-on {w_krn:.1e}",
             q_off < 1e-4 and q_pln < 1e-4 and q_krn < 2e-3
             and w_off < 1e-4 and w_pln < 1e-4 and w_krn < 2e-3)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
