"""In-kernel muVT exchanges (mega="full") on the card: the sampled
distribution.

The sweep kernel runs grand-canonical insertions and deletions inside the
launch (per-chain slot selection, Shoemake trial orientations, Philox
deletion scores keyed by (seed, chain0 + chain), log-space acceptance).
CPU tests hold its bookkeeping to the JAX interpreter on zero uniforms;
this gates what it samples:
  1.  the ideal rigid rotor (eps = q = 0): N ~ Poisson(zV), mean and
      variance / mean;
  1a. a per-chain activity ladder of three rungs in one run: each chain
      Poisson at its own zV;
  1b. two ideal species blocks (mc/gcmc_binary.py, one kernel call per
      block): independent Poissons;
  2.  SPC/E at run_gcmc_water.py's state point: <N> from the in-kernel
      sampler against the hybrid one (kernel sweeps + plain exchange
      steps, mega=True), and against the JAX package's muVT record there
      (<N> = 27.72, the JAX script's anchor);
  3.  blocks per second of both at that configuration.

    python3 docs/validation_torch/run_gcmc_kernel_exchange.py
        [--device cpu] [--scale 1.0] [--out FILE]

--scale multiplies every chain count, block count and block length
(1.0: the JAX script's protocol).  Writes
docs/validation_torch/gcmc_kernel_exchange.txt by default.
"""

import sys
import time

import numpy as np
import torch

import _common
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMC
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC, make_gcmc_mol
from metropolismontecarlo_tpu_torch.models.polyatomic import triatomic_system
from metropolismontecarlo_tpu_torch.models.system import RunParams, System
from metropolismontecarlo_tpu_torch.models.water import spce_system

F32 = torch.float32
# the absolute anchor of segment 2: the JAX package's two-ensemble muVT
# record at this state point (docs/validation/gcmc_water.txt, <N> = 27.72)
N_ANCHOR = 27.72


def n_samples(g, st, blocks, steps, drift_tol=2e-2, sfac_tol=1e-4):
    """Per-block chain-mean N samples; gates the tight invariant
    (carried structure factors) every block."""
    out = []
    for _ in range(blocks):
        st, stats = g.run_block(st, steps)
        if not stats["sfac_err_max"] < sfac_tol:
            raise AssertionError(stats)
        if not stats["drift_max_rel"] < drift_tol:
            raise AssertionError(stats)
        out.append(stats["n_mean"])
    return st, np.asarray(out)


def main(argv=None):
    ap = _common.parser(__doc__, "gcmc_kernel_exchange.txt")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev = _common.device_of(args, "run_gcmc_kernel_exchange")

    def sc(n, least=1):
        return max(least, int(round(n * args.scale)))

    rec = _common.Record(
        dev, "1: ideal rotor cap 64, box 8, z 0.039, "
        f"{sc(512)} chains x {sc(8, 2)} blocks of 10 cycles; 1a: z "
        f"0.02/0.04/0.06 x "
        f"{sc(384, 3) // 3} chains each; 1b: two ideal species cap 48 + "
        f"48, box 7, {sc(512)} chains x {sc(6, 2)} blocks; 2: SPC/E 1000 "
        f"K, box 20, z 2.5e-3, cap 96, {sc(256)} chains x {sc(16, 2)} "
        "blocks of 15 cycles after 20, mega=\"full\" vs mega=True; f32 "
        f"(scale {args.scale})")
    gen = lambda s: _common.generator(dev, s)           # noqa: E731

    # ---- 1. ideal rigid rotor: N ~ Poisson(zV) ----------------------------
    cap, box, z = 64, 8.0, 0.039     # zV = 19.97, capacity 6 sigma up
    zv = z * box**3
    params = RunParams(temperature=1.5, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=0.5, dr_max=1.0,
                       dphi_max=1.0, use_lrc=False, strict_min_image=False)
    g = MolGCMC(triatomic_system(cap, eps=0.0), params, activity=z,
                p_exchange=0.5, dtype=F32, mega="full", device=dev,
                generator=gen(3))
    st = g.init(box=box, n_init=10, n_chains=sc(512))
    apc = cap + max(1, round(cap * 0.5 / 0.5))
    steps = sc(10 * apc, apc)
    st, _ = g.run_block(st, steps)                           # equilibrate
    ns = []
    for _ in range(sc(8, 2)):
        st, stats = g.run_block(st, steps, drift_tol=1e-3)
        ns.append(st.active.sum(1).double().cpu().numpy())
    ns = np.concatenate(ns)
    mean, var = ns.mean(), ns.var()
    sem = ns.std() / np.sqrt(len(ns) / 4.0)   # ~4 correlated samples
    p1 = abs(mean - zv) < max(4.0 * sem, 0.3) and abs(var / mean - 1.0) < 0.1
    rec.gate(f"1. ideal rigid rotor, in-kernel exchanges: z V = {zv:.3f}, "
             f"<N> = {mean:.3f} +/- {sem:.3f}, var/mean = {var / mean:.4f} "
             f"(Poisson: 1)  [{_common.pf(p1)}]", p1)

    # ---- 1a. per-chain activity ladder through the kernel -----------------
    zs_l = np.array([0.02, 0.04, 0.06])
    C_l = sc(384, 3) // 3 * 3
    z_ladder = np.repeat(zs_l, C_l // 3)
    init_l, run_l, _ = make_gcmc_mol(
        triatomic_system(cap, eps=0.0), params, z_ladder, 0.5, F32,
        mega="full", device=dev, generator=gen(2))
    stl = init_l(box, 10, C_l)
    stl = run_l(stl, steps)
    nsl = []
    for _ in range(sc(8, 2)):
        stl = run_l(stl, steps)
        nsl.append(stl.active.sum(1).double().cpu().numpy())
    nsl = np.stack(nsl)
    p1a, lad = True, []
    for r, zr in enumerate(zs_l):
        sl = nsl[:, r * (C_l // 3):(r + 1) * (C_l // 3)].ravel()
        zv_r = zr * box**3
        sem_r = sl.std() / np.sqrt(len(sl) / 4.0)
        p1a &= abs(sl.mean() - zv_r) < max(4.0 * sem_r, 0.35)
        p1a &= abs(sl.var() / sl.mean() - 1.0) < 0.12
        lad.append(f"z={zr}: <N> {sl.mean():.3f} vs zV {zv_r:.3f} "
                   f"(var/mean {sl.var() / sl.mean():.4f})")
    rec.gate("1a. per-chain activity ladder (3 rungs, one run): "
             + "; ".join(lad) + f"  [{_common.pf(p1a)}]", p1a)

    # ---- 1b. binary ideal species: independent Poissons -------------------
    cap2, box2 = 48, 7.0
    z2 = (0.04, 0.02)
    M2 = 2 * cap2
    sysb = System(
        n_mol=M2, atoms_per_mol=1, body=np.zeros((M2, 1, 3)),
        masses=np.ones((M2, 1)), charges=np.zeros((M2, 1)),
        type_ids=np.concatenate([np.zeros((cap2, 1), np.int32),
                                 np.ones((cap2, 1), np.int32)]),
        eps_table=np.zeros((2, 2)), sig_table=np.ones((2, 2)),
        name="ideal2", species=(("A", cap2, 1), ("B", cap2, 1)))
    gb = BinaryGCMC(sysb, RunParams(
        temperature=1.5, r_cut=2.5, cutoff_mode="site", coulomb="none",
        p_translate=0.5, dr_max=1.0, use_lrc=False,
        strict_min_image=False), activities=z2, p_exchange=0.5,
        dtype=F32, mega="full", device=dev, generator=gen(5))
    stb = gb.init(box=box2, n_init=(8, 8), n_chains=sc(512))
    apc2 = M2 + 2 * max(1, round(M2 * 0.5 / 0.5 / 2))
    steps2 = sc(8 * apc2, apc2)
    stb, _ = gb.run_block(stb, steps2)
    n0s, n1s = [], []
    for _ in range(sc(6, 2)):
        stb, _ = gb.run_block(stb, steps2, drift_tol=1e-3)
        n0s.append(stb.active0.sum(1).double().cpu().numpy())
        n1s.append(stb.active1.sum(1).double().cpu().numpy())
    n0s, n1s = np.concatenate(n0s), np.concatenate(n1s)
    zv0, zv1 = z2[0] * box2**3, z2[1] * box2**3
    cov = np.mean((n0s - n0s.mean()) * (n1s - n1s.mean()))
    p1b = (abs(n0s.mean() - zv0) < 0.35 and abs(n1s.mean() - zv1) < 0.3
           and abs(n0s.var() / n0s.mean() - 1.0) < 0.1
           and abs(n1s.var() / n1s.mean() - 1.0) < 0.1
           and abs(cov) < 0.4)
    rec.gate(f"1b. binary ideal species (per-block in-kernel exchanges): "
             f"<N0> = {n0s.mean():.3f} (zV {zv0:.3f}), var/mean = "
             f"{n0s.var() / n0s.mean():.4f}; <N1> = {n1s.mean():.3f} (zV "
             f"{zv1:.3f}), var/mean = {n1s.var() / n1s.mean():.4f}; cov = "
             f"{cov:+.4f} (independent: 0)  [{_common.pf(p1b)}]", p1b)

    # ---- 2. SPC/E water: in-kernel vs hybrid exchanges --------------------
    T, box, z, cap = 1000.0, 20.0, 2.5e-3, 96
    params = RunParams(temperature=T, r_cut=10.0, cutoff_mode="site",
                       coulomb="ewald", p_translate=0.5, dr_max=0.6,
                       dphi_max=0.8, use_lrc=False, strict_min_image=False)
    apc = cap + max(1, round(cap * 0.4 / 0.6))
    res, traces = {}, []
    for name, mode in (("kernel", "full"), ("hybrid", True)):
        g = MolGCMC(spce_system(cap), params, activity=z, p_exchange=0.4,
                    dtype=F32, mega=mode, device=dev, generator=gen(7))
        st = g.init(box=box, n_init=24, n_chains=sc(256))
        st, _ = g.run_block(st, sc(20 * apc, apc))               # equilibrate
        t0 = time.perf_counter()
        st, trace = n_samples(g, st, blocks=sc(16, 2),
                              steps=sc(15 * apc, apc))
        dt = time.perf_counter() - t0
        sem = trace.std(ddof=1) / np.sqrt(len(trace))
        res[name] = (trace.mean(), sem, len(trace) / dt)
        traces.append(f"2. SPC/E {name} trace: "
                      + " ".join(f"{v:.2f}" for v in trace))
        rec.gate(f"2. SPC/E {name}: <N> = {trace.mean():.3f} +/- {sem:.3f} "
                 f"[{dt:.1f} s]")
    dn = res["kernel"][0] - res["hybrid"][0]
    tol = max(4.0 * np.hypot(res["kernel"][1], res["hybrid"][1]), 0.5)
    p2 = abs(dn) < tol
    p2b = abs(res["kernel"][0] - N_ANCHOR) < 1.5
    rec.gate(f"   kernel - hybrid = {dn:+.3f} (tol {tol:.3f}): "
             f"{_common.pf(p2)}", p2)
    rec.gate(f"   vs the JAX package's gcmc_water.txt <N> = {N_ANCHOR}: "
             f"{res['kernel'][0] - N_ANCHOR:+.3f} (tol 1.5): "
             f"{_common.pf(p2b)}", p2b)

    # ---- 3. throughput ------------------------------------------------------
    sk, sh = res["kernel"][2], res["hybrid"][2]
    rec.gate(f"3. throughput at the same configuration ({sc(256)} chains, "
             f"cap 96): in-kernel {sk:.2f} blocks/s vs hybrid {sh:.2f} "
             f"blocks/s = {sk / sh:.1f}x")
    for line in traces:
        rec.note(line)
    return rec.write(args.out)


if __name__ == "__main__":
    sys.exit(main())
