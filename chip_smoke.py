"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  require CUDA; print the card's name and power limit.
Phase 1  build csrc/sweep_kernel.cu and csrc/delta_energy.cu with nvcc
         for sm_90a, both at once (cached by a hash of each source under
         metropolismontecarlo_tpu_torch/_build).
Phase 2  each kernel against its plain PyTorch version on the card, on the
         same inputs.  The sweep kernel, one sweep on shared uniforms:
         SPC/E-64 (ewald, wolf, none; p_translate 0.5 and 0.0), LJ-256,
         the linear-shift triatomic-256, a two-block CO2/N2 mixture
         (32 + 32) and a ragged mixture (16 SPC/E + 16 one-site CH4, where
         a block's first atom column differs from m_start * P).  The
         delta-energy kernel on CO2/N2 mixtures' proposals, for every
         Coulomb style, at 32 + 32 (A_pad 256, one lane per thread) and
         160 + 40 (A_pad 768, three lane passes per thread).
Phase 3  the flagship main path: 750 SPC/E waters, Ewald, 2048 chains
         through MonteCarlo.init_state and three run_blocks (one sweep
         kernel launch per sweep), the drift gate and sane acceptance
         checked; then the kernel against sweep_plain at this shape, and
         both timed.
Phase 4  the mixture main path: 600 CO2 + 150 N2 (TraPPE), Ewald, 37 A,
         2048 chains from a cubic lattice with every molecule along the
         cube diagonal, the whole-sweep route (two launches per sweep, one
         per species block) through three run_blocks; the same checks,
         the kernel against sweep_plain, one sweep of both timed.
Phase 5  the per-move route: the same mixture as one block of differing
         templates (species=None, which "auto" sends to the delta-energy
         kernel), from phase 4's end state: a 2-sweep run_block with M
         delta-energy launches per sweep and the drift gate; one sweep of
         this route against one whole-sweep-route sweep on the same
         uniforms; delta_energy against its plain version on the main
         path's arguments (2048 chains x 2304 lanes x 8 rows), and one
         launch and one plain call of it timed.

Tolerances.  Sweep kernel vs plain (and the per-move route vs the whole
sweep): at least 98% of chains take identical accept decisions, judged
by equal acc/att counts and an equal decision fingerprint (the sum of
accepted global move indices + 1): one f32-borderline decision makes a
chain diverge, so divergent chains are counted, not compared.  On the
other chains coordinates and COMs agree within 1e-3 A, the summed energy
delta within 1e-5 of the sweep's energy scale (sweep_plain's magnitude
column: the summed magnitudes of the terms the accepted moves' deltas
add up, which f32 rounds), and S(k) within 1e-4 of its norm.
Delta-energy kernel vs plain: the move's energy change (new rows - old
rows) within 1e-5 of the move's energy scale (the rows' |LJ| sums plus
their Coulomb term magnitudes), each row's e_coul within 1e-5 of its
term magnitudes (CUDA's erfcf against torch's erfc, f32), overlap counts
equal.  Every
phase raises on failure, so the script exits non-zero; the
line before the last lists every kernel with its launches on its main
path, error, time, plain time and bound; the last line of a passing run
is the device JSON.
"""

import concurrent.futures
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

MATCH_FRACTION = 0.98
POS_TOL = 1e-3
ENERGY_REL_TOL = 1e-5      # of the energy scale of a move or a sweep
SFAC_REL_TOL = 1e-4
DRIFT_TOL = 2e-3

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations counted per (site row, atom lane) pair, from the kernels'
# code: the minimum-image distance (3 sub, 3 x mul/rint/fma, 5 for d^2,
# floor, rsqrt, cutoff test) for every pair; the LJ term (1/d^2, s^2, s^6,
# s^12 - s^6, eps, accumulate) and the Coulomb term (r, kappa r, erfc as
# ~12, / r, q q, accumulate) for pairs inside the cutoff only
OPS_GEOMETRY, OPS_LJ, OPS_COULOMB = 20, 8, 17
# per k-vector and moved site: phase (6), range reduction (3), sincos
# (~8), the two accumulations; per k-vector and move: the energy cross
# term (8)
OPS_K_SITE, OPS_K_MOVE = 20, 8

SRC = "metropolismontecarlo_tpu_torch/csrc"
PALLAS = "metropolismontecarlo_tpu/ops/pallas"


def phase0():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"phase0 device: {name}")
    print(f"phase0 nvidia-smi: {smi}")
    print(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return name, smi


def phase1():
    from metropolismontecarlo_tpu_torch.ops.cuda import (
        build,
        delta_energy,
        sweep_kernel,
    )

    names = ("sweep_kernel", "delta_energy")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build.build, names))
    for name, (path, seconds, log) in zip(names, builds):
        print(f"phase1 built {path.name} in {seconds:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"phase1 ptxas {name}: {line.strip()}")
    sweep_kernel._library()
    delta_energy._library()


def _sweep_args(state, u):
    f32 = torch.float32
    return [x.to(f32).contiguous() for x in (
        state.coords, state.com, state.quat, state.sfac, state.box,
        state.temp, state.dr_max, state.dphi_max)] + [u]


def _check_match(tag, C, same, k, p, e_scale):
    """The shared tolerance test of two one-sweep results k and p, each
    (coords, com, sfac, stats (C, >= 1) with the energy delta first) on
    the chains `same` that took identical decisions; e_scale (C,) is the
    sweep's energy scale (sweep_plain's magnitude column)."""
    n_diff = int((~same).sum())
    if float(same.float().mean()) < MATCH_FRACTION:
        raise AssertionError(f"{tag}: {n_diff}/{C} chains took different "
                             f"decisions")
    pos = max(float((k[0] - p[0])[same].abs().max()),
              float((k[1] - p[1])[same].abs().max()))
    e_rel = float(((k[3][:, 0] - p[3][:, 0]).abs()
                   / e_scale.clamp_min(1.0))[same].max())
    s_norm = torch.clamp_min(torch.linalg.vector_norm(
        p[2].flatten(1), dim=1), 1e-30)
    s_rel = float(((k[2] - p[2]).flatten(1).abs().max(dim=1).values
                   / s_norm)[same].max())
    finite = all(bool(torch.isfinite(x).all()) for x in k)
    print(f"phase {tag}: chains {C}, differing {n_diff}, coord/com err "
          f"{pos:.3e} A, energy err {e_rel:.3e} of the sweep's energy "
          f"scale, S(k) rel err {s_rel:.3e}")
    if not (finite and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and s_rel <= SFAC_REL_TOL):
        raise AssertionError(f"{tag}: the two disagree")
    return pos


def compare(tag, mc, state, gen):
    """One sweep of the kernel and of sweep_plain on the same uniforms,
    one launch per species block; returns the largest coordinate
    difference on matched chains."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C, M = state.com.shape[:2]
    u = draw_uniforms(C, M, gen, state.com.device)
    args = _sweep_args(state, u)
    k = sweep_blocks(op.sweep, *args, mc.tables)
    p = sweep_blocks(functools.partial(op.sweep_plain, magnitude=True),
                     *args, mc.tables)
    torch.cuda.synchronize()
    same = (k[4][:, 1:] == p[4][:, 1:op.N_STATS]).all(dim=1)
    print(f"phase {tag}: acc/att {k[4][:, 1:5].sum(0).tolist()}")
    return _check_match(tag, C, same, (k[0], k[1], k[3], k[4]),
                        (p[0], p[1], p[3], p[4]), p[4][:, op.N_STATS])


def diagonal_quats(n_mol):
    """(n_mol, 4) quaternions turning the body z axis (the axis of the
    linear CO2 and N2 templates) onto the cube diagonal: on a simple-cubic
    lattice of 3.7 A no two neighbours' sites then come closer than ~3 A,
    where random orientations overlap (E/N ~ +4e4 K instead of -2.5e3 K
    for the phase 4 mixture)."""
    n = np.ones(3) / math.sqrt(3.0)
    axis = np.cross([0.0, 0.0, 1.0], n)
    axis /= np.linalg.norm(axis)
    half = 0.5 * math.acos(n[2])
    q = np.concatenate([[math.cos(half)], math.sin(half) * axis])
    return np.tile(q, (n_mol, 1))


def mixture_params(**kw):
    """The CO2/N2 runs' RunParams: 240 K, site cutoff 10 A, Ewald with
    kappa L = 5.6 and |k|^2 < 27."""
    from metropolismontecarlo_tpu_torch.models.system import RunParams

    return RunParams(**dict(dict(
        temperature=240.0, r_cut=10.0, cutoff_mode="site", coulomb="ewald",
        kappa_L=5.6, nk=5, ksq_max=27, p_translate=0.5, dr_max=0.3,
        dphi_max=0.3), **kw))


def check_delta(tag, args, P):
    """delta_energy against delta_energy_plain on the same arguments (a
    per-move body's delta_args for one move, P sites per molecule);
    returns the largest |d_e| difference (K)."""
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop
    from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

    k = dop.delta_energy(*args)
    p = dop.delta_energy_plain(*args)
    a = list(args)
    a[10], a[15] = args[10].abs(), args[15].abs()       # |q8|, |q_row|
    q_scale = dop.delta_energy_plain(*a)[1]
    torch.cuda.synchronize()
    err_q = float(((k[1] - p[1]).abs() / q_scale.clamp_min(1e-30)).max())
    sign = torch.zeros(k[0].shape[1], device=k[0].device)
    sign[:P], sign[P:2 * P] = -1.0, 1.0
    d_e = ((k[0] - p[0]) + COULOMB_FACTOR * (k[1] - p[1])) @ sign
    # the move's energy scale: its rows' LJ sums and Coulomb magnitudes
    mag = (p[0].abs() + COULOMB_FACTOR * q_scale).sum(1)
    err = float(d_e.abs().max())
    err_rel = float((d_e.abs() / mag.clamp_min(1.0)).max())
    n_ovr = int(k[2][:, P:2 * P].sum())
    print(f"phase {tag}: {args[0].shape[0]} chains x {args[0].shape[1]} "
          f"lanes: d_e abs err {err:.3e} K ({err_rel:.3e} of the move's "
          f"energy scale), e_coul rel err {err_q:.3e} (of the row's term "
          f"magnitudes), overlaps {n_ovr}")
    if not (err_rel <= ENERGY_REL_TOL and err_q <= ENERGY_REL_TOL
            and torch.equal(k[2], p[2])
            and all(bool(torch.isfinite(x).all()) for x in k)):
        raise AssertionError(f"{tag}: delta_energy and its plain version "
                             f"disagree")
    return err


def delta_compare(tag, body, state, gen, m):
    """check_delta on the move of molecule m proposed from `state`."""
    from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms

    C = state.com.shape[0]
    u = draw_uniforms(C, 1, gen, state.com.device)[:, 0]
    pr = body.propose(state.com, state.quat, state.coords, state.box, u,
                      state.dr_max, state.dphi_max, m)
    return check_delta(tag, body.delta_args(pr, state.coords, state.box, m),
                       body.P)


def phase2(dev, chains=2048):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import make_sweep_fn
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.models.monatomic import (
        lj_box_for_density,
        lj_system,
    )
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        mossa_params,
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import (
        spce_methane_system,
        spce_system,
    )

    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    box_lj = lj_box_for_density(256, 0.75)
    box_tri = (256 / 0.30533) ** (1 / 3)
    box_mix = 37.0 * (64 / 750) ** (1 / 3)     # phase 4's density
    cases = [(f"2 spce64 {c} pt={pt}", spce_system(64), box_w,
              RunParams(temperature=298.15, r_cut=6.0, coulomb=c,
                        p_translate=pt, dr_max=0.3, dphi_max=0.3))
             for c in ("ewald", "wolf", "none") for pt in (0.5, 0.0)]
    cases.append(("2 lj256", lj_system(256), box_lj,
                  RunParams(temperature=1.0, r_cut=2.5, coulomb="none",
                            p_translate=1.0, dr_max=box_lj / 30)))
    cases.append(("2 triatomic256 linear", triatomic_system(256), box_tri,
                  mossa_params()))
    cases.append(("2 co2/n2 32+32 two blocks", co2_n2_system(32, 32),
                  box_mix, mixture_params(r_cut=7.0)))
    cases.append(("2 spce16+ch4x16 ragged", spce_methane_system(16, 16),
                  12.0, RunParams(temperature=298.15, r_cut=5.5,
                                  coulomb="ewald", p_translate=0.5,
                                  dr_max=0.3, dphi_max=0.3)))
    err = 0.0
    for i, (tag, system, box, params) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        mc = MonteCarlo(system, params, device=dev, generator=gen,
                        kernel="sweep")
        state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                              n_chains=64)
        err = max(err, compare(tag, mc, state, gen))
    # the linear-shift variant runs on no main path: time one sweep of it
    # at the triatomic-256 shape with the main paths' 2048 chains
    tri = triatomic_system(256)
    gen = torch.Generator(device=dev).manual_seed(150)
    mc = MonteCarlo(tri, mossa_params(), device=dev, generator=gen)
    state = mc.init_state(cubic_lattice(256, box_tri), box=box_tri,
                          n_chains=chains)
    time_sweep("2 triatomic256 linear", mc, state, gen, tri)

    err_d = 0.0
    styles = {"ewald": {}, "wolf": dict(coulomb="wolf"),
              "wolf_ref": dict(coulomb="wolf", wolf_style="ref"),
              "bare": dict(coulomb="bare"), "none": dict(coulomb="none")}
    # A_pad 256 gives each of the kernel's 256 threads one lane; A_pad 768
    # gives each three passes of its lane loop
    for n_co2, n_n2 in ((32, 32), (160, 40)):
        M = n_co2 + n_n2
        mix = dataclasses.replace(co2_n2_system(n_co2, n_n2), species=None)
        box = 37.0 * (M / 750) ** (1 / 3)
        for i, (style, kw) in enumerate(styles.items()):
            params = mixture_params(r_cut=7.0, **kw)
            gen = torch.Generator(device=dev).manual_seed(200 + M + i)
            mc = MonteCarlo(mix, params, device=dev, generator=gen)
            state = mc.init_state(cubic_lattice(M, box), box=box,
                                  n_chains=64)
            body = make_sweep_fn(mix, params, mc.kvecs, mc.kweights, dev,
                                 use_kernel=True)
            for m in (0, M - 24):
                err_d = max(err_d, delta_compare(
                    f"2 delta_energy {style} M={M} m={m}", body, state, gen,
                    m))
    return err, err_d


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _cutoff_fraction(system, state, r_cut, n=4):
    """Share of the atom pairs of different molecules within r_cut, from
    the first n chains of `state` (what the bound counts potential terms
    for)."""
    A = system.n_atoms
    x = state.coords[:n, :, :A].transpose(1, 2)                   # (n, A, 3)
    box = state.box[:n, None, None, None]
    d = x[:, :, None, :] - x[:, None, :, :]
    d = d - box * torch.round(d / box)
    d2 = (d * d).sum(-1)
    mol = torch.as_tensor(system.atom_mol_slot[0], device=x.device)
    other = mol[:, None] != mol[None, :]
    return float((d2 < r_cut ** 2)[:, other].float().mean())


def sweep_bound(system, tables, state, frac):
    """The least time (ms) one sweep could take on this card, and what
    sets it: each input and output moved once against the operations the
    pair and k-space sums need (see OPS_*)."""
    C, M = state.com.shape[:2]
    A, A_pad, K = system.n_atoms, state.coords.shape[-1], state.sfac.shape[1]
    nbytes = 4 * C * (2 * 3 * A_pad + 2 * 7 * M + 2 * 2 * K + 10 * M + 10)
    ops = 0.0
    for t in tables:
        lj = t.has_lj.sum().item()
        qf = t.has_q.sum().item() if t.coulomb != "none" else 0
        per_move = 2 * (A - t.P) * (t.P * OPS_GEOMETRY + frac * (
            lj * OPS_LJ + qf * OPS_COULOMB))
        if t.coulomb == "ewald":
            per_move += K * (2 * t.P * OPS_K_SITE + OPS_K_MOVE)
        ops += C * t.M * per_move
    return _bound(nbytes, ops)


def delta_bound(args, P, frac):
    """The least time (ms) of one delta_energy launch: the planes, rows
    and outputs moved once against the pair operations of the live rows."""
    x, R = args[0], args[3].shape[1]
    C, A_pad = x.shape
    has_lj, has_q = args[11].sum().item(), args[12].sum().item()
    if args[16].coulomb == "none":
        has_q = 0
    nbytes = 4 * C * (3 * A_pad + 6 * R)
    rows = int(((args[11] != 0) | (args[12] != 0)).sum())
    ops = C * (int((args[14] >= 0).sum()) - P) * (
        rows * OPS_GEOMETRY + frac * (has_lj * OPS_LJ + has_q * OPS_COULOMB))
    return _bound(nbytes, ops)


def _bound(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def main_path(tag, mc, state, blocks, launches_per_sweep, counter):
    """run_blocks with the launch count, drift gate and acceptance
    checked; `counter` is the wrapper whose .launches counts the path's
    kernel.  Returns (state, launches)."""
    counter.launches = 0
    sweeps = 0
    for n_steps, adjust in blocks:
        t0 = time.perf_counter()
        state, m = mc.run_block(state, n_steps, adjust=adjust)
        torch.cuda.synchronize()
        sweeps += n_steps
        print(f"phase{tag} run_block({n_steps}, adjust={adjust}): "
              f"{time.perf_counter() - t0:.2f} s, " + ", ".join(
                  f"{k} {v:.6g}" for k, v in m.items()))
        if not m["drift_max_rel"] <= DRIFT_TOL:
            raise AssertionError(f"drift {m['drift_max_rel']} > {DRIFT_TOL}")
        if not all(math.isfinite(m[k]) for k in ("energy_mean", "energy_min",
                                                 "energy_max")):
            raise AssertionError(f"non-finite energies: {m}")
        if not adjust and not (0.05 < m["acc_trans"] < 0.95
                               and 0.05 < m["acc_rot"] < 0.95):
            raise AssertionError(f"acceptance out of range: {m}")
    launches = counter.launches
    if launches != launches_per_sweep * sweeps:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{sweeps} sweeps, {launches_per_sweep} each")
    if not bool(torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite chain energies")
    print(f"phase{tag} main path: {sweeps} sweeps, {launches} kernel "
          f"launches")
    return state, launches


def time_sweep(tag, mc, state, gen, system):
    """One sweep of the kernel (all blocks) and of sweep_plain, timed on
    the same uniforms, with the bound of the work."""
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C, M = state.com.shape[:2]
    u = draw_uniforms(C, M, gen, state.com.device)
    args = _sweep_args(state, u)
    sweep_blocks(op.sweep, *args, mc.tables)                    # warm
    ms = _time_ms(lambda: sweep_blocks(op.sweep, *args, mc.tables), 3)
    plain_ms = _time_ms(
        lambda: sweep_blocks(op.sweep_plain, *args, mc.tables), 1)
    frac = _cutoff_fraction(system, state, mc.params.r_cut)
    bound_ms, bound_by = sweep_bound(system, mc.tables, state, frac)
    print(f"phase{tag} one sweep of {C} chains x {M} moves "
          f"({len(mc.tables)} launches): kernel {ms:.3f} ms, sweep_plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{frac:.4f} of pairs within the cutoff)")
    return ms, plain_ms, bound_ms, bound_by


def phase3(dev, n_mol=750, box=28.24, chains=2048, r_cut=10.0,
           blocks=((10, True), (5, False), (5, False))):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(2026)
    system = spce_system(n_mol)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase3 init_state: {time.perf_counter() - t0:.2f} s, "
          f"K={mc.tables[0].kvec.shape[0]}, A_pad={state.coords.shape[-1]}, "
          f"E/N mean {float(state.energy.mean()) / n_mol:.2f} K")
    # the lattice start relaxes through E = 0 during the first sweeps; a
    # 10-sweep adjust block ends every chain far from zero energy, where
    # the relative drift gate is meaningful
    state, launches = main_path("3", mc, state, blocks, 1, op.sweep)
    err = compare("3 flagship kernel vs plain", mc, state, gen)
    return (launches, err) + time_sweep("3", mc, state, gen, system)


def phase4(dev, n_co2=600, n_n2=150, box=37.0, chains=2048, r_cut=10.0,
           blocks=((10, True), (5, False), (5, False))):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    system = co2_n2_system(n_co2, n_n2)
    params = mixture_params(r_cut=r_cut)
    gen = torch.Generator(device=dev).manual_seed(2027)
    mc = MonteCarlo(system, params, device=dev, generator=gen)
    if mc.route != "sweep" or len(mc.tables) != 2:
        raise AssertionError(f"mixture route {mc.route}, {len(mc.tables)} "
                             f"blocks")
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(system.n_mol, box),
                          quat=diagonal_quats(system.n_mol), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase4 init_state: {time.perf_counter() - t0:.2f} s, "
          f"M={system.n_mol}, A_pad={state.coords.shape[-1]}, "
          f"K={state.sfac.shape[1]}, blocks "
          f"{[(t.m_start, t.M, t.a_start, t.P) for t in mc.tables]}, "
          f"E/N mean {float(state.energy.mean()) / system.n_mol:.2f} K")
    state, launches = main_path("4", mc, state, blocks, 2, op.sweep)
    err = compare("4 mixture kernel vs plain", mc, state, gen)
    timing = time_sweep("4", mc, state, gen, system)
    return (launches, err) + timing + (mc, state)


def phase5(dev, mc4, state4, blocks=((2, False),)):
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import (
        draw_uniforms,
        sweep_blocks,
    )
    from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as dop
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    system = dataclasses.replace(mc4.system, species=None)
    gen = torch.Generator(device=dev).manual_seed(2028)
    mc = MonteCarlo(system, mc4.params, device=dev, generator=gen)
    if mc.route != "move":
        raise AssertionError(f"species=None mixture took route {mc.route}")
    M = system.n_mol
    state, launches = main_path("5", mc, state4, blocks, M, dop.delta_energy)

    # one sweep of each route on the same uniforms; sweep_plain gives the
    # sweep's energy scale
    C = state.com.shape[0]
    u = draw_uniforms(C, M, gen, state.com.device)
    args = _sweep_args(state, u)
    k = sweep_blocks(op.sweep, *args, mc4.tables)
    plain = functools.partial(op.sweep_plain, magnitude=True)
    e_scale = sweep_blocks(plain, *args, mc4.tables)[4][:, op.N_STATS]
    s = dataclasses.replace(state, com=state.com.clone(),
                            quat=state.quat.clone(),
                            coords=state.coords.clone())
    fp = torch.zeros(C, device=state.com.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m0, m1, body in mc.move_bodies:
        for m in range(m0, m1):
            s, accept = body(s, m, u[:, m])
            fp += accept.float() * (m + 1)
    torch.cuda.synchronize()
    move_sweep_s = time.perf_counter() - t0
    acc, att = (s.acc - state.acc).float(), (s.att - state.att).float()
    mv = torch.cat([acc[:, :2], att[:, :2], fp[:, None]], 1)
    same = (mv == k[4][:, 1:]).all(dim=1)
    print(f"phase5 per-move sweep: {move_sweep_s:.3f} s for {M} moves; "
          f"acc/att {mv[:, :4].sum(0).tolist()} vs whole sweep "
          f"{k[4][:, 1:5].sum(0).tolist()}")
    d_e = (s.energy - state.energy)[:, None]
    err = _check_match("5 per-move vs whole-sweep route", C, same,
                       (s.coords, s.com, s.sfac, d_e),
                       (k[0], k[1], k[3], k[4]), e_scale)

    # delta_energy against its plain version on the arguments the main
    # path gives it, then one launch and one plain call timed
    _, _, body = mc.move_bodies[0]
    m = M // 2
    pr = body.propose(state.com, state.quat, state.coords, state.box,
                      u[:, m], state.dr_max, state.dphi_max, m)
    args = body.delta_args(pr, state.coords, state.box, m)
    err_d = check_delta(f"5 delta_energy main path m={m}", args, body.P)
    ms = _time_ms(lambda: dop.delta_energy(*args), 20)
    plain_ms = _time_ms(lambda: dop.delta_energy_plain(*args), 3)
    frac = _cutoff_fraction(system, state, mc.params.r_cut)
    bound_ms, bound_by = delta_bound(args, body.P, frac)
    print(f"phase5 one delta_energy launch, {C} chains x "
          f"{args[0].shape[1]} lanes x {args[3].shape[1]} rows: kernel "
          f"{ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by})")
    return launches, err, err_d, ms, plain_ms, bound_ms, bound_by


def main():
    name, smi = phase0()
    t_start = time.perf_counter()
    phase1()
    dev = torch.device("cuda", 0)
    err2, err_d = phase2(dev)
    l3, err3, ms3, plain3, bound3, by3 = phase3(dev)
    l4, err4, ms4, plain4, bound4, by4, mc4, state4 = phase4(dev)
    l5, err5, err_d5, ms5, plain5, bound5, by5 = phase5(dev, mc4, state4)
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    sweep_src = f"{SRC}/sweep_kernel.cu"
    print(json.dumps({"kernels": [
        {"name": "sweep_kernel", "route": "cuda", "source": sweep_src,
         "replaces": f"{PALLAS}/sweep_kernel.py:903", "launches": l3,
         "max_abs_err": max(err2, err3), "ms": ms3, "plain_ms": plain3,
         "bound_ms": bound3, "bound_by": by3, "library_ms": None},
        {"name": "sweep_kernel[species blocks]", "route": "cuda",
         "source": sweep_src, "replaces": f"{PALLAS}/sweep_kernel.py:903",
         "launches": l4, "max_abs_err": max(err2, err4, err5), "ms": ms4,
         "plain_ms": plain4, "bound_ms": bound4, "bound_by": by4,
         "library_ms": None},
        {"name": "delta_energy", "route": "cuda",
         "source": f"{SRC}/delta_energy.cu",
         "replaces": f"{PALLAS}/delta_energy.py:159", "launches": l5,
         "max_abs_err": max(err_d, err_d5), "ms": ms5, "plain_ms": plain5,
         "bound_ms": bound5, "bound_by": by5, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
