"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  require CUDA; print the card's name and power limit.
Phase 1  build csrc/sweep_kernel.cu with nvcc for sm_90a (cached by a
         hash of the source under metropolismontecarlo_tpu_torch/_build).
Phase 2  the sweep kernel against its plain PyTorch version on the card,
         same uniforms, one sweep: SPC/E-64 (ewald, wolf, none; p_translate
         0.5 and 0.0), LJ-256 and the linear-shift triatomic-256.
Phase 3  the main path: 750 SPC/E waters, Ewald, 2048 chains through
         MonteCarlo.init_state and three run_blocks, with the kernel's
         launch count, the drift gate and sane acceptance checked; then
         the kernel against sweep_plain at this shape, and both timed.

Tolerances of the kernel-vs-plain comparison: at least 98% of chains
take identical accept decisions, judged by equal acc/att counts and an
equal decision fingerprint (the sum of accepted move indices): one
f32-borderline decision makes a chain diverge, so divergent chains are
counted, not compared.  On the other chains coordinates and COMs agree
within 1e-3 A, the summed energy delta within 1e-4 of the larger of the
chain's energies before and after the sweep, and S(k) within 1e-4 of
its norm.  Every phase raises on failure, so the script exits non-zero;
the last line of a passing run is the device JSON.
"""

import json
import math
import subprocess
import sys
import time

import torch

MATCH_FRACTION = 0.98
POS_TOL = 1e-3
ENERGY_REL_TOL = 1e-4
SFAC_REL_TOL = 1e-4
DRIFT_TOL = 2e-3


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
    from metropolismontecarlo_tpu_torch.ops.cuda import build, sweep_kernel

    path, seconds, log = build.build("sweep_kernel")
    print(f"phase1 built {path.name} in {seconds:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"phase1 ptxas: {line.strip()}")
    sweep_kernel._library()


def _sweep_args(state, u):
    f32 = torch.float32
    return [x.to(f32).contiguous() for x in (
        state.coords, state.com, state.quat, state.sfac, state.box,
        state.temp, state.dr_max, state.dphi_max)] + [u]


def compare(tag, mc, state, gen):
    """One sweep of the kernel and of sweep_plain on the same uniforms;
    returns the largest coordinate difference on matched chains."""
    from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    C = state.com.shape[0]
    u = draw_uniforms(C, mc.tables.M, gen, state.com.device)
    args = _sweep_args(state, u)
    k = op.sweep(*args, mc.tables)
    p = op.sweep_plain(*args, mc.tables)
    torch.cuda.synchronize()
    same = (k[4][:, 1:] == p[4][:, 1:]).all(dim=1)
    n_diff = int((~same).sum())
    if float(same.float().mean()) < MATCH_FRACTION:
        raise AssertionError(f"{tag}: {n_diff}/{C} chains took different "
                             f"decisions")
    pos = max(float((k[0] - p[0])[same].abs().max()),
              float((k[1] - p[1])[same].abs().max()))
    e_scale = torch.clamp_min(torch.maximum(
        state.energy.abs(), (state.energy + p[4][:, 0]).abs()), 1.0)
    e_rel = float(((k[4][:, 0] - p[4][:, 0]).abs() / e_scale)[same].max())
    s_norm = torch.clamp_min(torch.linalg.vector_norm(
        p[3].flatten(1), dim=1), 1e-30)
    s_rel = float(((k[3] - p[3]).flatten(1).abs().max(dim=1).values
                   / s_norm)[same].max())
    finite = all(bool(torch.isfinite(x).all()) for x in k)
    print(f"phase {tag}: chains {C}, differing {n_diff}, coord/com err "
          f"{pos:.3e} A, energy rel err {e_rel:.3e}, S(k) rel err "
          f"{s_rel:.3e}, acc/att {k[4][:, 1:5].sum(0).tolist()}")
    if not (finite and pos <= POS_TOL and e_rel <= ENERGY_REL_TOL
            and s_rel <= SFAC_REL_TOL):
        raise AssertionError(f"{tag}: kernel and sweep_plain disagree")
    return pos


def phase2(dev):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.monatomic import (
        lj_box_for_density,
        lj_system,
    )
    from metropolismontecarlo_tpu_torch.models.polyatomic import (
        mossa_params,
        triatomic_system,
    )
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    box_w = 28.24 * (64 / 750) ** (1 / 3)      # the flagship's density
    box_lj = lj_box_for_density(256, 0.75)
    box_tri = (256 / 0.30533) ** (1 / 3)
    cases = [(f"2 spce64 {c} pt={pt}", spce_system(64), box_w,
              RunParams(temperature=298.15, r_cut=6.0, coulomb=c,
                        p_translate=pt, dr_max=0.3, dphi_max=0.3))
             for c in ("ewald", "wolf", "none") for pt in (0.5, 0.0)]
    cases.append(("2 lj256", lj_system(256), box_lj,
                  RunParams(temperature=1.0, r_cut=2.5, coulomb="none",
                            p_translate=1.0, dr_max=box_lj / 30)))
    cases.append(("2 triatomic256 linear", triatomic_system(256), box_tri,
                  mossa_params()))
    err = 0.0
    for i, (tag, system, box, params) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        mc = MonteCarlo(system, params, device=dev, generator=gen)
        state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                              n_chains=64)
        err = max(err, compare(tag, mc, state, gen))
    return err


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase3(dev, n_mol=750, box=28.24, chains=2048, r_cut=10.0):
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.mc.moves import draw_uniforms
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as op

    params = RunParams(temperature=298.15, r_cut=r_cut, coulomb="ewald",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator(device=dev).manual_seed(2026)
    mc = MonteCarlo(spce_system(n_mol), params, device=dev, generator=gen)
    t0 = time.perf_counter()
    state = mc.init_state(cubic_lattice(n_mol, box), box=box,
                          n_chains=chains)
    torch.cuda.synchronize()
    print(f"phase3 init_state: {time.perf_counter() - t0:.2f} s, "
          f"K={mc.tables.kvec.shape[0]}, A_pad={state.coords.shape[-1]}, "
          f"E/N mean {float(state.energy.mean()) / n_mol:.2f} K")

    op.sweep.launches = 0
    sweeps = 0
    # the lattice start relaxes through E = 0 during the first sweeps; a
    # 10-sweep adjust block ends every chain far from zero energy, where
    # the relative drift gate is meaningful
    blocks = [(10, True), (5, False), (5, False)]
    for n_steps, adjust in blocks:
        t0 = time.perf_counter()
        state, m = mc.run_block(state, n_steps, adjust=adjust)
        torch.cuda.synchronize()
        sweeps += n_steps
        print(f"phase3 run_block({n_steps}, adjust={adjust}): "
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
    launches = op.sweep.launches
    if launches != sweeps:
        raise AssertionError(f"sweep kernel launched {launches} times for "
                             f"{sweeps} sweeps")
    if not bool(torch.isfinite(state.energy).all()):
        raise AssertionError("non-finite chain energies")
    print(f"phase3 main path: {sweeps} sweeps, {launches} kernel launches")

    err = compare("3 flagship kernel vs plain", mc, state, gen)
    u = draw_uniforms(chains, n_mol, gen, state.com.device)
    args = _sweep_args(state, u)
    op.sweep(*args, mc.tables)                        # warm
    ms = _time_ms(lambda: op.sweep(*args, mc.tables), 3)
    plain_ms = _time_ms(lambda: op.sweep_plain(*args, mc.tables), 1)
    print(f"phase3 one sweep of {chains} chains x {n_mol} moves: kernel "
          f"{ms:.3f} ms, sweep_plain {plain_ms:.3f} ms")
    return launches, err, ms, plain_ms


def main():
    name, smi = phase0()
    phase1()
    dev = torch.device("cuda", 0)
    err2 = phase2(dev)
    launches, err3, ms, plain_ms = phase3(dev)
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "sweep_kernel", "route": "cuda",
        "source": "metropolismontecarlo_tpu_torch/csrc/sweep_kernel.cu",
        "replaces": "metropolismontecarlo_tpu/ops/pallas/sweep_kernel.py:903",
        "launches": launches, "max_abs_err": max(err2, err3), "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
