"""Benchmark of the port (counterpart of the repo's bench.py):

    BENCH_CONFIG=spce BENCH_CHAINS=2048 BENCH_STEPS=2 \\
        python -m metropolismontecarlo_tpu_torch.bench

Times `run_steps` of one configuration on the card, chains in parallel,
and prints as its last line one JSON object with bench.py's fields:
metric, value (sweeps/s summed over chains), unit, vs_baseline (against
the reference's 2.8 serial sweeps/s), config, chains, steps, dtype,
first_call_s and command, plus mega for the four ensemble configs.  The
line before it is one JSON object with the wall time of one `run_block`
of the same length from the timed call's end state (the sweeps plus the
block-end recompute, which `value` leaves out).

BENCH_CONFIG: spce (default) | wolf | npt | lj | triatomic | mixture |
gcmc | tmmc | gibbs | semigrand.  mixture reads the MEA/TIP3P topology
and templates (topol.top, mea.pdb, tip3p.pdb) from the directory REF, as
bench.py does; without one of them it exits non-zero, naming the file,
and prints no number.  BENCH_CHAINS
and BENCH_STEPS set the scale (defaults as bench.py's); the ensemble
configs time cycles (cap moves + exchange attempts) and count their
sweep-equivalents, BENCH_MEGA=full (default) or hybrid picks their route.

Starts.  bench.py reads a NIST 750-water configuration for spce, wolf
and npt and a CNF file for triatomic; neither file is in the repo.  Here
spce, wolf and npt start from cubic_lattice(750, 28.24) with random
orientations and triatomic from an aligned simple-cubic lattice of 256
molecules in a TRIATOMIC_BOX box; each then runs MELT_SWEEPS untimed
sweeps with step-size adaptation, and the metric label says so; so does
mixture (100 MEA + 1900 TIP3P on a lattice at 0.004 molecules per A^3,
as bench.py).

The card is synchronised before every clock read; first_call_s is the
cold start, the first call of the timed length (a kernel build not yet
cached included; no config here takes the per-move route, whose graph
capture it would also hold).
`main(device="cpu")` runs the same on the CPU.
"""

import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_SWEEPS_PER_SEC = 2.8   # serial Julia, one CPU core
MELT_SWEEPS = 10                # untimed, adaptive, after a lattice start
TRIATOMIC_BOX = 9.42953251      # 256 molecules: 0.3053 per sigma^3
# the reference's data directory, as bench.py's REF
REF = os.path.join(os.sep, "root", "reference")
ENSEMBLES = ("gcmc", "tmmc", "gibbs", "semigrand")
DEFAULT_CHAINS = {"mixture": 256, "gcmc": 1024, "tmmc": 1024,
                  "gibbs": 1024, "semigrand": 1024}
DEFAULT_STEPS = {"npt": 20, "lj": 50, "triatomic": 20, "gcmc": 16,
                 "tmmc": 16, "gibbs": 16, "semigrand": 16}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup_nvt(config, n_chains, device, gen):
    """(MonteCarlo, state, label, melt) of the fixed-N configs; melt: the
    start is to be melted (MELT_SWEEPS) before the timed calls."""
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.models.system import RunParams

    mc_kw = dict(device=device, generator=gen, dtype=torch.float32)
    melt = f"lattice start + {MELT_SWEEPS} melt sweeps"
    if config in ("spce", "wolf", "npt"):
        from metropolismontecarlo_tpu_torch.models.water import spce_system
        kw = dict(temperature=298.15, r_cut=10.0, cutoff_mode="site",
                  coulomb="wolf" if config == "wolf" else "ewald",
                  p_translate=0.5, dr_max=0.3, dphi_max=0.3)
        if config == "npt":
            p_bar = 1.0e5 / 1.380649e-23 * 1e-30      # 1 bar in K / A^3
            kw.update(pressure=p_bar, p_volume=0.05, dv_max=0.01)
        params = RunParams(**kw)
        mc = MonteCarlo(spce_system(750), params, **mc_kw)
        state = mc.init_state(cubic_lattice(750, 28.24), box=28.24,
                              n_chains=n_chains)
        label = (f"SPC/E 750-water Ewald NPT (1 bar), {melt}"
                 if config == "npt" else
                 f"SPC/E 750-water {params.coulomb.capitalize()} NVT, {melt}")
    elif config == "lj":
        from metropolismontecarlo_tpu_torch.models.monatomic import (
            lj_box_for_density,
            lj_system,
        )
        n = 256
        box = lj_box_for_density(n, 0.75)
        params = RunParams(temperature=1.0, r_cut=2.5, cutoff_mode="site",
                           coulomb="none", p_translate=1.0, dr_max=box / 30)
        mc = MonteCarlo(lj_system(n), params, **mc_kw)
        state = mc.init_state(cubic_lattice(n, box), box=box,
                              n_chains=n_chains)
        return mc, state, "256-atom LJ fluid NVT", False
    elif config == "triatomic":
        from metropolismontecarlo_tpu_torch.models.polyatomic import (
            mossa_params,
            triatomic_system,
        )
        quat = np.tile([1.0, 0.0, 0.0, 0.0], (256, 1))
        mc = MonteCarlo(triatomic_system(256), mossa_params(), **mc_kw)
        state = mc.init_state(cubic_lattice(256, TRIATOMIC_BOX), quat=quat,
                              box=TRIATOMIC_BOX, n_chains=n_chains)
        label = (f"256-triatomic Mossa LJ NVT, aligned {melt}, "
                 f"rho {256 / TRIATOMIC_BOX ** 3:.4f}")
    elif config == "mixture":
        from metropolismontecarlo_tpu_torch.io.topology import read_top
        from metropolismontecarlo_tpu_torch.models.from_topology import (
            system_from_topology,
            templates_from_pdbs,
        )
        top_path, mea, tip3p = (os.path.join(REF, f) for f in (
            "topol.top", "mea.pdb", "tip3p.pdb"))
        for path in (top_path, mea, tip3p):
            if not os.path.isfile(path):
                raise SystemExit(f"BENCH_CONFIG=mixture reads {path}, "
                                 "which is missing; no number")
        top = read_top(top_path)
        system = system_from_topology(
            top, templates_from_pdbs(top, {"MEA_DUMMY": mea, "SOL": tip3p}),
            molecules=[("MEA_DUMMY", 100), ("SOL", 1900)])
        params = RunParams(temperature=298.15, r_cut=10.0,
                           cutoff_mode="site", coulomb="ewald",
                           p_translate=0.5, dr_max=0.25, dphi_max=0.25)
        box = (system.n_mol / 0.004) ** (1.0 / 3.0)
        mc = MonteCarlo(system, params, **mc_kw)
        state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                              n_chains=n_chains)
        label = f"MEA+TIP3P 2000-molecule Ewald NVT, {melt}"
    else:
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}")
    return mc, state, label, True


def _setup_muvt(config, n_chains, mega_mode, device, gen):
    """Molecular muVT water (gcmc) or its TMMC variant (tmmc), cap 128: a
    timed unit is one cycle of cap moves + x_per exchange attempts."""
    from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
    from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    mega = {"full": "full", "hybrid": True}[mega_mode]
    cap, box, px = 128, 16.0, 0.3
    params = RunParams(temperature=500.0, r_cut=6.0, cutoff_mode="site",
                       coulomb="ewald", nk=5, ksq_max=27, p_translate=0.5,
                       dr_max=0.4, dphi_max=0.4, use_lrc=False,
                       strict_min_image=False)
    tmmc = config == "tmmc"
    cls = TMMCMol if tmmc else MolGCMC
    app = cls(spce_system(cap), params, activity=2.2e-4, p_exchange=px,
              dtype=torch.float32, mega=mega, device=device, generator=gen)
    state = app.init(box=box, n_init=cap // 2, n_chains=n_chains)
    x_per = max(1, int(round(cap * px / (1.0 - px))))
    apc = cap + x_per
    label = (f"SPC/E muVT{' TMMC' if tmmc else ''} cap-{cap} "
             f"{mega_mode}-mega-kernel, z=2.2e-4, p_exchange={px}")
    if tmmc:
        eta = np.zeros(cap + 1)

        def run(state, n_cycles):
            return app._run_steps(state, eta, n_cycles * apc)[0]
    else:
        def run(state, n_cycles):
            return app.run_steps(state, n_cycles * apc)
    return app, run, state, label, apc / cap, apc


def _setup_gibbs(n_chains, mega_mode, device, gen):
    """Two-box molecular Gibbs water, cap 128 per box: a timed unit is one
    cycle of 2 cap moves + x_per transfer attempts."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_system
    from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters

    mega = {"full": "full", "hybrid": True}[mega_mode]
    cap, px = 128, 0.3
    n_l, n_v = (2 * cap) // 3, cap // 6
    box_l = (n_l / 0.0267) ** (1.0 / 3.0)     # ~0.80 g/cc
    box_v = 18.0
    r_cut = min(7.5, 0.45 * box_l)
    # tuned at the largest box a volume exchange can reach
    box_max = (box_l**3 + box_v**3) ** (1.0 / 3.0)
    kl, nk, ksq = tune_parameters(box_max, r_cut, 1e-3)
    params = RunParams(temperature=450.0, r_cut=r_cut, cutoff_mode="site",
                       coulomb="ewald", kappa_L=kl, nk=nk, ksq_max=ksq,
                       p_translate=0.5, dr_max=0.3, dphi_max=0.4,
                       p_volume=0.002, use_lrc=False, strict_min_image=False)
    app = MolGibbsEnsemble(spce_system(cap), params, dv_max=0.03,
                           p_transfer=px, dtype=torch.float32, mega=mega,
                           device=device, generator=gen)
    state = app.init(boxes=(box_l, box_v), n_init=(n_l, n_v),
                     n_chains=n_chains)
    x_per = max(1, int(round(2 * cap * px / (1.0 - px))))
    apc = 2 * cap + x_per
    label = (f"SPC/E Gibbs cap-{cap}x2 {mega_mode}-mega-kernel, "
             f"p_transfer={px}")
    return app, (lambda s, n: app.run_steps(s, n * apc)), state, label, \
        apc / cap, apc


def _setup_semigrand(n_chains, mega_mode, device, gen):
    """Two identical SPC/E species blocks (fugacity ratio 2), cap 64 + 64:
    a timed unit is one cycle of M moves + x_per identity flips."""
    from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
    from metropolismontecarlo_tpu_torch.models.system import RunParams
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks

    mega = {"full": "full", "hybrid": True}[mega_mode]
    cap, px = 64, 0.3
    params = RunParams(temperature=600.0, r_cut=8.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=1.0, dphi_max=0.7, strict_min_image=False)
    app = Semigrand(spce_two_blocks(cap, cap), params, fugacity_ratio=2.0,
                    p_flip=px, dtype=torch.float32, mega=mega, device=device,
                    generator=gen)
    state = app.init(box=20.0, n_a=32, n_b=32, n_chains=n_chains)
    M = 2 * cap
    x_per = max(1, int(round(M * px / (1.0 - px))))
    apc = M + x_per
    label = (f"SPC/E semigrand cap-{cap}+{cap} {mega_mode}-mega-kernel, "
             f"xi=2, p_flip={px}")
    return app, (lambda s, n: app.run_steps(s, n * apc)), state, label, \
        apc / M, apc


def main(device="cuda"):
    """Run the benchmark of BENCH_CONFIG; returns the result record.
    device: the card unless the caller passes "cpu"; without a CUDA
    device the default raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on the GPU; "
                           "call main(device='cpu') to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = os.environ.get("BENCH_CONFIG", "spce")
    n_chains = int(os.environ.get("BENCH_CHAINS",
                                  str(DEFAULT_CHAINS.get(config, 2048))))
    n_steps = int(os.environ.get("BENCH_STEPS",
                                 str(DEFAULT_STEPS.get(config, 2))))
    mega_mode = os.environ.get("BENCH_MEGA", "full")
    gen = torch.Generator(device=device).manual_seed(0)
    melt = False

    if config == "gibbs":
        app, run, state, label, sweeps_per_unit, apc = _setup_gibbs(
            n_chains, mega_mode, device, gen)
    elif config == "semigrand":
        app, run, state, label, sweeps_per_unit, apc = _setup_semigrand(
            n_chains, mega_mode, device, gen)
    elif config in ("gcmc", "tmmc"):
        app, run, state, label, sweeps_per_unit, apc = _setup_muvt(
            config, n_chains, mega_mode, device, gen)
    else:
        app, state, label, melt = _setup_nvt(config, n_chains, device, gen)
        sweeps_per_unit, apc = 1.0, 1

        def run(state, n):
            return app.run_steps(state, n, False)

    # the cold start: the first call builds what is not built yet
    _sync(device)
    t0 = time.perf_counter()
    run(state, n_steps)
    _sync(device)
    first_call_s = time.perf_counter() - t0
    if melt and MELT_SWEEPS:
        state = app.resync(app.run_steps(state, MELT_SWEEPS, adjust=True))

    t0 = time.perf_counter()
    end = run(state, n_steps)
    _sync(device)
    dt = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, stats = app.run_block(end, n_steps * apc)
    _sync(device)
    print(json.dumps({"config": config, "run_block_s":
                      time.perf_counter() - t0, "run_block_steps": n_steps,
                      "drift_max_rel": stats["drift_max_rel"]}))

    value = n_chains * n_steps * sweeps_per_unit / dt
    command = (f"BENCH_CONFIG={config} BENCH_CHAINS={n_chains} "
               f"BENCH_STEPS={n_steps} python -m "
               "metropolismontecarlo_tpu_torch.bench")
    rec = {
        "metric": f"MC sweeps/sec/GPU ({label}, {n_chains} chains, f32)",
        "value": round(value, 2),
        "unit": "sweeps/s",
        "vs_baseline": round(value / BASELINE_SWEEPS_PER_SEC, 1),
        "config": config,
        "chains": n_chains,
        "steps": n_steps,
        "dtype": "float32",
        "first_call_s": round(first_call_s, 1),
        "command": command,
    }
    if config in ENSEMBLES:
        rec["mega"] = mega_mode
        rec["command"] = command.replace(
            "BENCH_CHAINS", f"BENCH_MEGA={mega_mode} BENCH_CHAINS")
    print(json.dumps(rec))
    sys.stdout.flush()
    return rec


if __name__ == "__main__":
    main()
