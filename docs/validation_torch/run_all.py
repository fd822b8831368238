"""Run the port's validation drivers, several at once.

    python3 docs/validation_torch/run_all.py [--jobs 6] [--device cuda]
        [--outdir DIR] [--only NAME ...] [--smoke] [--split]
        [--set NAME="FLAGS" ...]

On the card the four CUDA kernels are built first (one nvcc each, all at
once), then up to --jobs drivers run as processes of their own, the
longest first: most of them are host-bound (plain steps, recomputes) and
share the card well.  Each writes its record to DIR/logs/ and its output
to DIR/logs/<name>.log; a record moves to DIR (default
docs/validation_torch) once its driver has finished, so a driver that
fails or is cut leaves the record there as it was.  One line per driver
reports its exit code, wall time and RESULT.  --smoke runs
each at the smallest depth (SMOKE, the flags the CPU tests use); --split
runs the independent parts of the drivers in PARTS as processes of their
own; --set appends flags to one driver (and to each of its parts).
Exits non-zero if a driver wrote no record.
"""

import argparse
import os
import shlex
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# (driver, record), the longest runs first
DRIVERS = (
    ("run_spce_dielectric", "spce_dielectric.txt"),
    ("run_co2_density", "co2_density.txt"),
    ("run_lj_phase_diagram", "lj_phase_diagram.txt"),
    ("run_gibbs_water", "gibbs_water_lrc.txt"),
    ("run_tmmc_coexistence", "tmmc_coexistence.txt"),
    ("run_spce_eos", "spce_eos.txt"),
    ("run_npt_density", "npt_density.txt"),
    ("run_bar_water", "bar_water.txt"),
    ("run_binary_co2_n2", "binary_co2_n2.txt"),
    ("run_gibbs_co2_n2", "gibbs_co2_n2.txt"),
    ("run_gibbs_npt_co2_n2", "gibbs_npt_co2_n2.txt"),
    ("run_semigrand_binomial", "semigrand_binomial.txt"),
    ("run_gcmc_kernel_exchange", "gcmc_kernel_exchange.txt"),
    ("run_gibbs_kernel_exchange", "gibbs_kernel_exchange.txt"),
    ("run_gcmc_water", "gcmc_water.txt"),
    ("run_widom_kernel", "widom_kernel.txt"),
    ("run_tmmc_water", "tmmc_water.txt"),
    ("run_remc_ladder", "remc_ladder.txt"),
    ("run_gcmc_lrc", "gcmc_lrc.txt"),
    ("run_gcmc_mbar", "gcmc_mbar.txt"),
    ("run_remc_mbar", "remc_mbar.txt"),
    ("run_mega_boltzmann", "mega_prng_boltzmann.txt"),
)

# the drivers whose independent parts can run as processes of their own
# (--split): each part saves its results under DIR/partials/<driver>, and
# one more process of the driver writes the record from them
PARTS = {
    "run_lj_phase_diagram": ("0.85", "0.95", "1.0", "1.05"),
    "run_gibbs_water": ("7.5", "8.5"),
    "run_tmmc_coexistence": ("tmmc", "gibbs"),
    "run_gibbs_kernel_exchange": ("0", "1", "2"),
    "run_semigrand_binomial": ("plain", "kernel"),
}

# the smallest depth of each driver (a record in seconds on the CPU)
SMOKE = {
    "run_mega_boltzmann": "--chains 4 --rounds 2 --gap 1 --decorrelate 1",
    "run_remc_ladder": "--equil 1 --rounds 2 --sweeps 1",
    "run_remc_mbar": "--equil 1 --rounds 2 --sweeps 1",
    "run_npt_density": "--chains 1 --equil 1 --prod 1 --sweeps 1",
    "run_spce_eos": "--chains-per-p 1 --equil 1 --prod 1 --sweeps 1",
    "run_spce_dielectric": "--chains 1 --equil 1 --prod 1 --sweeps 1",
    "run_gcmc_water": "--chains 1 --equil 1 --prod 1 --steps 1 "
                      "--nvt-blocks 0 1 --nvt-sweeps 1 1",
    "run_gcmc_lrc": "--chains 2 --blocks 1 --steps 1 --equil 1",
    "run_gcmc_mbar": "--per-rung 1 --direct-chains 1 --blocks 1 --steps 1 "
                     "--equil 1",
    "run_gcmc_kernel_exchange": "--scale 0.001",
    "run_widom_kernel": "--chains 1 --equil 1 --blocks 2 --sweeps 1",
    "run_tmmc_coexistence": "--tm-chains 2 --tm-blocks 1 --tm-steps 1 "
                            "--g-chains 1 --g-equil 1 --g-blocks 1 "
                            "--g-steps 1",
    "run_lj_phase_diagram": "--chains 2 --steps 1 --blocks-cold 1 "
                            "--blocks 1",
    "run_gibbs_water": "--no-lrc --chains 1 --preeq 0 --equil 0 --prod 1 "
                       "--steps 1 --works 1",
    "run_bar_water": "--n 8 --chains 4 --equil 1 --stage-equil 1 --prod 1 "
                     "--equil-sweeps 1 --block 1 --short-ladder",
    "run_co2_density": "--chains 1 --equil 1 --prod 1 --sweeps 1",
    "run_gibbs_kernel_exchange": "--scale 0.001 --samples 1 --blocks 1",
    "run_semigrand_binomial": "--chains 2 --equil 1 --prod 2 --steps 2",
    "run_binary_co2_n2": "--chains 2 --equil 1 --prod 1 --steps 2 "
                         "--nvt-equil 0 --nvt-blocks 1",
    "run_gibbs_co2_n2": "--chains 1 --melt 1 --blocks 1 --steps 1",
    "run_gibbs_npt_co2_n2": "--chains 1 --melt 1 --blocks 1 --steps 1",
    "run_tmmc_water": "--chains 2 --melt 1 --blocks 1 --steps 1",
}


def prebuild():
    """Build the four kernels at once before the drivers start."""
    sys.path.insert(0, ROOT)
    import concurrent.futures

    from metropolismontecarlo_tpu_torch.ops.cuda import build

    names = ("sweep_kernel", "delta_energy", "gibbs_kernel", "flip_kernel")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.build, names))
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)


def staged(args, out):
    """Where a driver writes its record until it has finished."""
    return os.path.join(args.outdir, "logs", os.path.basename(out))


def result_line(path):
    if not os.path.exists(path):
        return "no record"
    with open(path) as f:
        for line in f:
            if line.startswith("RESULT:"):
                return line.strip()
    return "no RESULT line"


def jobs_of(args):
    """[(label, driver, record path, flags, labels it waits for)], the
    longest first; with --split a part per process and its driver's
    record after them."""
    extra = dict(s.split("=", 1) for s in args.set)
    jobs = []
    for name, record in DRIVERS:
        if args.only and name not in args.only:
            continue
        out = os.path.join(args.outdir, record)
        flags = shlex.split(SMOKE[name]) if args.smoke else []
        flags += shlex.split(extra.get(name, ""))
        if args.split and name in PARTS:
            partials = ["--partials",
                        os.path.join(args.outdir, "partials", name)]
            labels = [f"{name}[{p}]" for p in PARTS[name]]
            jobs += [(lab, name, out, flags + partials + ["--parts", p], ())
                     for lab, p in zip(labels, PARTS[name])]
            jobs.append((name, name, out, flags + partials, tuple(labels)))
        else:
            jobs.append((name, name, out, flags, ()))
    return jobs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--outdir", default=HERE)
    ap.add_argument("--only", nargs="*")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=FLAGS")
    args = ap.parse_args(argv)
    todo = jobs_of(args)
    os.makedirs(os.path.join(args.outdir, "logs"), exist_ok=True)
    for _, _, out, _, _ in todo:
        if os.path.exists(staged(args, out)):
            os.remove(staged(args, out))
    if args.device == "cuda":
        prebuild()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    running, done, failed, t_all = [], set(), 0, time.perf_counter()
    while todo or running:
        ready = [j for j in todo if done.issuperset(j[4])]
        while ready and len(running) < args.jobs:
            job = ready.pop(0)
            todo.remove(job)
            label, name, out, flags, _ = job
            cmd = [sys.executable, os.path.join(HERE, f"{name}.py"),
                   "--device", args.device, "--out", staged(args, out),
                   *flags]
            log = open(os.path.join(args.outdir, "logs", f"{label}.log"),
                       "w")
            running.append((label, out, log, time.perf_counter(),
                            subprocess.Popen(cmd, stdout=log,
                                             stderr=subprocess.STDOUT,
                                             env=env, cwd=ROOT)))
        time.sleep(1.0)
        for item in list(running):
            label, out, log, t0, proc = item
            if proc.poll() is None:
                continue
            running.remove(item)
            log.close()
            done.add(label)
            part = label.endswith("]")
            res = "part" if part else result_line(staged(args, out))
            if not part and res != "no record":
                os.replace(staged(args, out), out)
            failed += res == "no record" or (part and proc.returncode != 0)
            print(f"{label}: rc {proc.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s, {res}", flush=True)
    print(f"all drivers: {time.perf_counter() - t_all:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
