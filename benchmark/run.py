"""Run one cell of BENCHMARK.json once on the card and print its result:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object with the keys
correct, attempted, failed, metrics, device (and, traced, breakdown),
then the card's name and power limit, and last the numbers the check
compared, each beside its limit; the same numbers are the last lines of
standard error.  Without a CUDA device, or with fewer than the cell asks
for, it exits 2 and prints no result; if modules of jax or the JAX
package are loaded once the window has closed it exits 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one process driving the card, with one host thread for CPU tensor work
os.environ.setdefault("OMP_NUM_THREADS", "1")


def card_line():
    """The card's name and power limit as nvidia-smi reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "power limit not read (no nvidia-smi)"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    torch.set_num_threads(1)

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(wl["chips"]):
        print(f"no CUDA device for {args.workload} (it needs "
              f"{wl['chips']}): the benchmark measures the card only",
              file=sys.stderr)
        return 2
    card = card_line()

    def log(line):
        print(f"{line} [{card}]", file=sys.stderr)

    log(f"cell {args.workload} seed {args.seed} seconds {args.seconds} "
        f"trace {args.trace}")
    rec = harness.run_cell(args.workload, args.seed, args.seconds,
                           args.trace, "cuda", T_PROCESS, bench=bench,
                           log=log)
    checked = rec.pop("checked")
    rec["card"] = card
    rec["checked"] = checked
    sys.stdout.flush()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
