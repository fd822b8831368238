"""Readings that the limits of a cell are set from; the benchmark's own
runs never run this.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --blocks <n> [--check-chains <m>]

In one process, for each seed: the cell's set-up, then n blocks of its
own block entry and the check of m sampled chains of each (n m at least
the chain-blocks a run's window compares), and the check's
numbers of what those blocks produced (the lower readings), with the
acceptance check's realized and expected shares and the reading of a
sampler that accepts every move (an upper reading of the acceptance
numbers; one that accepts none reads 1).  For the control seeds also the
control's numbers on the same configurations: the reference computed in
TF32 put in the program's place (the upper readings of the others).  One
JSON line per seed.
"""

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import check, spec, tracing


def readings(workload, seed, blocks, control, device, check_chains=None):
    """(program numbers, exact counts, control numbers or None, seconds of
    the blocks, acceptance readings) of one seed; check_chains replaces
    the traffic's sample size."""
    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    config, traffic = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    if check_chains:
        traffic = dict(traffic, check_chains=check_chains)
    cell = spec.ensemble(traffic["ensemble"]).Cell(config, traffic, seed,
                                                   device)
    cell.setup()
    cell.install(tracing.Spans(device))
    t0 = time.perf_counter()
    for _ in range(blocks):
        cell.block()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    exact = cell.exact_counts()
    rows, accept = cell.check_rows(), cell.acceptance()
    cell.free()
    del cell
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    prog = check.program_numbers(rows, config)
    acc_numbers, acc_readings = check.acceptance_numbers(accept, config,
                                                         seed)
    prog.update(acc_numbers)
    ctl = check.control_numbers(rows, config) if control else None
    return prog, exact, ctl, dt, acc_readings


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--blocks", type=int, required=True)
    ap.add_argument("--check-chains", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the readings are taken on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    ctl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for s in seeds + sorted(ctl_seeds - set(seeds)):
        prog, exact, ctl, dt, acc = readings(args.workload, s, args.blocks,
                                        s in ctl_seeds, "cuda",
                                        args.check_chains)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "blocks": args.blocks, "blocks_s": dt,
                          "program": prog, "acceptance": acc,
                          "exact": {k: sum(v) for k, v in exact.items()},
                          "control": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
