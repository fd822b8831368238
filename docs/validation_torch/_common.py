"""Shared plumbing of the PyTorch port's validation drivers: the command
line every driver takes (--device, --out), the device line of a record,
and the record itself.

A record's first lines are the device (on the card the `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` line), the protocol,
the gate lines with this run's values, `RESULT: PASS|FAIL` and the wall
time (the parts' processes included, where a driver ran its parts as
processes of their own); tables and traces follow a blank line.  The drivers run on the card
unless `--device cpu` is given; without a CUDA device they exit non-zero.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parser(doc, record):
    """An ArgumentParser with --device (default cuda) and --out (default
    docs/validation_torch/<record>)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--out", default=os.path.join(HERE, record),
                    help="the record to write")
    return ap


def device_of(args, name):
    """The torch.device of --device; exits non-zero for a CUDA request
    without a CUDA device (nothing falls back to the CPU)."""
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit(f"{name}: no CUDA device (pass --device cpu to run the "
                     "kernels' plain versions on the CPU)")
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def device_line(dev):
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's note."""
    if dev.type != "cuda":
        return "device: cpu (the kernels' plain versions)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return f"device: {smi}"


def generator(dev, seed):
    """A torch.Generator on dev seeded `seed` (the JAX scripts'
    PRNGKey(seed))."""
    return torch.Generator(device=dev).manual_seed(int(seed))


def folded_generator(dev, seed, index):
    """A torch.Generator on dev seeded from (seed, index) (the JAX
    scripts' fold_in(PRNGKey(seed), index))."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(1)
    return generator(dev, int(state[0]))


class Record:
    """Collects a driver's gate lines and writes its record."""

    def __init__(self, dev, protocol):
        self.t0 = time.perf_counter()
        self.head = [device_line(dev), f"protocol: {protocol}"]
        self.gates = []
        self.detail = []
        self.ok = True
        print(self.head[0], flush=True)

    def stamp(self):
        """The seconds since the record opened, for progress lines."""
        return f"[{time.perf_counter() - self.t0:.0f} s]"

    def gate(self, line, ok=None):
        """A gate line; ok (bool) folds into the result, None reports."""
        if ok is not None:
            self.ok &= bool(ok)
        self.gates.append(line)
        print(line, flush=True)

    def note(self, line):
        """A line after the header (tables, traces)."""
        self.detail.append(line)

    def write(self, path, parts=None):
        """Writes the record; returns the exit code (0 on PASS).  parts
        (run_parts' result): the wall of those run in processes of their
        own counts into the record's."""
        own = time.perf_counter() - self.t0
        away = [float(r["wall"]) for r in (parts or {}).values()
                if r.get("loaded")]
        wall = f"wall: {own + sum(away):.1f} s"
        if away:
            wall += (f" ({sum(away):.1f} s in {len(away)} processes of the "
                     f"parts, the longest {max(away):.1f} s; {own:.1f} s in "
                     "the one that wrote the record)")
        lines = self.head + self.gates + [
            f"RESULT: {'PASS' if self.ok else 'FAIL'}", wall]
        if self.detail:
            lines += [""] + self.detail
        text = "\n".join(lines) + "\n"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        print("\n".join(lines[-2:]), flush=True)
        print(f"wrote {path}", flush=True)
        return 0 if self.ok else 1


def pf(ok):
    return "PASS" if ok else "FAIL"


def add_parts(ap, parts):
    """--parts and --partials: a driver whose protocol splits into
    independent parts (temperatures, state points, ensembles) can run
    some of them in one process and save each to --partials, another
    process the others; the process that finds every part there writes
    the record."""
    ap.add_argument("--parts", nargs="*", choices=list(parts),
                    help="run only these parts and save them (default: "
                         "run what --partials lacks, then the record)")
    ap.add_argument("--partials",
                    help="directory of the parts' results (.npz)")


def run_parts(args, parts, run):
    """{part: results dict, its wall under "wall"} of every part: loaded
    from --partials where saved there (then marked "loaded"), else run by
    run(part) and saved.  With --parts only those run, and the result is
    None: a part's process writes no record."""
    out = {}
    for part in parts:
        path = os.path.join(args.partials, f"{part}.npz") \
            if args.partials else None
        if path and os.path.exists(path):
            with np.load(path) as f:
                out[part] = {k: f[k][()] if f[k].ndim == 0 else f[k]
                             for k in f.files}
            out[part]["loaded"] = True
            print(f"part {part}: loaded from {path}", flush=True)
        elif args.parts is None or part in args.parts:
            t0 = time.perf_counter()
            out[part] = dict(run(part), wall=time.perf_counter() - t0)
            if path:
                os.makedirs(args.partials, exist_ok=True)
                np.savez(path, **{k: np.asarray(v)
                                  for k, v in out[part].items()})
    if args.parts is not None:
        print(f"parts {args.parts} saved in {args.partials}", flush=True)
        return None
    return out
