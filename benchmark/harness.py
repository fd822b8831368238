"""One run of one cell: set-up, the measured window of whole blocks, the
check of what the window produced, and the result record.

The window drives the cell's own block entry (ensembles/): blocks start
while the time since the window opened is under `seconds`, and the last
one is let finish; the card is synchronised at both ends.  A rate is all
the work the blocks asked for over the whole window, block-end
recomputes and volume moves included.  `setup_s` runs from the start of
the process to the opening of the window.

With trace on, the run has three passes of whole blocks in place of the
measured window, each closing after the first block that ends past
TRACE_SECONDS (or `seconds`, if shorter): a timing pass, the spans
synchronising the card at their ends with no profiler on (the span
metrics); a device pass under torch.profiler with CUDA activity alone
(busy time, kernel time, the device operations); and a noting pass under
CPU and CUDA activity with the spans marked in the timeline and no sync
(the idle gaps, named by what the host was in).  Each pass's wall is
logged.  The per-layer metrics come from metrics/<name>.py.
"""

import contextlib
import gc
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import check, spec, tracing

TRACE_SECONDS = 2.0
BANNED = ("jax", "jaxlib", "flax", "metropolismontecarlo_tpu")


def banned_modules():
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(device, cuda_only):
    """A started torch.profiler: CUDA activity alone, or CPU and CUDA (CPU
    alone off the card)."""
    acts = [torch.profiler.ProfilerActivity.CUDA] \
        if device.type == "cuda" else []
    if not cuda_only or not acts:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _blocks(cell, limit_s, device, prof=None, annotate=False):
    """Whole blocks of the cell while the time since the first started is
    under limit_s, the card synchronised before the first and after the
    last; then stops prof.  With annotate, the pass and its blocks are
    marked in the profiler's timeline ("window", "block").  Returns
    (work, blocks, seconds)."""
    def note(name):
        return torch.profiler.record_function(name) if annotate \
            else contextlib.nullcontext()

    _sync(device)
    work = blocks = 0
    t0 = time.perf_counter()
    with note("window"):
        while blocks == 0 or time.perf_counter() - t0 < limit_s:
            with note("block"):
                work += cell.block()
            blocks += 1
        _sync(device)
    seconds = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    return work, blocks, seconds


def run_cell(workload, seed, seconds, trace, device, t_process, bench=None,
             config=None, traffic=None, limits=None, log=None):
    """Run the cell `workload` once; returns the result record (the keys
    of the printed line).  config / traffic / limits replace the files the
    cell names (tests); log(line) takes the check's lines."""
    device = torch.device(device)
    bench = spec.benchmark() if bench is None else bench
    wl = spec.workload(bench, workload)
    config = spec.config(wl["config"]) if config is None else config
    traffic = spec.traffic(wl["traffic"]) if traffic is None else traffic
    limits = spec.limits(workload) if limits is None else limits
    # S(k) phases need full f32 products (the port refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False

    cell = spec.ensemble(traffic["ensemble"]).Cell(config, traffic, seed,
                                                   device)
    cell.setup()
    bounds = cell.bounds() if trace else None
    spans = tracing.Spans(device)
    cell.install(spans)
    _sync(device)
    setup_s = time.perf_counter() - t_process

    if not trace:
        work, blocks, window_s = _blocks(cell, seconds, device)
    else:
        limit_s = min(seconds, TRACE_SECONDS)
        spans.mode = "time"
        _, blocks, wall = _blocks(cell, limit_s, device)
        walls = {"time": (blocks, wall)}
        spans.mode = "count"
        ev0 = cell.volume_events
        dev_prof = _profile(device, cuda_only=True)
        n, wall = _blocks(cell, limit_s, device, dev_prof)[1:]
        blocks += n
        walls["count"] = (n, wall)
        volume_events = cell.volume_events - ev0
        dev_trace = tracing.Trace(dev_prof, window=None, window_s=wall)
        del dev_prof
        spans.mode = "note"
        note_prof = _profile(device, cuda_only=False)
        n, wall = _blocks(cell, limit_s, device, note_prof,
                          annotate=True)[1:]
        blocks += n
        walls["note"] = (n, wall)
        gaps = tracing.Trace(note_prof).idle_gaps()
        del note_prof
        spans.mode = "quiet"
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    found = banned_modules()
    if found:
        print(f"modules of jax or the JAX package loaded: {found}",
              file=sys.stderr)
        raise SystemExit(3)

    exact = cell.exact_counts()
    failed = sum(1 for i in range(blocks)
                 if any(v[i] for v in exact.values()))
    t_check = time.perf_counter()
    rows, accept = cell.check_rows(), cell.acceptance()
    rate_metric, unit = cell.rate_metric, cell.unit
    cell.free()
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.program_numbers(rows, config)
    acc_numbers, acc_readings = check.acceptance_numbers(accept, config,
                                                         seed)
    numbers.update(acc_numbers)
    correct, checked = check.judge(numbers, exact, limits)
    correct = correct and failed == 0
    check_s = time.perf_counter() - t_check

    e2e = spec.end_to_end(bench, workload)
    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if not trace:
        for m in e2e:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == rate_metric:
                value = work / window_s
            else:
                raise KeyError(f"cell {workload} reports no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(unit=unit, spans=spans, trace=dev_trace,
                              bounds=bounds, volume_events=volume_events,
                              device=device)
        for m in spec.per_layer(bench, workload):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=dev_trace.busy_s, window_s=dev_trace.window_s)
        breakdown = {"device_ops": dev_trace.device_ops(),
                     "idle_gaps": gaps}
        del dev_trace

    if log is not None:
        if trace:
            for mode, (n, wall) in walls.items():
                log(f"pass {mode} blocks {n} wall {wall!r}")
        log(f"check seconds {check_s!r}")
        for kind, r in acc_readings.items():
            log(f"accepted {kind} {r['realized']!r} expected "
                f"{r['expected']!r}")
        for name, c in checked.items():
            log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    rec = {"correct": bool(correct), "attempted": blocks, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        rec["breakdown"] = breakdown
    rec["blocks"] = blocks
    if not trace:
        rec["window_s"] = window_s
    rec["checked"] = checked
    return rec
