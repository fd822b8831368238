"""The port's own spans, fed to the benchmark's Spans, and the per-layer
readings they give, in a traced run of one cell:

    python3 -m benchmark.port_spans --workload <cell> --seed <n> \\
        --seconds <s>

The port marks where its work happens with
`metropolismontecarlo_tpu_torch.utils.profiling.span`: `volume_move`
around each volume move, `recompute` around each chunked full-energy
recompute (units: chains, or boxes in the Gibbs cells), `chunk` around
each group of a chunked map (units: its rows), and `energy.setup`,
`energy.real`, `energy.kspace` around the phases of one chunk.
PortSpans is tracing.Spans with what those spans need: each record has
a sixth field, the name of the span it opened in (None at the top), and
`span()` takes `sync`; a `sync=False` span does nothing in the timing
pass, counts its units in the counting pass and marks itself in the
noting pass.

`run` is harness.run_cell's `--trace 1` passes with a PortSpans attached
to the port (profiling.attach) for all three: the timing pass times the
volume moves, the counting pass counts the chunks under each recompute,
and the noting pass puts the port's spans on the profiler's clock, so
that an idle gap of the card is named by the innermost port span the
host was in.  It returns the readings under the names of the metrics
they would be (`volume.ms_per_move.<kind>`,
`recompute.chunks_per_call.<kind>`, `recompute.idle_share.<kind>`; kind
`sweeps`, `npt` or `gibbs` by the cell's rate), the cell's accepted
span metrics as this timing pass reads them, each pass's wall, the
noting pass's longest idle gaps and the idle share inside each port
span.  The last line of standard output is that record as JSON.
"""

import argparse
import contextlib
import json
import sys
import time
from types import SimpleNamespace

import torch

from benchmark import harness, spec, tracing

KIND = {"chain_sweeps_per_s": "sweeps", "npt_sweeps_per_s": "npt",
        "ensemble_moves_per_s": "gibbs"}
PORT_SPANS = ("volume_move", "recompute", "chunk", "energy.setup",
              "energy.real", "energy.kspace")


class PortSpans(tracing.Spans):
    """tracing.Spans whose records are (mode, name, start s, end s, units,
    parent name), fed by the benchmark's spans and the port's."""

    def __init__(self, device, mode="quiet"):
        super().__init__(device, mode)
        self._open = []

    @contextlib.contextmanager
    def span(self, name, units, sync=True):
        mode = self.mode
        if mode not in tracing.MODES:
            raise ValueError(f"span mode {mode!r}")
        if mode == "quiet" or (mode == "time" and not sync):
            yield
            return
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        try:
            if mode == "time":
                self._sync()
                t0 = time.perf_counter()
                yield
                self._sync()
                t1 = time.perf_counter()
            elif mode == "note":
                with torch.profiler.record_function(name):
                    yield
                t0 = t1 = 0.0
            else:
                yield
                t0 = t1 = 0.0
        finally:
            self._open.pop()
        self.records.append((mode, name, t0, t1, units, parent))


def idle_share_in(trace, name):
    """The share of the union of trace's note intervals called name
    (clipped to its window) during which no device interval ran; None
    where there is no such note or the trace holds no device activity."""
    spans = sorted((max(a, trace.t0), min(b, trace.t1))
                   for a, b, n in trace.notes if n == name)
    union = []
    for a, b in spans:
        if b <= a:
            continue
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    total = sum(b - a for a, b in union)
    if not total or not trace.device:
        return None
    busy, i = 0, 0
    dev = trace.busy()
    for a, b in union:
        while i < len(dev) and dev[i][1] <= a:
            i += 1
        j = i
        while j < len(dev) and dev[j][0] < b:
            busy += min(b, dev[j][1]) - max(a, dev[j][0])
            j += 1
    return 1.0 - busy / total


def note_trace(prof):
    """tracing.Trace of a noting pass with the port's spans among its host
    notes and none among its device intervals.  Where this torch reports
    no activity type for an event, tracing.Trace knows an annotation by
    the names in tracing.NOTES alone: it drops the port's host spans and
    counts their ranges on the card as device work."""
    tr = tracing.Trace(prof)
    tr.device = [d for d in tr.device if d[2] not in PORT_SPANS]
    for ev in prof.profiler.kineto_results.events():
        cls, name, t0, t1 = tracing._classify(ev)
        if name in PORT_SPANS and cls != "note" \
                and "CUDA" not in str(tracing._attr(ev, "device_type")):
            tr.notes.append((t0, t1, name))
    return tr


def ms_per_move(spans):
    """Mean milliseconds of the timing pass's volume_move spans."""
    s, _, n = spans.total("volume_move")
    return 1e3 * s / n if n else None


def chunks_per_call(spans):
    """The counting pass's chunk spans opened inside a recompute, over its
    recompute spans."""
    calls = chunks = 0
    for r in spans.records:
        if r[0] == "count":
            calls += r[1] == "recompute"
            chunks += r[1] == "chunk" and r[5] == "recompute"
    return chunks / calls if calls else None


def readings(kind, spans, note_trace):
    """The per-layer readings of a cell of `kind`, None where its run had
    nothing to read."""
    share = idle_share_in(note_trace, "recompute")
    return {f"volume.ms_per_move.{kind}": ms_per_move(spans),
            f"recompute.chunks_per_call.{kind}": chunks_per_call(spans),
            f"recompute.idle_share.{kind}":
                None if share is None else 100.0 * share}


def run(workload, seed, seconds, device, config=None, traffic=None):
    """The three traced passes of the cell `workload` (harness.run_cell,
    trace on) with a PortSpans attached to the port; returns the record
    the module docstring lists.  config / traffic replace the files the
    cell names (tests)."""
    from metropolismontecarlo_tpu_torch.utils import profiling

    device = torch.device(device)
    bench = spec.benchmark()
    wl = spec.workload(bench, workload)
    config = spec.config(wl["config"]) if config is None else config
    traffic = spec.traffic(wl["traffic"]) if traffic is None else traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.ensemble(traffic["ensemble"]).Cell(config, traffic, seed,
                                                   device)
    cell.setup()
    spans = PortSpans(device)
    cell.install(spans)
    limit_s = min(seconds, harness.TRACE_SECONDS)
    walls = {}
    profiling.attach(spans)
    try:
        spans.mode = "time"
        walls["time"] = harness._blocks(cell, limit_s, device)[1:]
        spans.mode = "count"
        walls["count"] = harness._blocks(
            cell, limit_s, device, harness._profile(device, True))[1:]
        spans.mode = "note"
        prof = harness._profile(device, False)
        walls["note"] = harness._blocks(cell, limit_s, device, prof,
                                        annotate=True)[1:]
        notes = note_trace(prof)
        del prof
    finally:
        profiling.detach()
        spans.mode = "quiet"
        cell.free()
    kind = KIND[cell.rate_metric]
    # the accepted span metrics, read from this run's timing pass
    ctx = SimpleNamespace(unit=cell.unit, spans=spans, trace=None,
                          bounds=None, volume_events=0, device=device)
    timed = {m["name"]: spec.reader(m["name"])(ctx)
             for m in spec.per_layer(bench, workload)}
    return {"workload": workload, "seed": int(seed),
            "metrics": {k: v for k, v in
                        readings(kind, spans, notes).items()
                        if v is not None},
            "span_metrics": {k: v for k, v in timed.items()
                             if v is not None},
            "walls": walls, "idle_gaps": notes.idle_gaps(),
            "idle_in": {n: idle_share_in(notes, n)
                        for n in ("run_steps", "full_energy") + PORT_SPANS}}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="benchmark.port_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the port's spans are read on the card only",
              file=sys.stderr)
        return 2
    from benchmark.run import card_line

    rec = run(args.workload, args.seed, args.seconds, "cuda")
    rec["card"] = card_line()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
