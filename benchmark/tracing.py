"""Spans around the calls into the port's layers, and the reduction of a
torch.profiler trace to device busy time, idle gaps and kernel time.

A span is taken by the benchmark around a call that the block entry makes
through the instance (run_steps, full_energy).  What a span does is set
by the pass of the run it falls in (`Spans.mode`): in the measured window
nothing; in a timing pass it synchronises the card at both ends, so that
its host-clock length is the layer's wall time, with no profiler on; in
a counting pass (the device trace) it counts its units only; in a noting
pass it marks itself in the profiler's timeline (record_function), with
no sync, so that idle gaps on the device can be named by what the host
was in.
"""

import contextlib
import re
import time
from collections import defaultdict

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
MODES = ("quiet", "time", "count", "note")


class Spans:
    """Recorded spans: (mode, name, start s, end s, units), the times on
    the host clock in the "time" mode only."""

    def __init__(self, device, mode="quiet"):
        self.device = torch.device(device)
        self.mode = mode
        self.records = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name, units):
        mode = self.mode
        if mode not in MODES:
            raise ValueError(f"span mode {mode!r}")
        if mode == "quiet":
            yield
            return
        if mode == "time":
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.records.append((mode, name, t0, time.perf_counter(), units))
            return
        if mode == "note":
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.records.append((mode, name, 0.0, 0.0, units))

    def total(self, name, mode="time"):
        """(seconds, units, count) of the spans called name in a mode."""
        recs = [r for r in self.records if r[0] == mode and r[1] == name]
        return (sum(r[3] - r[2] for r in recs), sum(r[4] for r in recs),
                len(recs))


def _attr(ev, name):
    f = getattr(ev, name, None)
    return f() if callable(f) else f


NOTES = ("window", "block", "run_steps", "full_energy")


def _classify(ev):
    """("device" | "note" | None, name, start ns, end ns) of one kineto
    event: device kernels, copies and sets, and the harness's host
    annotations (by the event's activity type where this torch reports
    it, else by device and name)."""
    name = _attr(ev, "name")
    on_dev = "CUDA" in str(_attr(ev, "device_type"))
    kind = _attr(ev, "activity_type")
    kind = None if kind is None else str(kind).split(".")[-1].lower()
    if kind is not None and kind != "":
        cls = "device" if kind in DEVICE_ACTIVITIES else \
            "note" if kind == "user_annotation" and not on_dev else None
    elif on_dev:
        cls = None if name in NOTES else "device"
    else:
        cls = "note" if name in NOTES else None
    t0 = _attr(ev, "start_ns")
    t1 = _attr(ev, "end_ns")
    if t1 is None:
        t1 = t0 + _attr(ev, "duration_ns")
    return cls, name, t0, t1


class Trace:
    """The device intervals and host annotations of one profiler run,
    clipped to the annotation `window`; with window None (a trace of
    device activity alone) every device interval, over a window of
    window_s seconds measured by the caller."""

    def __init__(self, prof, window="window", window_s=None):
        dev, notes, kinds = [], [], {}
        for ev in prof.profiler.kineto_results.events():
            cls, name, t0, t1 = _classify(ev)
            kinds[cls] = kinds.get(cls, 0) + 1
            if cls == "device":
                dev.append((t0, t1, name))
            elif cls == "note":
                notes.append((t0, t1, name))
        self.counts = kinds
        if window is None:
            self.t0 = min((a for a, _, _ in dev), default=0)
            self.t1 = self.t0 + int(round(window_s * 1e9))
            self.device = sorted((a, min(b, self.t1), n) for a, b, n in dev
                                 if a < self.t1)
            self.notes = []
            return
        wins = [n for n in notes if n[2] == window]
        if not wins:
            raise RuntimeError(f"the trace holds no {window!r} annotation "
                               f"(events by class: {kinds})")
        self.t0, self.t1 = wins[0][0], wins[0][1]
        self.device = sorted((max(a, self.t0), min(b, self.t1), n)
                             for a, b, n in dev if b > self.t0 and a < self.t1)
        self.notes = [n for n in notes if n[2] != window]

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    def busy(self):
        """The union of the device intervals, [(start, end)] in ns."""
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy()) * 1e-9

    def kernel_s(self, pattern):
        """Device seconds of the intervals whose name matches pattern."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.device if rx.search(n)) * 1e-9

    def device_ops(self, n=10):
        """The n device operations that took most time, [name, s]."""
        tot = defaultdict(int)
        for a, b, name in self.device:
            tot[name] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], v * 1e-9] for name, v in top]

    def idle_gaps(self, n=10):
        """The n longest idle gaps of the device in the window, each named
        by the innermost harness span the host was in at its midpoint
        ("window" outside every span)."""
        gaps, last = [], self.t0
        for a, b in self.busy():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            inside = [nt for nt in self.notes if nt[0] <= mid <= nt[1]]
            name = min(inside, key=lambda nt: nt[1] - nt[0])[2] \
                if inside else "window"
            out.append([name, (b - a) * 1e-9])
        return out
