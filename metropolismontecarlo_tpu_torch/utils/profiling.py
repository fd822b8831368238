"""Spans inside the port, off unless a sink is attached, and steady-state
timers that synchronise the card before reading the clock.

The port marks where its work happens with `span(name, units, sync)`:
`volume_move` around each volume move, `recompute` around each
full-energy recompute, `recompute.kernel` around the recompute kernel's
launch inside it (the kernel route), `chunk` around each group of rows
of a chunked map, and `energy.setup` / `energy.real` / `energy.kspace`
around the phases of one chunk of the dense energy (the plain route).
The muVT app (mc/gcmc_mol.py) adds `gcmc.cycle` around each sweep-kernel
launch of a cycle (both kernel routes) and `gcmc.exchange` around a
hybrid cycle's plain exchange steps.  With no sink attached (every
run that does not trace) `span` hands back one preallocated
`contextlib.nullcontext()`: it allocates nothing, calls nothing and never
synchronises the card.

A sink is any object with a method `span(name, units, sync)` that
returns a context manager; `attach(sink)` makes it the one sink of the
process, `detach()` removes it.  `units` counts the work inside the
span (1 per volume move; the chains or boxes of a recompute and of its
kernel launch; the rows of a chunk; the chains of a muVT cycle's launch;
chains x exchange steps of a hybrid cycle's exchanges).  `sync=True`
marks a span whose time a sink may measure by synchronising the card at
its ends (volume moves and recomputes end in host reads anyway);
`sync=False` marks one nested in a synchronised span, whose own sync
would serialise the launches it is timing (the kernel launches, the
chunks and their phases, the muVT cycles and exchange steps): a sink
counts or annotates it, and does not synchronise.
"""

import contextlib
import time

import torch

_NULL = contextlib.nullcontext()
_sink = None


def attach(sink):
    """Make sink (sink.span(name, units, sync) -> context manager) the
    receiver of every span of the process."""
    global _sink
    _sink = sink


def detach():
    """Remove the attached sink: spans do nothing again."""
    global _sink
    _sink = None


def span(name, units=1, sync=True):
    """The attached sink's span(name, units, sync), or a shared
    nullcontext when none is attached."""
    if _sink is None:
        return _NULL
    return _sink.span(name, units, sync)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def throughput(fn, *args, warmup=1, iters=3):
    """Steady-state seconds per call of fn(*args), the card synchronised
    before each clock read."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def sweeps_per_sec(mc, state, n_steps=1):
    """Aggregate MC sweeps per second over all chains of mc.run_steps."""
    dt = throughput(lambda s: mc.run_steps(s, n_steps, False), state)
    return state.com.shape[0] * n_steps / dt
