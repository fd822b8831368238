"""Profiling helpers (counterpart of
metropolismontecarlo_tpu/utils/profiling.py): a torch.profiler trace and
steady-state timers that synchronise the card before reading the clock."""

import contextlib
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir):
    """Trace the enclosed work with torch.profiler (CPU, and CUDA when a
    card is present) into log_dir, viewable in TensorBoard or Perfetto;
    the profiler object is yielded (key_averages() etc.)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


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
