"""Chain-global random draws for chain-sharded runs.

A chain-sharded run (parallel/mesh.py) gives each process rows [c0, c0 +
L) of C_global chains.  Inside `shard_context(c0, C_global)` every draw
whose leading axis is the chains draws the whole (C_global, ...) tensor
from the generator and keeps rows c0:c0 + L.  Every rank's generator then
advances as the unsharded run's does, so the per-launch Philox seeds
derived from it stay the same on every rank, and each chain sees the
numbers it sees unsharded: the sharded run equals the unsharded one bit
for bit.  The cost: each rank draws what the whole unsharded run draws
(C_global / L times its own share of uniforms).

`chain_offset()` is the c0 the kernels' Philox streams add to their
chain index (the `chain0` argument of ops/cuda's sweep, sweep_gibbs and
flip).  Outside a context both are the plain unsharded draw and 0.
"""

import contextlib
import contextvars

import torch

_SHARD = contextvars.ContextVar("chain_shard", default=None)


@contextlib.contextmanager
def shard_context(c0, n_global):
    """Within the block this process holds chains [c0, c0 + L) of
    n_global; L is each draw's own leading size."""
    c0, n_global = int(c0), int(n_global)
    if not 0 <= c0 < n_global:
        raise ValueError(f"chain offset {c0} outside 0..{n_global - 1}")
    token = _SHARD.set((c0, n_global))
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard():
    """(c0, n_global) of the innermost shard_context, or None."""
    return _SHARD.get()


def chain_offset():
    """The global index of this process's first chain (0 unsharded)."""
    shard = _SHARD.get()
    return 0 if shard is None else shard[0]


def rand_chains(shape, generator, dtype=torch.float32, device=None):
    """torch.rand(shape) whose leading axis is the chains this process
    holds: under a shard context the rows c0:c0 + shape[0] of the
    chain-global draw (n_global,) + shape[1:]."""
    shape = tuple(shape)
    shard = _SHARD.get()
    if shard is None:
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    c0, n_global = shard
    if c0 + shape[0] > n_global:
        raise ValueError(f"chains [{c0}, {c0 + shape[0]}) exceed the "
                         f"{n_global} chains of the shard context")
    full = torch.rand((n_global,) + shape[1:], generator=generator,
                      dtype=dtype, device=device)
    return full[c0:c0 + shape[0]]
