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

The draws: `rand_chains` and `randn_chains` (torch.rand / torch.randn),
each with `fold` for a leading axis of fold rows per chain, chain-major
(the Gibbs ensembles' (2 C, ...) box-folded draws); a draw without a
leading axis is the same on every rank and stays plain.
ops/quaternions.py's random draws go through them.  `chain_rows` takes a
process's rows of a per-chain input of the global length (an activity
ladder, per-chain starts).
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


def _chain_draw(draw, shape, generator, dtype, device, fold):
    shape = tuple(shape)
    shard = _SHARD.get()
    if shard is None or not shape:
        return draw(shape, generator=generator, dtype=dtype, device=device)
    c0, n_global = shard
    fold = int(fold)
    if shape[0] % fold:
        raise ValueError(f"a leading axis of {shape[0]} rows does not fold "
                         f"{fold} rows per chain")
    L = shape[0] // fold
    if c0 + L > n_global:
        raise ValueError(f"chains [{c0}, {c0 + L}) exceed the "
                         f"{n_global} chains of the shard context")
    full = draw((n_global, fold) + shape[1:], generator=generator,
                dtype=dtype, device=device)
    return full[c0:c0 + L].reshape(shape)


def rand_chains(shape, generator, dtype=torch.float32, device=None, fold=1):
    """torch.rand(shape) whose leading axis is the chains this process
    holds, `fold` rows per chain (chain-major): under a shard context the
    rows of chains c0:c0 + shape[0] / fold of the chain-global draw
    (n_global * fold,) + shape[1:].  Unsharded, the same numbers as
    torch.rand(shape) for every fold (the same count in the same
    order)."""
    return _chain_draw(torch.rand, shape, generator, dtype, device, fold)


def randn_chains(shape, generator, dtype=torch.float32, device=None,
                 fold=1):
    """rand_chains' standard-normal twin (torch.randn)."""
    return _chain_draw(torch.randn, shape, generator, dtype, device, fold)


def chain_rows(x, n_local, what="per-chain input"):
    """This process's rows of a per-chain input x whose leading axis is
    the global chain count: rows c0:c0 + n_local under a shard context.
    x may also hold just the n_local rows already; any other length
    raises.  Outside a context x must have n_local rows.  A 0-d tensor
    (one value for every chain) broadcasts to (n_local,)."""
    if torch.is_tensor(x) and x.dim() == 0:
        return torch.broadcast_to(x, (n_local,))
    n = int(x.shape[0])
    shard = _SHARD.get()
    if shard is not None and n == shard[1] and n != n_local:
        c0 = shard[0]
        if c0 + n_local > n:
            raise ValueError(f"chains [{c0}, {c0 + n_local}) exceed the "
                             f"{n} rows of the {what}")
        return x[c0:c0 + n_local]
    if n != n_local:
        glob = "" if shard is None else f" (or the {shard[1]} global chains)"
        raise ValueError(f"{what} must have n_chains entries: {n} for "
                         f"n_chains={n_local}{glob}")
    return x
