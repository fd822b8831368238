"""Replica-exchange Monte Carlo (parallel tempering) across the chain axis
(counterpart of the single-device part of
metropolismontecarlo_tpu/parallel/remc.py).

Chain c holds temperature T_c (SimState.temp).  A round proposes swaps of
configurations between adjacent chains (phase 0: pairs (0, 1), (2, 3),
...; phase 1: (1, 2), (3, 4), ...), accepted with

  P_acc = min(1, exp((1/T_i - 1/T_j)(E_i - E_j))).

Both members of a pair read the same uniform, u[min(i, j)] of (C,)
uniforms drawn from the caller's generator (the JAX package keys its draw
on that pair id).  The sharded variant (exchange_shardlocal) is not
ported yet.
"""

import dataclasses

import torch

_SWAP_FIELDS = ("com", "quat", "coords", "box", "sfac", "energy", "virial")


def temperature_ladder(t_min, t_max, n, kind="geometric",
                       dtype=torch.float32, device="cpu"):
    """Geometric (default) or linear replica ladder, (n,) tensor."""
    if kind == "geometric":
        i = torch.arange(n, dtype=torch.float64)
        lad = t_min * (t_max / t_min) ** (i / max(n - 1, 1))
    else:
        lad = torch.linspace(t_min, t_max, n, dtype=torch.float64)
    return lad.to(dtype=dtype, device=device)


def exchange(state, generator, phase):
    """One replica-exchange round over a SimState; phase 0 (even pairs)
    or 1 (odd pairs).  Temperatures and step sizes stay with their chain
    slots; configurations, energies, virials and S(k) swap.  Returns
    (state, swap_fraction as a 0-d tensor)."""
    C = state.temp.shape[0]
    dev = state.temp.device
    c = torch.arange(C, device=dev)
    base = c - ((c - phase) % 2 * 2 - 1)
    partner = torch.where((base >= 0) & (base < C), base, c).clamp(0, C - 1)
    active = partner != c
    arg = (1.0 / state.temp - 1.0 / state.temp[partner]) \
        * (state.energy - state.energy[partner])
    u = torch.rand(C, generator=generator, device=dev,
                   dtype=state.temp.dtype)[torch.minimum(c, partner)]
    swap = active & ((arg > 0.0) | (u < torch.exp(torch.clamp_max(arg, 0.0))))

    def take_partner(x):
        s = swap.reshape((C,) + (1,) * (x.dim() - 1))
        return torch.where(s, x[partner], x)

    state = dataclasses.replace(
        state, **{f: take_partner(getattr(state, f)) for f in _SWAP_FIELDS})
    frac = swap.sum() / torch.clamp_min(active.sum(), 1)
    return state, frac
