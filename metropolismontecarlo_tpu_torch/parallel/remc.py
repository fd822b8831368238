"""Replica-exchange Monte Carlo (parallel tempering) across the chain axis
(counterpart of the single-device part of
metropolismontecarlo_tpu/parallel/remc.py).

Chain c holds temperature T_c (SimState.temp).  A round proposes swaps of
configurations between adjacent chains (phase 0: pairs (0, 1), (2, 3),
...; phase 1: (1, 2), (3, 4), ...), accepted with

  P_acc = min(1, exp((1/T_i - 1/T_j)(E_i - E_j))).

Both members of a pair read the same uniform, u[min(i, j)] of (C,)
uniforms drawn from the caller's generator (the JAX package keys its draw
on that pair id).  `exchange_shardlocal` is the same round on a rank's
shard of chain-sharded chains (parallel/mesh.py): the two edge chains of
each shard take their partners from the neighbouring ranks through one
all_gather, and the result equals `exchange` on the whole state bit for
bit.
"""

import dataclasses

import torch
import torch.distributed as dist

from metropolismontecarlo_tpu_torch.parallel.mesh import CHAINS, mesh_axis

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


def exchange_shardlocal(state, generator, phase, mesh):
    """`exchange` on this rank's shard `state` (L chains, the rows
    [r L, (r + 1) L) of C = n L, r this rank's index along the mesh's
    chains axis of n ranks): the same global pairs, uniforms and accept
    rule, so the shards together equal `exchange` of the whole state bit
    for bit.  A pair across a shard boundary reads the neighbour's edge
    row: one all_gather of every rank's first and last rows of temp and
    each swapped field (JAX's two ppermute edge swaps; gloo takes CUDA
    tensors for all_gather but not for send / recv).  generator: seeded
    as on every other rank; each draws the (C,) uniforms of the whole
    round.  Returns (state, swap fraction over all C chains, a 0-d
    tensor from an all_reduce of the swap and active counts)."""
    group = mesh.get_group(CHAINS)
    r, n = mesh_axis(mesh, CHAINS)
    L = state.temp.shape[0]
    C = n * L
    dev = state.temp.device
    c = r * L + torch.arange(L, device=dev)              # global chain ids
    base = c - ((c - phase) % 2 * 2 - 1)
    partner = torch.where((base >= 0) & (base < C), base, c).clamp(0, C - 1)
    active = partner != c
    up = partner > c                                     # partner is c + 1

    # every rank's first and last rows of temp and the swapped fields
    fields = ("temp",) + _SWAP_FIELDS
    rows = [getattr(state, f) for f in fields]
    edge = torch.cat([x[i].reshape(-1) for i in (0, -1) for x in rows])
    edges = [torch.empty_like(edge) for _ in range(n)]
    dist.all_gather(edges, edge.contiguous(), group=group)
    half = edge.numel() // 2
    nxt_flat = edges[(r + 1) % n][:half]     # the next rank's first rows
    prv_flat = edges[(r - 1) % n][half:]     # the previous rank's last rows

    def unpack(flat):
        out, i = {}, 0
        for f, x in zip(fields, rows):
            k = x[0].numel()
            out[f] = flat[i:i + k].reshape((1,) + x.shape[1:])
            i += k
        return out

    nxt, prv = unpack(nxt_flat), unpack(prv_flat)

    def partner_vals(f):
        x = getattr(state, f)
        x_up = torch.cat([x[1:], nxt[f]])
        x_dn = torch.cat([prv[f], x[:-1]])
        return torch.where(up.reshape((L,) + (1,) * (x.dim() - 1)), x_up,
                           x_dn)

    arg = (1.0 / state.temp - 1.0 / partner_vals("temp")) \
        * (state.energy - partner_vals("energy"))
    u = torch.rand(C, generator=generator, device=dev,
                   dtype=state.temp.dtype)[torch.minimum(c, partner)]
    swap = active & ((arg > 0.0) | (u < torch.exp(torch.clamp_max(arg, 0.0))))

    def take_partner(f):
        x = getattr(state, f)
        s = swap.reshape((L,) + (1,) * (x.dim() - 1))
        return torch.where(s, partner_vals(f), x)

    state = dataclasses.replace(
        state, **{f: take_partner(f) for f in _SWAP_FIELDS})
    counts = torch.stack([swap.sum(), active.sum()])
    dist.all_reduce(counts, group=group)
    return state, counts[0] / torch.clamp_min(counts[1], 1)
