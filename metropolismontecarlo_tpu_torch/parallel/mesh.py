"""Chain-parallel scale-out over torch.distributed (counterpart of
metropolismontecarlo_tpu/parallel/mesh.py).

Chains are independent, so the port scales out by data parallelism over
them, as the JAX package does over its "chains" mesh axis:

* a 1-D `DeviceMesh` over the initialised world (`make_mesh`);
* every process (rank) holds one contiguous shard of the chains: the
  state fields that lead with C are sliced to the rank's rows
  (`shard_state`, `state_specs`), everything else is replicated.  These
  shards stand in for JAX's NamedSharding, and what each rank runs
  stands in for JAX's shard_map body;
* the sweeps are chain-local: `sharded_run_steps` runs them with no
  communication at all, under a shard context (utils/shard.py) that makes
  every random draw chain-global and keys the kernels' Philox streams on
  global chain ids, so the sharded run equals the unsharded one bit for
  bit.  `sharded_call` does the same for any ensemble closure (init,
  run_steps on every route, TMMC's (state, eta, n) form, Widom), and
  `chain_shard` is the bare context;
* pooled means (`pooled_mean`), pooled histograms (`pooled_histogram`)
  and replica exchange (parallel/remc.py exchange_shardlocal) are the
  collectives: JAX's psum and ppermute become all_reduce and all_gather
  over the mesh's groups.

`run_world` starts the ranks of one host as fresh processes joined by a
file rendezvous (no TCP port), the way the tests run gloo worlds on the
CPU and chip_smoke.py runs them on one card.  The backend follows the
device, NCCL on "cuda" and gloo on "cpu"; a caller may name another, and
nothing switches it quietly: make_mesh refuses a world whose backend is
not the one asked for.
"""

import dataclasses
import datetime
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from metropolismontecarlo_tpu_torch.utils.shard import shard_context

CHAINS = "chains"


def default_backend(device):
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_mesh(shape, names, device, backend):
    """A DeviceMesh of `shape` over the whole initialised world, after
    checking the world: its size, and its backend against `backend`
    (default_backend(device) when None)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo "
                           "world on the CPU")
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised: call "
            "init_process_group first (run_world does, for one host)")
    want = backend or default_backend(device)
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"the world runs {have} but the mesh asks for "
                         f"{want}: pass backend={have!r}, or initialise "
                         f"the world with {want}")
    n = 1
    for s in shape:
        n *= int(s)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks over a world of "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices=None, device="cuda", backend=None):
    """1-D mesh over the chains axis, spanning the initialised world
    (n_devices, when given, must be its size)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return init_mesh((n_devices,), (CHAINS,), device, backend)


def mesh_axis(mesh, name):
    """(this rank's index, the number of ranks) along mesh axis `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_local_rank(name), mesh.size(dim)


def state_specs(state):
    """Which fields of a state dataclass shard over the chains: CHAINS for
    each tensor that leads with the chain count C (= com.shape[0]), None
    (replicated) for the rest, such as the 0-d step counter."""
    n = state.com.shape[0]
    specs = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        chain = torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n
        specs[f.name] = CHAINS if chain else None
    return specs


def shard_state(state, mesh):
    """This rank's shard of a whole state: the rows [r L, (r + 1) L) of
    every chain field (state_specs), r the rank's index along the chains
    axis and L = C / (ranks along it); replicated fields as they are.
    Ranks along another axis (parallel/tp.py's atoms) get the same
    rows."""
    r, n = mesh_axis(mesh, CHAINS)
    C = state.com.shape[0]
    if C % n:
        raise ValueError(f"{C} chains do not split over {n} shards")
    L = C // n
    return dataclasses.replace(state, **{
        k: getattr(state, k)[r * L:(r + 1) * L].clone()
        for k, s in state_specs(state).items() if s == CHAINS})


def gather_chains(x, mesh):
    """Every rank's rows of a chain-sharded tensor x (chains leading, the
    same shape on every rank), concatenated in rank order, on every rank:
    one all_gather over the chains axis."""
    n = mesh_axis(mesh, CHAINS)[1]
    flag = x.dtype == torch.bool
    x = x.to(torch.uint8) if flag else x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(CHAINS))
    out = torch.cat(parts)
    return out.bool() if flag else out


def gather_state(state, mesh):
    """The whole state from every rank's shard (shard_state's inverse),
    on every rank: one gather_chains per chain field."""
    return dataclasses.replace(state, **{
        k: gather_chains(getattr(state, k), mesh)
        for k, s in state_specs(state).items() if s == CHAINS})


def pooled_mean(x, mesh, axis=0):
    """The mean over every rank's chains of a chain-sharded tensor x
    (chains along `axis`): the local sum all_reduced over the chains
    axis, divided by the global chain count (equal shards)."""
    group = mesh.get_group(CHAINS)
    n = mesh_axis(mesh, CHAINS)[1]
    x = x if x.is_floating_point() else x.double()
    s = x.sum(axis)
    dist.all_reduce(s, group=group)
    return s / (x.shape[axis] * n)


def pooled_histogram(values, n_bins, mesh):
    """The histogram over every rank's chains of a chain-sharded integer
    tensor `values` (such as a muVT run's N = active.sum(-1)) in bins 0
    .. n_bins - 1: the local counts (int64) all_reduced over the chains
    axis, JAX's psum of the N histogram."""
    h = torch.bincount(values.reshape(-1).long(), minlength=int(n_bins))
    if h.shape[0] != int(n_bins):
        raise ValueError(f"a value beyond the {n_bins} bins")
    dist.all_reduce(h, group=mesh.get_group(CHAINS))
    return h


def chain_shard(mesh, n_local):
    """The shard context (utils/shard.py) of this rank's n_local chains:
    chains [r n_local, (r + 1) n_local) of n_local x (ranks along the
    chains axis), r the rank's index along it.  Every draw inside is
    chain-global; wrap an ensemble's init in it, with n_chains=n_local,
    for the unsharded init's rows."""
    r, n = mesh_axis(mesh, CHAINS)
    return shard_context(r * n_local, n * n_local)


def sharded_call(fn, state, mesh, *args, **kwargs):
    """fn(state, *args, **kwargs) on this rank's shard `state` (from
    shard_state) under its chain_shard: the ensembles' counterpart of
    JAX's shard_map(lambda st: run(st, ...), in_specs=P("chains")).  fn
    is any closure over the chains, such as an ensemble's run_steps on
    every route (TMMC's run_steps(state, eta, n) too, whose cmat and
    uhist come back as this rank's rows), its widom_boltzmann or a
    volume move; it runs with no collectives and returns what fn
    returns, each per-chain result this rank's rows of the unsharded
    run's.  The ensemble object must be fresh or advanced as the
    unsharded run's (the kernel routes key their Philox seeds on the
    generator's seed and a per-closure launch count), and its generator
    seeded as the unsharded run's.  An ensemble's run_block statistics
    (means over chains, the drift maximum) stay per rank, as they do
    under JAX's shard_map: pool them with pooled_mean or
    pooled_histogram."""
    with chain_shard(mesh, state.com.shape[0]):
        return fn(state, *args, **kwargs)


def sharded_run_steps(mc, state, mesh, n_steps, adjust=False,
                      remc_every=0, remc_generator=None, phase0=0):
    """n_steps sweeps of this rank's shard `state` (from shard_state) by
    mc.run_steps, each rank its own chains with no collectives, under the
    shard context that makes the run equal the unsharded one bit for bit
    (every rank's mc draws from a generator seeded as the unsharded
    run's).  Returns the local state.

    remc_every > 0 interleaves replica-exchange rounds (phases alternating
    from phase0) every remc_every sweeps by exchange_shardlocal, drawing
    from remc_generator (the same seed on every rank); returns then
    (state, swap fractions (n_rounds,)), each the global fraction."""
    from metropolismontecarlo_tpu_torch.parallel.remc import (
        exchange_shardlocal,
    )

    if remc_every and n_steps % remc_every:
        raise ValueError("n_steps must be a multiple of remc_every")
    if remc_every and remc_generator is None:
        raise ValueError("replica exchange needs remc_generator")
    with chain_shard(mesh, state.com.shape[0]):
        if not remc_every:
            return mc.run_steps(state, n_steps, adjust)
        fracs = []
        for i in range(n_steps // remc_every):
            state = mc.run_steps(state, remc_every, adjust)
            state, frac = exchange_shardlocal(state, remc_generator,
                                              (phase0 + i) % 2, mesh)
            fracs.append(frac)
    return state, torch.stack(fracs)


def _rank_main(rank, fn, world_size, args, device, backend, threads,
               timeout, tmp):
    if threads:
        torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(tmp, "rendezvous"),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        torch.save(fn(rank, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(fn, world_size, args=(), device="cuda", backend=None,
              threads=None, timeout=600.0):
    """Run fn(rank, *args) on world_size fresh processes of this host,
    joined into one torch.distributed world (backend: default_backend(
    device) when None) by a file rendezvous in a temporary directory;
    threads pins each rank's torch thread count, timeout (s) bounds every
    collective.  fn must be importable (a module-level function) and
    return what torch.save can write.  A rank that raises ends the run,
    and the error is raised here.  Returns each rank's result, in rank
    order.  On "cuda" rank r uses card r mod the card count."""
    backend = backend or default_backend(device)
    with tempfile.TemporaryDirectory(prefix="mmc_world_") as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, tuple(args), device, backend,
                              threads, timeout, tmp),
            nprocs=world_size, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
