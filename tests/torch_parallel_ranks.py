"""Rank bodies of tests/test_torch_parallel.py and the systems they share
with it.  Each world function runs on every rank of a gloo world that
metropolismontecarlo_tpu_torch.parallel.mesh.run_world starts on the CPU;
it lives apart from the test file so that the ranks import torch and the
port only.  Rank 0 returns the gathered results; the other ranks return
what the test checks rank by rank."""

import dataclasses

import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import (
    lj_box_for_density,
    lj_system,
)
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    spce_methane_system,
    spce_system,
)
from metropolismontecarlo_tpu_torch.parallel import mesh as pm
from metropolismontecarlo_tpu_torch.parallel.remc import (
    exchange_shardlocal,
    temperature_ladder,
)
from metropolismontecarlo_tpu_torch.parallel.tp import (
    make_mesh_2d,
    tp_full_energy_fn,
)
from metropolismontecarlo_tpu_torch.utils.shard import shard_context

F64 = torch.float64
WATER = dict(temperature=300.0, r_cut=5.0, cutoff_mode="site",
             coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.3,
             dphi_max=0.4)
LJ = dict(strict_min_image=False, temperature=1.2, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=1.0, dr_max=0.15)
# route -> (kernel, dtype): the plain route in f64, the whole-sweep and
# per-move routes (their kernels' plain versions on the CPU) in f32
ROUTES = {"plain": ("plain", F64), "sweep": ("sweep", torch.float32),
          "move": ("move", torch.float32)}
LADDER = (250.0, 500.0)
REMC_SEED = 21
N_CHAINS = 16          # the 4-rank world's chains, 4 per rank


def water_mc(n_chains, seed=0, kernel="plain", dtype=F64, tp_mesh=None,
             **kw):
    """SPC/E-8 in a 12 A box from a cubic lattice (the JAX tests'
    _tiny_water_mc), the driver's generator seeded `seed`."""
    mc = MonteCarlo(spce_system(8), RunParams(**dict(WATER, **kw)),
                    device="cpu", dtype=dtype, recompute_chunk=2,
                    kernel=kernel, tp_mesh=tp_mesh,
                    generator=torch.Generator().manual_seed(seed))
    return mc, mc.init_state(cubic_lattice(8, 12.0), box=12.0,
                             n_chains=n_chains)


def npt_mc(n_chains):
    """water_mc under NPT: a volume attempt every second sweep."""
    return water_mc(n_chains, seed=3, pressure=3e-3, p_volume=0.5,
                    dv_max=0.05)


def with_ladder(state):
    C = state.temp.shape[0]
    return dataclasses.replace(state, temp=temperature_ladder(
        *LADDER, C, dtype=state.temp.dtype))


def tp_case(name):
    """(MonteCarlo, state) of a tensor-parallel case:
    SPC/E-9 (27 atoms, not a multiple of row_block x shards) with Ewald,
    LJ-27 without charges, the ragged SPC/E + one-site CH4 mixture with
    Ewald; two sweeps away from the lattice, f64."""
    if name == "spce9":
        system, params, box, C = spce_system(9), RunParams(**WATER), 12.5, 4
    elif name == "lj27":
        system, params = lj_system(27), RunParams(**LJ)
        box, C = lj_box_for_density(27, 0.6), 8
    else:
        system, params, box, C = spce_methane_system(6, 6), \
            RunParams(**WATER), 12.0, 4
    mc = MonteCarlo(system, params, device="cpu", dtype=F64,
                    recompute_chunk=2, kernel="plain",
                    generator=torch.Generator().manual_seed(5))
    state = mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                          n_chains=C)
    return mc, mc.run_steps(state, 2)


TP_MESHES = {"spce9": (2, 4), "lj27": (4, 2), "ragged": (2, 4)}


def world4(rank):
    """Four ranks, four chains each."""
    mesh = pm.make_mesh(device="cpu")
    out = {}
    for route, (kernel, dtype) in ROUTES.items():
        mc, state = water_mc(N_CHAINS, kernel=kernel, dtype=dtype)
        local = pm.sharded_run_steps(mc, pm.shard_state(state, mesh), mesh,
                                     2)
        out[f"run {route}"] = pm.gather_state(local, mesh)
        if route == "plain":
            mean = pm.pooled_mean(local.energy, mesh)
            out["pooled mean"] = (mean, out["run plain"].energy.mean())
            out["pooled acc"] = pm.pooled_mean(local.acc, mesh)
            # one exchange round of each phase on the swept shards, with
            # the ladder's rows of each
            gen = torch.Generator().manual_seed(11)
            st = pm.shard_state(with_ladder(out["run plain"]), mesh)
            fracs = []
            for phase in (0, 1):
                st, f = exchange_shardlocal(st, gen, phase, mesh)
                fracs.append(f)
            out["exchange"] = (pm.gather_state(st, mesh),
                               torch.stack(fracs))
    # sharded init: each rank draws its rows of the chain-global
    # orientations and recomputes its own chains only
    with shard_context(rank * 4, N_CHAINS):
        _, local = water_mc(4)
    out["init"] = pm.gather_state(local, mesh)
    # replica exchange every 2 sweeps: odd phases pair across the ranks
    mc, state = water_mc(N_CHAINS, seed=2)
    local, fracs = pm.sharded_run_steps(
        mc, pm.shard_state(with_ladder(state), mesh), mesh, 4, remc_every=2,
        remc_generator=torch.Generator().manual_seed(REMC_SEED))
    out["remc"] = (pm.gather_state(local, mesh), fracs)
    mc, state = npt_mc(N_CHAINS)
    out["npt"] = pm.gather_state(pm.sharded_run_steps(
        mc, pm.shard_state(state, mesh), mesh, 2), mesh)
    try:
        pm.make_mesh(device="cpu", backend="nccl")
    except ValueError as e:
        out["backend refused"] = str(e)
    return out if rank == 0 else out["remc"][1]


def world8(rank):
    """Eight ranks: the tensor-parallel recompute on 2 x 4 and 4 x 2
    meshes, and MonteCarlo(tp_mesh=...) on 2 x 4."""
    out = {}
    for name, shape in TP_MESHES.items():
        mesh = make_mesh_2d(*shape, device="cpu")
        mc, state = tp_case(name)
        local = pm.shard_state(state, mesh)
        fn = tp_full_energy_fn(mc.system, mc.params, mesh, mc.kvecs,
                               mc.kweights, recompute_chunk=2, row_block=8)
        e, w, sfac = fn(local.coords, local.com, local.box)
        out[name] = pm.gather_state(
            dataclasses.replace(local, energy=e, virial=w, sfac=sfac), mesh)
    mesh = make_mesh_2d(2, 4, device="cpu")
    mc, local = water_mc(2, tp_mesh=mesh)
    local, metrics = mc.run_block(local, 2)
    out["driver"] = (pm.gather_state(local, mesh), metrics["drift_max_rel"])
    return out if rank == 0 else metrics["drift_max_rel"]
