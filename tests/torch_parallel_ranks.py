"""Rank bodies of tests/test_torch_parallel.py and the systems they share
with it.  Each world function runs on every rank of a gloo world that
metropolismontecarlo_tpu_torch.parallel.mesh.run_world starts on the CPU;
it lives apart from the test file so that the ranks import torch and the
port only.  Rank 0 returns the gathered results; the other ranks return
what the test checks rank by rank."""

import contextlib
import dataclasses

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gcmc import make_gcmc
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMC
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC, make_gcmc_mol
from metropolismontecarlo_tpu_torch.mc.gcmc_osmotic import OsmoticGCMC
from metropolismontecarlo_tpu_torch.mc.gibbs import make_gibbs
from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
    BinaryGibbsEnsemble,
)
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol
from metropolismontecarlo_tpu_torch.models.monatomic import (
    lj_box_for_density,
    lj_system,
)
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    spce_methane_system,
    spce_system,
    spce_two_blocks,
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


# ---------------- the ensembles, chain-sharded --------------------------
# The dryrun's state point (__graft_entry__.py's sharded muVT, Gibbs and
# flip cycles): SPC/E, Ewald nk 3, r_cut 4.5, 700 K; a fresh ensemble
# object per run, its generator seeded ENSEMBLE_SEED.
ENS = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
           coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.3,
           dphi_max=0.3, use_lrc=False, strict_min_image=False)
LJ_ENS = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
              cutoff_mode="site", coulomb="none", p_translate=0.5,
              dr_max=0.4, use_lrc=False)
F32 = torch.float32
ENSEMBLE_SEED = 3
LADDER_Z = np.geomspace(5e-5, 5e-4, N_CHAINS)     # one activity per chain
LADDER_N0 = np.arange(N_CHAINS) % 9               # per-chain starts, 0..8
TMMC_ETA = np.linspace(0.0, 2.0, 9)               # a bias on N = 0..8


def _fields(state, **extra):
    out = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    out.update(extra)
    return out


def _muvt(mega, ladder=False):
    def case(C, shard, call, gen):
        g = MolGCMC(spce_system(8), RunParams(**ENS),
                    activity=LADDER_Z if ladder else 2e-4, dtype=F32,
                    mega=mega, device="cpu", generator=gen)
        with shard():
            st = g.init(box=10.0, n_init=LADDER_N0 if ladder else 4,
                        n_chains=C)
        return _fields(call(g.run_steps, st, 30 if mega is None else 33))
    return case


def _tmmc(mega):
    def case(C, shard, call, gen):
        if mega is None:
            init, run, _ = make_gcmc_mol(spce_system(8), RunParams(**ENS),
                                         2e-4, dtype=F32, tmmc=True,
                                         device="cpu", generator=gen)
        else:
            t = TMMCMol(spce_system(8), RunParams(**ENS), activity=2e-4,
                        dtype=F32, mega=mega, device="cpu", generator=gen)
            init, run = t.init, t._run_steps
        with shard():
            st = init(10.0, LADDER_N0, C)
        st, cmat, uhist = call(run, st, TMMC_ETA, 33)
        return _fields(st, cmat=cmat, uhist=uhist)
    return case


def _gibbs(mega, p_volume, widom=False):
    def case(C, shard, call, gen):
        dtype = F32 if mega else F64
        g = MolGibbsEnsemble(spce_system(8), RunParams(**dict(
            ENS, use_lrc=True, p_volume=p_volume)), dv_max=0.03,
            p_transfer=0.3, dtype=dtype, mega=mega, device="cpu",
            generator=gen)
        with shard():
            st = g.init(boxes=(10.0, 12.0), n_init=(5, 3), n_chains=C)
        st = call(g.run_steps, st, 23)
        extra = {"widom": call(g.widom_boltzmann, st, 4)} if widom else {}
        return _fields(st, **extra)
    return case


def _semigrand(mega):
    def case(C, shard, call, gen):
        g = Semigrand(spce_two_blocks(6, 6), RunParams(**ENS),
                      fugacity_ratio=2.0, p_flip=0.3,
                      dtype=F32 if mega else F64, mega=mega, device="cpu",
                      generator=gen)
        with shard():
            st = g.init(box=10.0, n_a=3, n_b=3, n_chains=C)
        return _fields(call(g.run_steps, st, 24))
    return case


def _binary(mega):
    def case(C, shard, call, gen):
        g = BinaryGCMC(spce_two_blocks(6, 6), RunParams(**ENS),
                       activities=(2e-4, 3e-4), p_exchange=0.4,
                       dtype=F32 if mega else F64, mega=mega, device="cpu",
                       generator=gen)
        with shard():
            st = g.init(box=10.0, n_init=(4, 4), n_chains=C)
        return _fields(call(g.run_steps, st, 40))
    return case


def _osmotic(C, shard, call, gen):
    g = OsmoticGCMC(spce_two_blocks(6, 6), RunParams(**ENS), activity=2e-4,
                    p_exchange=0.4, dtype=F32, mega="full", device="cpu",
                    generator=gen)
    with shard():
        st = g.init(box=10.0, n_init=3, n_chains=C)
    return _fields(call(g.run_steps, st, 40))


def _npt_gibbs(C, shard, call, gen):
    g = BinaryGibbsEnsemble(spce_two_blocks(6, 6), RunParams(**dict(
        ENS, p_volume=0.5)), dv_max=0.02, p_transfer=0.4, dtype=F32,
        mega="full", npt_pressure=0.05, device="cpu", generator=gen)
    with shard():
        st = g.init(boxes=(10.0, 12.0), n_init=[[4, 2], [2, 4]], n_chains=C)
    return _fields(call(g.run_steps, st, 24))


def _lj_gcmc(C, shard, call, gen):
    init, run, _ = make_gcmc(lj_system(1), RunParams(**LJ_ENS), 0.05, 16,
                             device="cpu", generator=gen)
    with shard():
        st = init(4.0, 8, C)
    return _fields(call(run, st, 40))


def _lj_gibbs(C, shard, call, gen):
    init, run, _, widom = make_gibbs(
        lj_system(1), RunParams(**dict(LJ_ENS, p_volume=0.5)), 16,
        dv_max=0.05, device="cpu", generator=gen)
    with shard():
        st = init((5.0, 6.0), (10, 6), C)
    st = call(run, st, 20)
    return _fields(st, widom=call(widom, st, 4))


def _mc_widom(C, shard, call, gen):
    mc = MonteCarlo(spce_system(8), RunParams(**WATER), device="cpu",
                    dtype=F64, recompute_chunk=2, kernel="plain",
                    generator=gen)
    with shard():
        st = mc.init_state(cubic_lattice(8, 12.0), box=12.0, n_chains=C)
    w = call(mc.widom, st, 8)
    return {"boltzmann_mean": w["boltzmann_mean"], "mu_ex": w["mu_ex"],
            "quat": st.quat}


# case -> its run of C chains: case(C, shard, call, generator) -> {field:
# per-chain rows}; shard() is the context of the init, call(fn, state,
# *args) runs a closure on the state
ENSEMBLES = {
    "muvt plain": _muvt(None), "muvt hybrid": _muvt(True),
    "muvt full": _muvt("full"), "muvt ladder plain": _muvt(None, True),
    "muvt ladder full": _muvt("full", True),
    "tmmc plain": _tmmc(None), "tmmc full": _tmmc("full"),
    "gibbs full pv0": _gibbs("full", 0.0),
    "gibbs full pv0.5": _gibbs("full", 0.5),
    "gibbs plain pv0.5 widom": _gibbs(None, 0.5, widom=True),
    "semigrand plain": _semigrand(None), "semigrand full": _semigrand("full"),
    "binary plain": _binary(None), "binary full": _binary("full"),
    "osmotic full": _osmotic, "npt-gibbs full": _npt_gibbs,
    "lj gcmc plain": _lj_gcmc, "lj gibbs plain widom": _lj_gibbs,
    "montecarlo widom": _mc_widom,
}


def run_ensemble(name, n_chains, mesh=None, c0=None):
    """Case `name` of ENSEMBLES on n_chains chains: unsharded without a
    mesh; with one, this rank's shard (the init under pm.chain_shard,
    every closure through pm.sharded_call); with c0, every closure and
    the init under shard_context(c0, N_CHAINS) (a wrong offset on every
    rank but the first)."""
    gen = torch.Generator().manual_seed(ENSEMBLE_SEED)
    if c0 is not None:
        def shard():
            return shard_context(c0, N_CHAINS)

        def call(fn, st, *args):
            with shard():
                return fn(st, *args)
    elif mesh is not None:
        def shard():
            return pm.chain_shard(mesh, n_chains)

        def call(fn, st, *args):
            return pm.sharded_call(fn, st, mesh, *args)
    else:
        shard = contextlib.nullcontext

        def call(fn, st, *args):
            return fn(st, *args)
    return ENSEMBLES[name](n_chains, shard, call, gen)


def _gather_rows(rows, mesh):
    return {k: pm.gather_chains(v, mesh) for k, v in rows.items()}


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
    # the ensembles, each rank its 4 chains of 16
    L = N_CHAINS // 4
    for name in ENSEMBLES:
        rows = run_ensemble(name, L, mesh)
        if name == "muvt plain":
            out["n hist"] = pm.pooled_histogram(rows["active"].sum(1), 9,
                                                mesh)
        out[f"ens {name}"] = _gather_rows(rows, mesh)
    # the negative control: every rank keyed as the first shard
    out["ens unkeyed"] = _gather_rows(
        run_ensemble("muvt plain", L, c0=0), mesh)
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
