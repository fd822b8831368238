"""The port's parallel layer (metropolismontecarlo_tpu_torch/parallel/) on
gloo worlds of 4 and 8 CPU processes, float64 unless named, mirroring
tests/test_parallel.py:

* sharded_run_steps on 4 ranks x 4 chains equals the unsharded run_steps
  bit for bit on the plain, whole-sweep and per-move routes, under NPT,
  and from a sharded init_state;
* with replica exchange every 2 sweeps it equals the unsharded sweeps plus
  `exchange` with phases 0 then 1 (odd-phase pairs cross the ranks), and
  exchange_shardlocal alone equals exchange;
* tp_full_energy_fn on 2 x 4 and 4 x 2 meshes against the JAX package's
  tp_full_energy_fn and the port's unsharded full_energy (e rtol 1e-12, w
  1e-9, S(k) 1e-10 with atol 1e-12, JAX's tolerances): SPC/E-9, whose 27
  atoms are no multiple of row_block x shards, LJ-27 without charges, and
  the ragged SPC/E + one-site CH4 mixture;
* MonteCarlo(tp_mesh=...) run_block(2): drift below 1e-10 and the sweeps
  of the unsharded driver bit for bit;
* the three Philox-scored ops' plain versions (sweep_plain with exchange
  attempts, sweep_gibbs_plain, flip_plain) with chain0 on a row slice
  equal those rows of the whole call, and differ with chain0 = 0;
* every ensemble driver on 4 ranks x 4 chains (a sharded init, then
  sharded_call on its closures) equals its unsharded run bit for bit in
  every state field, TMMC's cmat and uhist rows and the Widom values:
  muVT on every route and with an activity ladder, TMMC, molecular,
  monatomic and NPT-binary Gibbs with volume moves, semigrand, binary
  muVT, the osmotic ensemble, monatomic muVT and MonteCarlo.widom (the
  counterpart of __graft_entry__.py's shard_map of the ensembles); the N
  histogram pooled by pooled_histogram equals the unsharded one, and
  every rank keyed as the first shard (c0 = 0) differs;
* utils/shard.py's draws and row slices against the plain draws.

One world per size (a 4-rank spawn takes ~4 s here), each rank on one
thread; the JAX side runs in this process on conftest's 8 virtual
devices.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks

import chip_smoke
from metropolismontecarlo_tpu.models.monatomic import lj_system as lj_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import System as SystemJ
from metropolismontecarlo_tpu.models.water import spce_system as spce_j
from metropolismontecarlo_tpu.parallel.tp import make_mesh_2d as mesh_2d_j
from metropolismontecarlo_tpu.parallel.tp import tp_full_energy_fn as tp_j
from metropolismontecarlo_tpu_torch.parallel import mesh as pm
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    random_quaternion,
    shoemake_quaternion,
)
from metropolismontecarlo_tpu_torch.parallel.remc import exchange
from metropolismontecarlo_tpu_torch.utils import shard

STATE_FIELDS = ("com", "quat", "coords", "box", "sfac", "energy", "virial",
                "temp", "step", "dr_max", "dphi_max", "dv_max", "acc", "att")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world4():
    return pm.run_world(ranks.world4, 4, device="cpu", threads=1,
                        timeout=300)


@pytest.fixture(scope="module")
def world8():
    return pm.run_world(ranks.world8, 8, device="cpu", threads=1,
                        timeout=300)


def _assert_states_equal(out, ref, fields=STATE_FIELDS):
    for f in fields:
        a, b = getattr(out, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f"{f} differs"


@pytest.mark.parametrize("route", list(ranks.ROUTES))
def test_sharded_run_steps_matches_unsharded(world4, route):
    kernel, dtype = ranks.ROUTES[route]
    mc, state = ranks.water_mc(ranks.N_CHAINS, kernel=kernel, dtype=dtype)
    assert mc.route == route
    ref = mc.run_steps(state, 2)
    _assert_states_equal(world4[0][f"run {route}"], ref)
    assert int(ref.acc.sum()) > 0


def test_sharded_init_matches_unsharded(world4):
    _, ref = ranks.water_mc(ranks.N_CHAINS)
    _assert_states_equal(world4[0]["init"], ref)


def test_sharded_npt_matches_unsharded(world4):
    mc, state = ranks.npt_mc(ranks.N_CHAINS)
    ref = mc.run_steps(state, 2)
    assert int(ref.att[:, 2].sum()) == ranks.N_CHAINS
    _assert_states_equal(world4[0]["npt"], ref)


def test_sharded_remc_matches_unsharded(world4):
    mc, state = ranks.water_mc(ranks.N_CHAINS, seed=2)
    ref, gen, fracs = ranks.with_ladder(state), \
        torch.Generator().manual_seed(ranks.REMC_SEED), []
    for r in range(2):
        ref = mc.run_steps(ref, 2)
        ref, frac = exchange(ref, gen, r % 2)
        fracs.append(frac)
    out, out_fracs = world4[0]["remc"]
    _assert_states_equal(out, ref)
    assert torch.equal(out_fracs, torch.stack(fracs))
    assert bool((out_fracs > 0.0).all())
    # every rank returns the same global fractions
    for r in range(1, 4):
        assert torch.equal(world4[r], out_fracs)


def test_exchange_shardlocal_matches_exchange(world4):
    swept, (out, out_fracs) = world4[0]["run plain"], world4[0]["exchange"]
    ref, gen, fracs = ranks.with_ladder(swept), \
        torch.Generator().manual_seed(11), []
    for phase in (0, 1):
        ref, frac = exchange(ref, gen, phase)
        fracs.append(frac)
    _assert_states_equal(out, ref)
    assert torch.equal(out_fracs, torch.stack(fracs))


def test_pooled_mean_and_backend_check(world4):
    mean, ref = world4[0]["pooled mean"]
    torch.testing.assert_close(mean, ref, rtol=1e-13, atol=0.0)
    acc = world4[0]["run plain"].acc.double().mean(0)
    torch.testing.assert_close(world4[0]["pooled acc"], acc, rtol=1e-13,
                               atol=0.0)
    assert "the world runs gloo but the mesh asks for nccl" \
        in world4[0]["backend refused"]


def _system_j(name, system):
    if name == "spce9":
        return spce_j(9)
    if name == "lj27":
        return lj_j(27)
    return SystemJ(**{f.name: getattr(system, f.name)
                      for f in dataclasses.fields(system)})


@pytest.mark.parametrize("name", list(ranks.TP_MESHES))
def test_tp_full_energy_matches_jax_and_unsharded(world8, name):
    mc, state = ranks.tp_case(name)
    out = world8[0][name]
    # the port's unsharded recompute (the dense route at this size)
    e_ref, w_ref, s_ref = mc.full_energy(state)
    # the JAX package's tensor-parallel recompute on its own 2-D mesh
    params_j = RunParamsJ(**(ranks.LJ if name == "lj27" else ranks.WATER))
    fn = tp_j(_system_j(name, mc.system), params_j,
              mesh_2d_j(*ranks.TP_MESHES[name]), mc.kvecs, mc.kweights,
              recompute_chunk=1, row_block=8)
    e_j, w_j, s_j = (np.asarray(x) for x in fn(
        jnp.asarray(state.coords.numpy()), jnp.asarray(state.com.numpy()),
        jnp.asarray(state.box.numpy())))
    for e, w, s in ((e_ref.numpy(), w_ref.numpy(), s_ref.numpy()),
                    (e_j, w_j, s_j)):
        np.testing.assert_allclose(out.energy.numpy(), e, rtol=1e-12)
        np.testing.assert_allclose(out.virial.numpy(), w, rtol=1e-9)
        if mc.params.coulomb == "ewald":
            np.testing.assert_allclose(out.sfac.numpy(), s, rtol=1e-10,
                                       atol=1e-12)


def test_driver_tp_mesh_run_block(world8):
    out, drift = world8[0]["driver"]
    assert drift < 1e-10
    assert all(d < 1e-10 for d in world8[1:])
    mc, state = ranks.water_mc(4)
    ref, _ = mc.run_block(state, 2)
    _assert_states_equal(out, ref, ("com", "quat", "coords", "box", "temp",
                                    "step", "acc", "att"))
    torch.testing.assert_close(out.energy, ref.energy, rtol=1e-12, atol=0.0)
    torch.testing.assert_close(out.sfac, ref.sfac, rtol=1e-10, atol=1e-12)


def test_rand_chains_rows_of_the_global_draw():
    g = torch.Generator().manual_seed(4)
    full = torch.rand((10, 3, 2), generator=g)
    g.manual_seed(4)
    with shard.shard_context(6, 10):
        assert shard.chain_offset() == 6
        part = shard.rand_chains((4, 3, 2), g)
        with pytest.raises(ValueError, match="exceed"):
            shard.rand_chains((5, 3, 2), g)
    assert torch.equal(part, full[6:])
    assert shard.current_shard() is None and shard.chain_offset() == 0
    with pytest.raises(ValueError, match="outside"):
        with shard.shard_context(10, 10):
            pass
    # the normal-draw twin, the chain-global quaternion and the
    # box-folded draw: rows of the global draw, the plain draw unsharded
    full = torch.randn((10, 3), generator=g.manual_seed(4))
    with shard.shard_context(6, 10):
        part = shard.randn_chains((4, 3), g.manual_seed(4))
        quat = random_quaternion(g.manual_seed(4), (4, 5), torch.float64)
        fold = shard.rand_chains((8, 5, 3), g.manual_seed(4), fold=2)
    assert torch.equal(part, full[6:])
    assert torch.equal(shard.randn_chains((10, 3), g.manual_seed(4)), full)
    q_full = random_quaternion(g.manual_seed(4), (10, 5), torch.float64)
    assert torch.equal(q_full, shoemake_quaternion(torch.rand(
        (10, 5, 3), generator=g.manual_seed(4), dtype=torch.float64)))
    assert torch.equal(quat, q_full[6:])
    folded = torch.rand((20, 5, 3), generator=g.manual_seed(4))
    assert torch.equal(shard.rand_chains((20, 5, 3), g.manual_seed(4),
                                         fold=2), folded)
    assert torch.equal(fold, folded[12:])
    # the row slice of a per-chain input of the global length
    ladder = torch.arange(10.0)
    with shard.shard_context(6, 10):
        assert torch.equal(shard.chain_rows(ladder, 4), ladder[6:])
        assert torch.equal(shard.chain_rows(ladder[6:], 4), ladder[6:])
        with pytest.raises(ValueError, match="n_chains entries"):
            shard.chain_rows(ladder[:5], 4)
    assert torch.equal(shard.chain_rows(ladder, 10), ladder)
    with pytest.raises(ValueError, match="n_chains entries"):
        shard.chain_rows(ladder, 4)
    assert torch.equal(shard.chain_rows(torch.tensor(2.0), 3),
                       torch.full((3,), 2.0))


@pytest.mark.parametrize("kind", chip_smoke.OFFSET_KINDS)
def test_chain0_twins_on_row_slices(kind):
    """The plain version with chain0 = c0 on rows [c0, c0 + L) equals
    those rows of the whole call; with chain0 = 0 the slice draws other
    Philox scores and ends elsewhere (the fault a sharded run showed
    before the kernels took chain0)."""
    call, _ = chip_smoke.offset_case("cpu", kind, chains=8)
    c0, L = 4, 4
    full = call(slice(0, 8), 0)
    part = call(slice(c0, c0 + L), c0)
    unkeyed = call(slice(c0, c0 + L), 0)
    assert all(torch.equal(f[c0:c0 + L], p) for f, p in zip(full, part))
    assert not all(torch.equal(u, p) for u, p in zip(unkeyed, part))


# the cases with volume moves: their att / acc column
VOLUME_COLUMN = {"gibbs full pv0.5": 2, "gibbs plain pv0.5 widom": 2,
                 "npt-gibbs full": 2, "lj gibbs plain widom": 1}


@pytest.mark.parametrize("name", list(ranks.ENSEMBLES))
def test_sharded_ensemble_matches_unsharded(world4, name):
    """4 ranks x 4 chains of an ensemble, init and run sharded, against
    the unsharded run of 16 chains (a fresh object, the same seed)."""
    ref = ranks.run_ensemble(name, ranks.N_CHAINS)
    out = world4[0][f"ens {name}"]
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert torch.equal(out[k], v), f"{k} differs"
    if "att" in ref:
        # the run moved: moves accepted on every shard
        assert bool((ref["acc"].reshape(4, -1).sum(1) > 0).all())
    if name in VOLUME_COLUMN:
        # every chain attempted volume moves, and some were accepted
        col = VOLUME_COLUMN[name]
        assert bool((ref["att"][:, col] > 0).all())
        assert int(ref["acc"][:, col].sum()) > 0
    if name.startswith(("muvt", "tmmc")):
        assert int(ref["acc"][:, 2:].sum()) > 0       # exchanges landed


def test_pooled_n_histogram_matches_unsharded(world4):
    ref = ranks.run_ensemble("muvt plain", ranks.N_CHAINS)
    want = torch.bincount(ref["active"].sum(1), minlength=9)
    assert torch.equal(world4[0]["n hist"], want)
    assert int((want > 0).sum()) > 1


def test_unkeyed_shards_differ_from_unsharded(world4):
    """The negative control: plain muVT with every rank keyed as the
    first shard (chain offset 0) draws the first shard's numbers on every
    rank, the fault this layer repairs."""
    ref = ranks.run_ensemble("muvt plain", ranks.N_CHAINS)
    out = world4[0]["ens unkeyed"]
    assert all(torch.equal(out[k][:4], ref[k][:4]) for k in ref)
    assert not all(torch.equal(out[k], ref[k]) for k in ref)
