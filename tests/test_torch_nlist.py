"""Verlet neighbour lists in the port (mc/moves.py nlist_radius,
rebuild_nlist and pair_energy_nlist; the driver's per-sweep rebuild,
dr_max cap and overflow check) against the JAX package's, on the CPU.

* nlist_radius equals JAX's; rebuild_nlist equals JAX's as a set per row
  (torch.topk and lax.top_k may order ties differently) with the padding
  slots holding the molecule's own index, and the same `needed`, with a
  list wider and one narrower than the neighbourhood.
* The list route through the proposal seam, float64, on a ragged SPC/E +
  one-site CH4 system (both species blocks): JAX propose_full's
  proposals give the port's pair_energy_nlist the d_e of JAX's
  pair_energy_nlist (within 1e-10 relative) and of the port's dense
  pair_energy_rows (1e-9: the same pairs summed in another order), and
  finalize the same decisions and state (1e-10).
* MonteCarlo with lists (the "plain" route) follows the dense plain
  route's trajectory on one generator seed (decisions equal, COMs and
  energies within 1e-9) and drifts under 1e-10; its lists are
  (C, M, NB) and the bridge and checkpoints carry them at that shape.
* An nlist_width below the neighbourhood raises RuntimeError at the
  block's end; adaptation caps dr_max at nlist_skin / 2.
* A kernel route with lists raises JAX's message; muVT, binary muVT,
  semigrand and osmotic refuse nlist_width != 0 as JAX's do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gcmc_binary as gcmc_binary_j
from metropolismontecarlo_tpu.mc import gcmc_mol as gcmc_mol_j
from metropolismontecarlo_tpu.mc import gcmc_osmotic as gcmc_osmotic_j
from metropolismontecarlo_tpu.mc import moves as moves_j
from metropolismontecarlo_tpu.mc import semigrand as semigrand_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import System as SystemJ
from metropolismontecarlo_tpu.models.water import spce_system as spce_system_j
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.io.checkpoint import (
    load_state,
    save_state,
)
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import gcmc_binary, gcmc_mol
from metropolismontecarlo_tpu_torch.mc import gcmc_osmotic, semigrand
from metropolismontecarlo_tpu_torch.mc import moves
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    spce_methane_system,
    spce_system,
    spce_two_blocks,
)

KW = dict(temperature=300.0, r_cut=4.5, coulomb="ewald", nk=3, ksq_max=9,
          p_translate=0.5, dr_max=0.8, dphi_max=0.8, nlist_width=21,
          nlist_skin=1.0, strict_min_image=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free(fn, name):
    """A closure variable of fn (the JAX move builders keep propose_full,
    pair_energy_nlist and finalize as closures)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _systems(n_w=16, n_ch4=8):
    sys_t = spce_methane_system(n_w, n_ch4)
    return sys_t, SystemJ(**{f.name: getattr(sys_t, f.name)
                             for f in dataclasses.fields(sys_t)})


def _chains(system, C, box, seed):
    """C configurations on a jittered lattice, random orientations (f64
    numpy): com, quat, coords (C, 3, A_pad), atoms (C, A, 3)."""
    rng = np.random.default_rng(seed)
    M, A = system.n_mol, system.n_atoms
    com = cubic_lattice(M, box) + rng.uniform(-0.5, 0.5, (C, M, 3))
    q = rng.normal(size=(C, M, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    per_mol = com[:, :, None, :] + np.einsum("cmij,mpj->cmpi", rot,
                                             np.asarray(system.body))
    mol, slot = system.atom_mol_slot
    atoms = per_mol[:, mol, slot]
    coords = np.zeros((C, 3, system.n_atoms_padded))
    coords[:, :, :A] = atoms.transpose(0, 2, 1)
    return com, q, coords, atoms


# ---------------- the lists ------------------------------------------------


@pytest.mark.parametrize("width", [6, 22])
def test_rebuild_nlist_equals_jax_as_sets(width):
    sys_t, sys_j = _systems()
    params_t = RunParams(**dict(KW, nlist_width=width))
    params_j = RunParamsJ(**dict(KW, nlist_width=width))
    r_t = moves.nlist_radius(sys_t, params_t)
    assert r_t == moves_j.nlist_radius(sys_j, params_j)
    C, M, box = 5, sys_t.n_mol, 14.0
    com = _chains(sys_t, C, box, seed=width)[0]
    boxes = np.full(C, box) * np.linspace(0.97, 1.03, C)
    lists, needed = moves.rebuild_nlist(torch.tensor(com),
                                        torch.tensor(boxes), params_t, r_t,
                                        chunk=2)
    lists_j, needed_j = moves_j.rebuild_nlist(jnp.asarray(com),
                                              jnp.asarray(boxes), params_j,
                                              r_t)
    assert lists.shape == (C, M, width) and lists.dtype == torch.int32
    np.testing.assert_array_equal(needed.numpy(), np.asarray(needed_j))
    lists_j = np.asarray(lists_j)
    for c in range(C):
        for m in range(M):
            assert set(lists[c, m].tolist()) == set(lists_j[c, m].tolist())
    # the slots past a row's neighbours hold the molecule itself
    listed = (lists != torch.arange(M, dtype=torch.int32)[None, :, None])
    np.testing.assert_array_equal(listed.sum(-1).max(-1).values.numpy(),
                                  np.minimum(needed.numpy(), width))
    assert int(needed.min()) > 6 and int(needed.max()) < M - 1


# ---------------- the proposal seam ----------------------------------------


def test_list_route_matches_jax_and_the_dense_route_on_jax_proposals():
    C, box = 6, 14.0
    sys_t, sys_j = _systems()
    params_t, params_d = RunParams(**KW), RunParams(**dict(KW,
                                                           nlist_width=0))
    kv, kwt = make_kvectors(3, 9)
    com, quat, coords, atoms = _chains(sys_t, C, box, seed=7)
    boxes = np.full(C, box)
    nbr, needed = moves.rebuild_nlist(
        torch.tensor(com), torch.tensor(boxes), params_t,
        moves.nlist_radius(sys_t, params_t))
    assert int(needed.max()) <= KW["nlist_width"]
    sfac = energy_breakdown(sys_t, params_t, torch.tensor(atoms),
                            torch.tensor(com), torch.tensor(boxes), kv,
                            kwt)["sfac"].numpy()
    energy, temp = np.full(C, -300.0), np.full(C, KW["temperature"])
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    decisions = set()
    for sl in sys_t.species_slices:
        body_j = moves_j.make_sweep_fn(sys_j, RunParamsJ(**KW), kv, kwt,
                                       dtype=jnp.float64, species=sl)
        move_j = _free(body_j, "vmove").__wrapped__
        propose = jax.vmap(_free(move_j, "propose_full"),
                           in_axes=(0,) * 7 + (None, None))
        pair_nlist = jax.vmap(_free(move_j, "pair_energy_nlist"),
                              in_axes=(0, 0, 0, None, 0, 0))
        finalize = jax.vmap(_free(move_j, "finalize"),
                            in_axes=(0,) * 10 + (None,))
        body_t = moves.make_sweep_fn(sys_t, params_t, kv, kwt, "cpu",
                                     torch.float64, species=sl)
        body_d = moves.make_sweep_fn(sys_t, params_d, kv, kwt, "cpu",
                                     torch.float64, species=sl)
        assert body_t.use_nlist and not body_d.use_nlist
        for m in (sl[1], sl[2] - 1):
            j = [jnp.asarray(x) for x in (com, quat, coords, boxes)]
            pr = propose(*j, keys, jnp.full(C, 0.8), jnp.full(C, 0.8), m, 5)
            ra2p = jnp.concatenate([pr["ra_old"], pr["ra_new"]], axis=1)
            kappa = params_t.kappa_L / j[3]
            nbr_m = nbr[:, m]
            de_j, ovr_j = pair_nlist(ra2p, jnp.asarray(nbr_m.numpy()), j[2],
                                     m, j[3], kappa)
            ref = finalize(*j, jnp.asarray(sfac), jnp.asarray(energy),
                           jnp.asarray(temp), pr, de_j, ovr_j, m)

            pr_t = {k: torch.tensor(np.asarray(v)) for k, v in pr.items()
                    if k != "k_acc"}
            pr_t["u_acc"] = torch.tensor(np.asarray(jax.vmap(
                lambda k: jax.random.uniform(k, dtype=jnp.float64))(
                    pr["k_acc"])))
            t = [torch.tensor(x) for x in (com, quat, coords, boxes)]
            ra2p_t = torch.cat([pr_t["ra_old"], pr_t["ra_new"]], 1)
            de_t, ovr_t = body_t.pair_energy_nlist(
                ra2p_t, nbr_m, t[2], m, t[3], params_t.kappa_L / t[3])
            de_d, ovr_d = body_d.pair_energy_rows(
                ra2p_t, pr_t["com_m"], pr_t["com_new"], t[0], t[2], m, t[3],
                params_t.kappa_L / t[3])
            np.testing.assert_allclose(de_t.numpy(), np.asarray(de_j),
                                       rtol=1e-10, atol=1e-9)
            np.testing.assert_allclose(de_t.numpy(), de_d.numpy(),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_array_equal(ovr_t.numpy(), np.asarray(ovr_j))
            np.testing.assert_array_equal(ovr_t.numpy(), ovr_d.numpy())
            out = body_t.finalize(*t, torch.tensor(sfac),
                                  torch.tensor(energy), torch.tensor(temp),
                                  pr_t, de_t, ovr_t, m)
            for name, o, r in zip(("com", "quat", "coords", "sfac",
                                   "energy", "is_trans", "accept"), out,
                                  ref):
                if o.dtype == torch.bool:
                    np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                                  err_msg=name)
                else:
                    np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                               rtol=1e-10, atol=1e-10,
                                               err_msg=name)
            decisions |= set(out[6].tolist())
    assert decisions == {True, False}


# ---------------- the driver -----------------------------------------------


def _mc(width, **kw):
    sys_t, _ = _systems()
    params = RunParams(**dict(KW, nlist_width=width, **kw))
    return MonteCarlo(sys_t, params, device="cpu", dtype=torch.float64,
                      generator=torch.Generator().manual_seed(5),
                      kernel="plain" if width == 0 else "auto")


def test_list_route_follows_the_dense_plain_route(tmp_path):
    runs = {}
    for width in (KW["nlist_width"], 0):
        mc = _mc(width)
        assert mc.route == "plain"
        state = mc.init_state(cubic_lattice(24, 14.0), box=14.0,
                              n_chains=4)
        runs[width] = mc.run_block(state, 4)
    (s_l, m_l), (s_d, m_d) = runs[KW["nlist_width"]], runs[0]
    np.testing.assert_array_equal(s_l.acc.numpy(), s_d.acc.numpy())
    np.testing.assert_allclose(s_l.com.numpy(), s_d.com.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(s_l.energy.numpy(), s_d.energy.numpy(),
                               rtol=1e-9)
    assert m_l["drift_max_rel"] < 1e-10 and 0.05 < m_l["acc_trans"] < 0.95
    assert s_l.nbr.shape == (4, 24, 21) and s_d.nbr.shape == (4, 1, 1)
    assert 0 < int(s_l.nbr_needed.max()) <= 21
    # the bridge and the checkpoints carry the lists at their shape
    back = bridge.state_from_numpy(bridge.state_to_numpy(s_l), "cpu")
    assert torch.equal(back.nbr, s_l.nbr)
    save_state(tmp_path / "ck.npz", s_l)
    loaded, _, _ = load_state(tmp_path / "ck.npz", "cpu")
    assert torch.equal(loaded.nbr, s_l.nbr)
    assert torch.equal(loaded.nbr_needed, s_l.nbr_needed)


def test_overflow_raises_and_adjust_caps_dr_max():
    mc = _mc(2)
    state = mc.init_state(cubic_lattice(24, 14.0), box=14.0, n_chains=2)
    with pytest.raises(RuntimeError, match="neighbor-list overflow"):
        mc.run_block(state, 1)
    mc = _mc(23, dr_max=4.0, nlist_skin=1.0)
    state = mc.init_state(cubic_lattice(24, 14.0), box=14.0, n_chains=2)
    state, m = mc.run_block(state, 2, adjust=True)
    assert float(state.dr_max.max()) <= 0.5 and m["dr_max_mean"] <= 0.5


def test_kernel_routes_and_ensembles_refuse_lists():
    sys_t, sys_j = _systems()
    params = RunParams(**KW)
    for kernel in ("sweep", "move"):
        with pytest.raises(ValueError, match="jnp move path"):
            MonteCarlo(sys_t, params, device="cpu", kernel=kernel)
    two_t = spce_two_blocks(6, 6)
    two_j = SystemJ(**{f.name: getattr(two_t, f.name)
                       for f in dataclasses.fields(two_t)})
    params_j = RunParamsJ(**KW)
    for port, jax_fn, system, sys_jx, args in (
            (gcmc_mol.make_gcmc_mol, gcmc_mol_j.make_gcmc_mol,
             spce_system(6), spce_system_j(6), (1e-3,)),
            (gcmc_binary.make_gcmc_binary, gcmc_binary_j.make_gcmc_binary,
             two_t, two_j, ((1e-3, 1e-3),)),
            (semigrand.make_semigrand, semigrand_j.make_semigrand, two_t,
             two_j, (2.0,)),
            (gcmc_osmotic.make_gcmc_osmotic,
             gcmc_osmotic_j.make_gcmc_osmotic, sys_t, sys_j, (1e-3,))):
        with pytest.raises(ValueError, match="neighbor lists"):
            port(system, params, *args, device="cpu")
        with pytest.raises(ValueError, match="neighbor lists"):
            jax_fn(sys_jx, params_j, *args)
