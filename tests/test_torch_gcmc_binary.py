"""The port's binary muVT ensemble (mc/gcmc_binary.py) on the CPU, against
the JAX package.

* full_energy against JAX's in float64 (1e-10 relative), and against the
  port's energy_breakdown with every slot of both species active (Ewald
  SPC/E blocks; the ragged one-site LJ + triatomic blocks).
* The plain route in float64 through its draw seam: the port's step fed
  the draws that the JAX step takes from its keys (reproduced with
  jax.random), against the JAX step itself (reached through the closures
  of its run_steps): decisions equal, state and energies to 1e-9.
* mega="full" against JAX mega="interpret_full" and mega=True's sweep
  against JAX mega="interpret" (JAX's own cases): the interpreter's PRNG
  returns zeros, so the port gets zero uniforms (every exchange attempt an
  insertion at the origin).
* The ragged widths' drift through exchanges; the guards; the bridge round
  trip and binary_atom_ok.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gcmc_binary as gb_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    random_unit_vector,
)
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gcmc_binary as gb_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.polyatomic import lj_trimer_blocks
from metropolismontecarlo_tpu_torch.models.system import RunParams, System
from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from tests.test_gcmc_binary import water_two_blocks
from tests.test_gcmc_osmotic import lj_plus_trimer

F32, F64 = torch.float32, torch.float64
C = 3
WATER = dict(strict_min_image=False, temperature=600.0, r_cut=4.5,
             cutoff_mode="site", coulomb="ewald", use_lrc=False,
             p_translate=0.5, dr_max=1.0, dphi_max=0.8)
LJ = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.5, dr_max=0.4,
          dphi_max=0.8, use_lrc=True)
# (JAX system, port system, params, box, n_init, activities, p_exchange,
#  n_orient)
CASES = {
    "spce-ewald-orient3": (lambda: water_two_blocks(7, 7),
                           lambda: spce_two_blocks(7, 7), WATER, 10.0,
                           (3, 2), (2e-4, 3e-4), 0.5, 3),
    "lj-trimer-lrc": (lambda: lj_plus_trimer(24, 16),
                      lambda: lj_trimer_blocks(24, 16), LJ, 6.0, (10, 5),
                      (0.05, 0.02), 0.5, 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free(fn, name):
    """The value a (jitted) function's closure binds to `name`."""
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _to_port(st_j):
    return bridge.binary_gcmc_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _assert_states_close(st_t, st_j, rtol=1e-9, atol=1e-9):
    for f in ("active0", "active1", "acc", "att"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)),
                                      err_msg=f)
    for f in ("com", "quat", "coords", "box", "sfac", "energy"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


def _jax_draws(keys, n_or, ps):
    """The draws of JAX's step from each chain's key, as the port's draw
    lays them out (torch, float64)."""
    f64 = jnp.float64

    def quats(k, n, p):
        if p > 1:
            return random_quaternion(k, (n,), f64)
        return jnp.zeros((n, 4), f64).at[:, 0].set(1.0)

    def one(key):
        _, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_ip0, k_ip1, k_iq0, k_iq1, k_ds0,
         k_ds1, k_dq0, k_dq1, k_pk0, k_pk1, k_acc) = jax.random.split(k, 15)
        kax, kang = jax.random.split(k_rot)
        u = lambda kk, shape=(): jax.random.uniform(kk, shape, f64)  # noqa
        return dict(
            u_move=u(k_move), u_sel=u(k_sel), u_pos=u(k_pos, (3,)),
            axis=random_unit_vector(kax, (), dtype=f64), u_rot=u(kang),
            u_ins=jnp.stack([u(k_ip0, (3,)), u(k_ip1, (3,))]),
            quats_ins=jnp.stack([quats(k_iq0, n_or, ps[0]),
                                 quats(k_iq1, n_or, ps[1])]),
            u_del=jnp.stack([u(k_ds0), u(k_ds1)]),
            quats_del=jnp.stack([quats(k_dq0, n_or - 1, ps[0]),
                                 quats(k_dq1, n_or - 1, ps[1])]),
            u_pick=jnp.stack([u(k_pk0), u(k_pk1)]), u_acc=u(k_acc))

    return SimpleNamespace(**{k: torch.tensor(np.array(v)) for k, v in
                              jax.vmap(one)(keys).items()})


@pytest.mark.parametrize("name", list(CASES))
def test_plain_steps_and_full_energy_match_jax_f64(name):
    sys_j, sys_t, kw, box, n_init, zs, px, n_or = CASES[name]
    g_j = gb_j.BinaryGCMC(sys_j(), RunParamsJ(**kw), activities=zs,
                          p_exchange=px, n_orient=n_or)
    st_j = g_j.init(jax.random.PRNGKey(5), box=box, n_init=n_init,
                    n_chains=C)
    run_chain = _free(g_j.run_steps, "_run_chain")
    step_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_one_step")(
        c, None)[0]))
    g = gb_t.BinaryGCMC(sys_t(), RunParams(**kw), activities=zs,
                        p_exchange=px, n_orient=n_or, device="cpu")
    st = _to_port(st_j)
    _assert_states_close(st, st_j)          # full_energy: the same model
    carry = tuple(st_j)
    ps = [p for *_, p, _ in sys_t().species_slices]
    for _ in range(30):
        dr = _jax_draws(carry[8], n_or, ps)
        carry = step_j(*carry)
        st = g.run_steps.step(st, dr)
    st_j = gb_j.BinaryGCMCState(*carry)
    _assert_states_close(st, st_j, rtol=1e-9, atol=1e-8)
    acc = st.acc.sum(0).tolist()
    assert acc[0] + acc[1] > 0 and sum(acc[2:]) > 0, acc
    e_j, sf_j = g_j.full_energy(st_j)
    e, sf = g.full_energy(st)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-10)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_j), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("name,box", [("spce-ewald-orient3", 12.0),
                                      ("lj-trimer-lrc", 6.0)])
def test_full_energy_with_every_slot_active_is_the_model_energy(name, box):
    """All slots of both species active: the recompute equals
    models/energy.energy_breakdown of the two-block system, before and
    after a drift-gated block of moves and exchanges (ragged widths in the
    LJ case)."""
    _, sys_t, kw, _, _, zs, px, n_or = CASES[name]
    system, params = sys_t(), RunParams(**kw)
    caps = tuple(m1 - m0 for _, m0, m1, _, _ in system.species_slices)
    g = gb_t.BinaryGCMC(system, params, activities=zs, p_exchange=px,
                        n_orient=n_or, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    st = g.init(box=box, n_init=caps, n_chains=2)
    kv, kw_ = ewald_t.make_kvectors(params.nk, params.ksq_max) \
        if params.coulomb == "ewald" else (None, None)
    A = system.n_atoms
    want = energy_breakdown(system, params,
                            st.coords[:, :, :A].transpose(1, 2), st.com,
                            st.box, kv, kw_)["total"]
    np.testing.assert_allclose(st.energy.numpy(), want.numpy(), rtol=1e-10)
    st = g.init(box=box, n_init=(caps[0] // 2, caps[1] // 3), n_chains=4)
    st, stats = g.run_block(st, 150, drift_tol=1e-10)
    assert stats["sfac_err_max"] < 1e-9
    assert stats["acc_insert0"] + stats["acc_insert1"] \
        + stats["acc_delete0"] + stats["acc_delete1"] > 0.0


def _zero_draws(monkeypatch):
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))


KERNEL = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
              coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.25,
              dphi_max=0.3, use_lrc=False, strict_min_image=False)


def test_mega_full_matches_jax_interpret_full(monkeypatch):
    """Each species block's launch appends its own species' exchange
    attempts, the activity planes threaded between the two launches."""
    g_j = gb_j.BinaryGCMC(water_two_blocks(6, 6), RunParamsJ(**KERNEL),
                          activities=(2e-4, 3e-4), p_exchange=0.4,
                          dtype=jnp.float32, mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(0), box=10.0, n_init=(4, 4),
                    n_chains=2)
    _zero_draws(monkeypatch)
    g = gb_t.BinaryGCMC(spce_two_blocks(6, 6), RunParams(**KERNEL),
                        activities=(2e-4, 3e-4), p_exchange=0.4, dtype=F32,
                        mega="full", device="cpu")
    st = _to_port(st_j)
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 40)
    st2 = g.run_steps(st, 40)
    for f in ("active0", "active1", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    att = st2.att.numpy()
    assert att[:, 0].sum() > 0 and att[:, 2].sum() > 0 and att[:, 4].sum() > 0
    assert st2.acc.numpy()[:, [2, 4]].sum() > 0      # insertions landed
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    np.testing.assert_allclose(d_t, d_j, atol=2e-5 * np.abs(e0).max())
    ref = np.asarray(st_j2.sfac)
    np.testing.assert_allclose(st2.sfac.numpy(), ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(st2.coords.numpy(), np.asarray(st_j2.coords),
                               atol=1e-4)
    _, stats = g.run_block(st2, 0)
    assert stats["drift_max_rel"] < 2e-3 and stats["sfac_err_max"] < 1e-4


def test_mega_true_sweep_matches_jax_interpret(monkeypatch):
    """mega=True's kernel sweep (one launch per species block) against
    JAX's _sweep_state (the exchange steps that follow it are the plain
    route, held to JAX above)."""
    g_j = gb_j.BinaryGCMC(water_two_blocks(6, 6), RunParamsJ(**KERNEL),
                          activities=(2e-4, 2e-4), p_exchange=0.4,
                          dtype=jnp.float32, mega="interpret")
    st_j = g_j.init(jax.random.PRNGKey(0), box=10.0, n_init=(4, 4),
                    n_chains=2)
    _zero_draws(monkeypatch)
    g = gb_t.BinaryGCMC(spce_two_blocks(6, 6), RunParams(**KERNEL),
                        activities=(2e-4, 2e-4), p_exchange=0.4, dtype=F32,
                        mega=True, device="cpu")
    want = _free(g_j.run_steps, "_sweep_state")(st_j)
    got = g.run_steps.sweep(_to_port(st_j))
    for f in ("active0", "active1", "acc", "att"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.acc[:, :2].sum()) > 0
    for f in ("com", "quat", "coords"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=2e-5, atol=1e-2)
    ref = np.asarray(want.sfac)
    np.testing.assert_allclose(got.sfac.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-9),
                                            (True, F32, 2e-3),
                                            ("full", F32, 2e-3)])
def test_routes_keep_the_drift_and_sfac_gates(mega, dtype, tol):
    g = gb_t.BinaryGCMC(spce_two_blocks(6, 6), RunParams(**KERNEL),
                        activities=(2e-4, 3e-4), p_exchange=0.4, dtype=dtype,
                        mega=mega, device="cpu")
    st = g.init(box=10.0, n_init=(4, 3), n_chains=C)
    for _ in range(2):
        st, stats = g.run_block(st, 40, drift_tol=tol)
        assert stats["sfac_err_max"] < (1e-9 if dtype == F64 else 1e-4)
    assert int(st.att[:, 0].sum()) > 0 and int(st.att[:, 2:].sum()) > 0


def _charged_blocks():
    """Two SPC/E blocks, block B's oxygen at -0.5 e (not neutral)."""
    s = spce_two_blocks(4, 4)
    q = np.array(s.charges)
    q[4:, 0] = -0.5
    return System(n_mol=8, atoms_per_mol=3, body=s.body, masses=s.masses,
                  charges=q, type_ids=s.type_ids, eps_table=s.eps_table,
                  sig_table=s.sig_table, name="charged",
                  species=s.species)


@pytest.mark.parametrize("system,kw,args,match", [
    (lj_system(8), {}, {}, "two species"),
    (spce_two_blocks(4, 4), {}, dict(activities=(0.1,)), "pair"),
    (_charged_blocks(), {}, {}, "charge-neutral"),
    (_charged_blocks(), dict(coulomb="wolf", kappa_L=2.0),
     dict(mega="full", dtype=F32), "charge-neutral"),
    (spce_two_blocks(4, 4), {}, dict(mega=True, dtype=F64), "float32"),
    (spce_two_blocks(4, 4), {}, dict(mega="interpret", dtype=F32),
     "mega must be"),
    (spce_two_blocks(4, 4), {}, dict(mega="full", dtype=F32, n_orient=3),
     "unbiased"),
    (spce_two_blocks(4, 4), {}, dict(mega="full", dtype=F32,
                                     p_exchange=0.0), "p_exchange"),
    (spce_two_blocks(4, 4), {}, dict(mega=True, dtype=F32, p_exchange=1.0),
     "p_exchange"),
    (spce_two_blocks(4, 4), {}, dict(n_orient=0), "n_orient"),
])
def test_make_gcmc_binary_guards(system, kw, args, match):
    params = RunParams(**dict(KERNEL, **kw))
    args = dict(dict(activities=(0.1, 0.1)), **args)
    with pytest.raises(ValueError, match=match):
        gb_t.make_gcmc_binary(system, params, device="cpu", **args)


def test_init_guards_tail_and_device():
    # the LJ tail is supported: building succeeds, and the in-kernel cycle
    # carries it (own species on wc, the cross term folded into si)
    gb_t.BinaryGCMC(lj_trimer_blocks(8, 8), RunParams(**LJ), (0.1, 0.1),
                    dtype=F32, mega="full", device="cpu")
    g = gb_t.BinaryGCMC(spce_two_blocks(4, 4), RunParams(**KERNEL),
                        (1e-4, 1e-4), device="cpu")
    with pytest.raises(ValueError, match="exceeds capacities"):
        g.init(box=10.0, n_init=(5, 1), n_chains=2)
    g = gb_t.BinaryGCMC(spce_two_blocks(4, 4), RunParams(**dict(
        KERNEL, strict_min_image=True)), (1e-4, 1e-4), device="cpu")
    with pytest.raises(ValueError, match="minimum-image"):
        g.init(box=8.0, n_init=(2, 2), n_chains=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gb_t.BinaryGCMC(spce_two_blocks(4, 4), RunParams(**KERNEL),
                            (1e-4, 1e-4))


def test_binary_atom_ok_bridge_and_atom_mask():
    system = spce_two_blocks(5, 3)
    g = gb_t.BinaryGCMC(system, RunParams(**KERNEL), (1e-4, 1e-4),
                        device="cpu")
    st = g.init(box=10.0, n_init=(3, 2), n_chains=2)
    gen = torch.Generator().manual_seed(0)
    a0 = torch.rand((4, 2, 5), generator=gen) < 0.6
    a1 = torch.rand((4, 2, 3), generator=gen) < 0.6
    batched = gb_t.binary_atom_ok(system, a0, a1)            # (4, 2, A_pad)
    mol = np.array(system.mol_of_atom_padded)
    for c in range(4):
        for b in range(2):
            on = np.concatenate([a0[c, b].numpy(), a1[c, b].numpy()])
            ref = (mol >= 0) & on[np.clip(mol, 0, 7)]
            np.testing.assert_array_equal(batched[c, b].numpy(), ref)
    mask = g.atom_mask(st)
    assert mask.shape == (2, system.n_atoms_padded)
    assert int(mask.sum()) == 2 * (3 + 2) * 3
    arrays = bridge.binary_gcmc_state_to_numpy(st)
    back = bridge.binary_gcmc_state_from_numpy(arrays, "cpu")
    for f in arrays:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
