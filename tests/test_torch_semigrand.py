"""The port's semigrand ensemble (mc/semigrand.py) on the CPU, against the
JAX package.

* full_energy against JAX's in float64 (1e-10 relative), also on states
  that flips left with stale inactive columns, and against the port's
  energy_breakdown with every slot active.
* The plain route in float64 through its draw seam: the port's step fed
  the draws that the JAX step takes from its keys (reproduced with
  jax.random), against the JAX step itself (reached through the closures
  of its run_steps): decisions equal, state and energies to 1e-9; n_orient
  4 on identical SPC/E blocks, n_orient 1 on the ragged LJ blocks with the
  tail, flips in both directions.
* mega="full" against JAX mega="interpret_full" and mega=True's sweep
  against JAX mega="interpret" (JAX's own cases): the interpreter's PRNG
  returns zeros, so the port gets zero uniforms and all-equal pick scores;
  equal decisions, energies within 2e-5 of the term magnitudes, the drift
  gate 2e-3, the S(k) gate 1e-4, N_tot conserved.
* The ideal Binomial composition; the guards; the bridge round trip.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import semigrand as sg_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.quaternions import (
    random_quaternion,
    random_unit_vector,
)
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc import semigrand as sg_t
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.polyatomic import lj_trimer_blocks
from metropolismontecarlo_tpu_torch.models.system import RunParams, System
from metropolismontecarlo_tpu_torch.models.water import (
    spce_system,
    spce_two_blocks,
)
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as flip_op
from tests.test_semigrand import two_block_lj, water_two_blocks

F32, F64 = torch.float32, torch.float64
C = 3
WATER = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.3,
             dphi_max=0.3, use_lrc=False, strict_min_image=False)
LJ = dict(strict_min_image=False, temperature=2.0, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.5, dr_max=0.3,
          dphi_max=0.5, use_lrc=True)
# (JAX system, port system, params, box, (n_a, n_b), xi)
CASES = {
    "spce-ewald": (lambda: water_two_blocks(8, 8),
                   lambda: spce_two_blocks(8, 8), WATER, 10.0, (5, 3), 2.0),
    "spce-wolf_ref": (lambda: water_two_blocks(8, 8),
                      lambda: spce_two_blocks(8, 8),
                      dict(WATER, coulomb="wolf", wolf_style="ref",
                           kappa_L=2.0), 10.0, (5, 3), 2.0),
    "lj-trimer-lrc": (lambda: two_block_lj(8, 8, eps_a=1.0, eps_b=0.6),
                      lambda: lj_trimer_blocks(8, 8, eps_a=1.0, eps_b=0.6),
                      LJ, 5.0, (4, 3), 1.5),
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
    return bridge.semigrand_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _assert_states_close(st_t, st_j, rtol=1e-9, atol=1e-9):
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)),
                                      err_msg=f)
    for f in ("com", "quat", "coords", "box", "sfac", "energy"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


# ---------------- full_energy ---------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_full_energy_matches_jax_f64(name):
    sys_j, sys_t, kw, box, (n_a, n_b), xi = CASES[name]
    g_j = sg_j.Semigrand(sys_j(), RunParamsJ(**kw), fugacity_ratio=xi)
    st_j = g_j.init(jax.random.PRNGKey(1), box=box, n_a=n_a, n_b=n_b,
                    n_chains=C)
    g = sg_t.Semigrand(sys_t(), RunParams(**kw), fugacity_ratio=xi,
                       device="cpu")
    e, sf = g.full_energy(_to_port(st_j))
    np.testing.assert_allclose(e.numpy(), np.asarray(st_j.energy),
                               rtol=1e-10)
    np.testing.assert_allclose(sf.numpy(), np.asarray(st_j.sfac), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("name", ["spce-ewald", "lj-trimer-lrc"])
def test_full_energy_with_every_slot_active_is_the_model_energy(name):
    """All slots of both blocks active on one lattice: the recompute is
    models/energy.energy_breakdown of the two-block system (LJ, tail,
    Ewald real, reciprocal, self and intra terms)."""
    _, sys_t, kw, box, _, xi = CASES[name]
    system, params = sys_t(), RunParams(**kw)
    g = sg_t.Semigrand(system, params, fugacity_ratio=xi, device="cpu")
    st = g.init(box=box, n_a=4, n_b=3, n_chains=2)
    from metropolismontecarlo_tpu_torch.mc.gcmc_binary import (
        make_binary_slots,
    )
    ms = make_binary_slots(system, params, "cpu", F64, neutral=False)
    com, quat, coords = ms.pose_lattice_init(torch.Generator(), box, 2)
    st = sg_t.SemigrandState(**{**st.__dict__, "com": com, "quat": quat,
                                "coords": coords,
                                "active": torch.ones_like(st.active)})
    e, _ = g.full_energy(st)
    kv, kw_ = ewald_t.make_kvectors(params.nk, params.ksq_max) \
        if params.coulomb == "ewald" else (None, None)
    A = system.n_atoms
    want = energy_breakdown(system, params, coords[:, :, :A].transpose(1, 2),
                            com, st.box, kv, kw_)["total"]
    np.testing.assert_allclose(e.numpy(), want.numpy(), rtol=1e-10)


# ---------------- the plain route, float64, through the draw seam -------


def _jax_draws(keys, n_or, multi_site):
    """The draws of JAX's step from each chain's key, as the port's draw
    lays them out (torch, float64)."""
    f64 = jnp.float64

    def quats(k, n):
        if multi_site:
            return random_quaternion(k, (n,), f64)
        return jnp.zeros((n, 4), f64).at[:, 0].set(1.0)

    def one(key):
        _, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_newq, k_oldq, k_pick,
         k_acc) = jax.random.split(k, 8)
        kax, kang = jax.random.split(k_rot)
        return dict(
            u_move=jax.random.uniform(k_move, dtype=f64),
            u_sel=jax.random.uniform(k_sel, dtype=f64),
            u_pos=jax.random.uniform(k_pos, (3,), f64),
            axis=random_unit_vector(kax, (), dtype=f64),
            u_rot=jax.random.uniform(kang, (), dtype=f64),
            quats_new=quats(k_newq, n_or), quats_old=quats(k_oldq, n_or - 1),
            u_pick=jax.random.uniform(k_pick, dtype=f64),
            u_acc=jax.random.uniform(k_acc, dtype=f64))

    return SimpleNamespace(**{k: torch.tensor(np.array(v)) for k, v in
                              jax.vmap(one)(keys).items()})


@pytest.mark.parametrize("name,n_or", [("spce-ewald", 4),
                                       ("lj-trimer-lrc", 1)])
def test_plain_steps_match_jax_f64(name, n_or):
    sys_j, sys_t, kw, box, (n_a, n_b), xi = CASES[name]
    g_j = sg_j.Semigrand(sys_j(), RunParamsJ(**kw), fugacity_ratio=xi,
                         p_flip=0.5, n_orient=n_or)
    st_j = g_j.init(jax.random.PRNGKey(5), box=box, n_a=n_a, n_b=n_b,
                    n_chains=C)
    run_chain = _free(g_j.run_steps, "_run_chain")
    step_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_one_step")(
        c, None)[0]))
    g = sg_t.Semigrand(sys_t(), RunParams(**kw), fugacity_ratio=xi,
                       p_flip=0.5, n_orient=n_or, device="cpu")
    st = _to_port(st_j)
    _assert_states_close(st, st_j)
    carry = tuple(st_j)
    multi = max(p for *_, p, _ in sys_t().species_slices) > 1
    for _ in range(30):
        dr = _jax_draws(carry[7], n_or, multi)
        carry = step_j(*carry)
        st = g.run_steps.step(st, dr)
    st_j = sg_j.SemigrandState(*carry)
    _assert_states_close(st, st_j, rtol=1e-9, atol=1e-8)
    acc = st.acc.sum(0).tolist()
    assert acc[2] > 0 and acc[3] > 0 and acc[0] + acc[1] > 0, acc
    # the recompute after flips left stale inactive columns
    e_j, sf_j = g_j.full_energy(st_j)
    e, sf = g.full_energy(st)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-10)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_j), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(st.energy.numpy(), e.numpy(), rtol=1e-9)


# ---------------- the kernel routes against the TPU interpreter ---------


def _zero_draws(monkeypatch, mags):
    """Zero uniforms for every kernel route, and the flip op as the JAX
    interpreter runs it: the plain twin with all-equal pick scores."""
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))

    def op(*a, **k):
        k.pop("seed", None)
        n_c, m = a[1].shape[:2]
        out = flip_op.flip_plain(
            *a, magnitude=True,
            scores=torch.zeros((n_c, a[8].shape[1], m)), **k)
        mags.append(out[4][:, flip_op.N_STATS])
        return out[:4] + (out[4][:, :flip_op.N_STATS],) + out[5:]

    monkeypatch.setattr(moves_t.flip_op, "flip", op)


FULL_CASES = {
    "spce-ewald": (lambda: water_two_blocks(8, 8),
                   lambda: spce_two_blocks(8, 8), WATER, 10.0, (5, 3), 2.0,
                   2, 44),
    "lj-trimer-ragged": (lambda: two_block_lj(24, 24, eps_a=1.0, eps_b=0.6),
                         lambda: lj_trimer_blocks(24, 24, eps_a=1.0,
                                                  eps_b=0.6),
                         dict(LJ, use_lrc=False), 9.0, (12, 8), 1.5, 4, 60),
}


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_mega_full_matches_jax_interpret_full(name, monkeypatch):
    sys_j, sys_t, kw, box, (n_a, n_b), xi, n_c, n_steps = FULL_CASES[name]
    g_j = sg_j.Semigrand(sys_j(), RunParamsJ(**kw), fugacity_ratio=xi,
                         dtype=jnp.float32, mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(2), box=box, n_a=n_a, n_b=n_b,
                    n_chains=n_c)
    mags = []
    _zero_draws(monkeypatch, mags)
    g = sg_t.Semigrand(sys_t(), RunParams(**kw), fugacity_ratio=xi,
                       dtype=F32, mega="full", device="cpu")
    st = _to_port(st_j)
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, n_steps)
    st2 = g.run_steps(st, n_steps)
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    assert int(st2.acc[:, 2:].sum()) > 0            # flips were accepted
    mag = torch.stack(mags).sum(0).numpy()
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    # the sweeps' energy terms are of the flips' order at these sizes
    scale = np.maximum(mag, np.abs(e0))
    assert (np.abs(d_t - d_j) <= 2e-5 * scale).all(), (d_t - d_j, scale)
    ref = np.asarray(st_j2.sfac)
    np.testing.assert_allclose(st2.sfac.numpy(), ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    on = np.asarray(st_j2.active)
    np.testing.assert_allclose(st2.com.numpy()[on],
                               np.asarray(st_j2.com)[on], atol=1e-5)
    np.testing.assert_allclose(st2.coords.numpy(), np.asarray(st_j2.coords),
                               atol=1e-4)
    # the port's own recompute agrees with what it carried; N conserved
    _, stats = g.run_block(st2, 0)
    assert stats["drift_max_rel"] < 2e-3 and stats["sfac_err_max"] < 1e-4
    assert (st2.active.sum(1) == n_a + n_b).all()


def test_mega_true_sweep_matches_jax_interpret(monkeypatch):
    """mega=True's kernel sweep (one launch per species block) against
    JAX's _sweep_state (the flip steps that follow it are the plain route,
    held to JAX by test_plain_steps_match_jax_f64)."""
    sys_j, sys_t, kw, box, (n_a, n_b), xi = CASES["spce-ewald"]
    g_j = sg_j.Semigrand(sys_j(), RunParamsJ(**kw), fugacity_ratio=xi,
                         dtype=jnp.float32, mega="interpret")
    st_j = g_j.init(jax.random.PRNGKey(2), box=box, n_a=n_a, n_b=n_b,
                    n_chains=2)
    _zero_draws(monkeypatch, [])
    g = sg_t.Semigrand(sys_t(), RunParams(**kw), fugacity_ratio=xi,
                       dtype=F32, mega=True, device="cpu")
    want = _free(g_j.run_steps, "_sweep_state")(st_j)
    got = g.run_steps.sweep(_to_port(st_j))
    for f in ("active", "acc", "att"):
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


# ---------------- closed form, guards, bridge ----------------------------


def test_ideal_species_flip_to_the_binomial():
    """Non-interacting species, xi = 3: each of the N molecules is B with
    probability 3/4, N_B ~ Binomial(N, 3/4); N conserved."""
    n_tot, xi = 12, 3.0
    g = sg_t.Semigrand(lj_trimer_blocks(12, 12, 0.0, 0.0, 0.0),
                       RunParams(**dict(LJ, use_lrc=False, r_cut=2.0)),
                       fugacity_ratio=xi, p_flip=0.6, device="cpu",
                       generator=torch.Generator().manual_seed(7))
    st = g.init(box=6.0, n_a=6, n_b=6, n_chains=256)
    st, _ = g.run_block(st, 80)
    means, varis = [], []
    for _ in range(5):
        st, stats = g.run_block(st, 40, drift_tol=1e-10)
        assert stats["n_tot_mean"] == n_tot
        means.append(stats["nb_mean"])
        varis.append(stats["nb_var"])
    p = xi / (1.0 + xi)
    assert np.mean(means) == pytest.approx(n_tot * p, rel=0.03), means
    assert np.mean(varis) == pytest.approx(n_tot * p * (1 - p),
                                           rel=0.2), varis


def _charged_blocks():
    """SPC/E block A and a block B whose oxygen carries -0.5 e: unequal
    net charges."""
    s = spce_two_blocks(4, 4)
    q = np.array(s.charges)
    q[4:, 0] = -0.5
    return System(n_mol=8, atoms_per_mol=3, body=s.body, masses=s.masses,
                  charges=q, type_ids=s.type_ids, eps_table=s.eps_table,
                  sig_table=s.sig_table, name="charged",
                  species=s.species)


@pytest.mark.parametrize("system,kw,match", [
    (spce_system(8), {}, "two species"),
    (spce_two_blocks(8, 8), dict(mega=True, dtype=F64), "float32"),
    (spce_two_blocks(8, 8), dict(mega="interpret_full", dtype=F32),
     "mega must be"),
    (spce_two_blocks(8, 8), dict(mega="full", dtype=F32, n_orient=4),
     "unbiased"),
    (spce_two_blocks(8, 8), dict(mega="full", dtype=F32, p_flip=0.0),
     "p_flip"),
    (spce_two_blocks(8, 8), dict(mega=True, dtype=F32, p_flip=1.0),
     "p_flip"),
    (spce_two_blocks(8, 8), dict(n_orient=0), "n_orient"),
    (_charged_blocks(), {}, "equal species net charges"),
])
def test_make_semigrand_guards(system, kw, match):
    with pytest.raises(ValueError, match=match):
        sg_t.make_semigrand(system, RunParams(**WATER), 1.0, device="cpu",
                            **kw)


def test_reference_wolf_and_init_guards():
    with pytest.raises(ValueError, match="reference-Wolf"):
        sg_t.make_semigrand(_charged_blocks(), RunParams(**dict(
            WATER, coulomb="wolf", wolf_style="ref")), 1.0, device="cpu")
    g = sg_t.Semigrand(spce_two_blocks(8, 8), RunParams(**WATER), 1.0,
                       device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        g.init(box=12.0, n_a=6, n_b=6, n_chains=2)
    with pytest.raises(ValueError, match="at least one"):
        g.init(box=12.0, n_a=0, n_b=0, n_chains=2)
    g = sg_t.Semigrand(spce_two_blocks(8, 8), RunParams(**dict(
        WATER, strict_min_image=True)), 1.0, device="cpu")
    with pytest.raises(ValueError, match="minimum-image"):
        g.init(box=8.0, n_a=2, n_b=2, n_chains=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sg_t.Semigrand(spce_two_blocks(8, 8), RunParams(**WATER), 1.0)


def test_bridge_round_trip():
    g = sg_t.Semigrand(spce_two_blocks(8, 8), RunParams(**WATER), 2.0,
                       device="cpu")
    st = g.init(box=10.0, n_a=5, n_b=3, n_chains=2)
    arrays = bridge.semigrand_state_to_numpy(st)
    back = bridge.semigrand_state_from_numpy(arrays, "cpu")
    for f in arrays:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    with pytest.raises(KeyError, match="lack fields"):
        bridge.semigrand_state_from_numpy({"com": arrays["com"]}, "cpu")
