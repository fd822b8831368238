"""The port's monatomic Gibbs ensemble (mc/gibbs.py) on the CPU, against
the JAX package and closed forms.

* The plain route in float64 through its draw seam: the port's cheap and
  volume steps fed the uniforms the JAX steps draw from their keys,
  against those steps (reached through the closures of JAX's run_steps),
  with the LJ tail on: decisions equal, state and energies to 1e-9.
* mega=True's folded kernel sweep of both boxes against JAX
  mega="interpret" on zero uniforms (the interpreter's PRNG); the hybrid
  route's drift and bookkeeping (a port of tests/test_gibbs.py's mega
  case).
* The ideal gas: N_box0 ~ Binomial(N, 1/2) in equal boxes; the refusals;
  the bridge round trip.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gibbs as gibbs_j
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gibbs as gibbs_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.models import monatomic as mono_t
from metropolismontecarlo_tpu_torch.models.system import RunParams

F32 = torch.float32
C_SEAM = 6
LJ = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.6, dr_max=0.3,
          use_lrc=False, p_volume=0.02)


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
    return bridge.gibbs_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _assert_states_close(st_t, st_j, rtol=1e-9, atol=1e-9):
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)),
                                      err_msg=f)
    for f in ("com", "box", "energy"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("kw", [dict(use_lrc=True),
                                dict(lj_shift="linear", p_translate=0.3)],
                         ids=["lrc", "linear"])
def test_plain_steps_match_jax_f64(kw):
    kw = dict(LJ, **kw)
    g_j = gibbs_j.GibbsEnsemble(mono_j.lj_system(1), RunParamsJ(**kw),
                                capacity=24, dv_max=0.05)
    st_j = g_j.init(jax.random.PRNGKey(3), boxes=(5.0, 6.5),
                    n_init=(14, 6), n_chains=C_SEAM)
    run_chain = _free(g_j.run_steps, "_run_chain")
    step_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_cheap_step")(
        c, None)[0]))
    vol_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_vol_step")(c)))
    g_t = gibbs_t.GibbsEnsemble(mono_t.lj_system(1), RunParams(**kw),
                                capacity=24, dv_max=0.05, device="cpu")
    st = _to_port(st_j)
    _assert_states_close(st, st_j)          # full_energy: the same model
    f64 = jnp.float64

    def draws(key):
        _, k = jax.random.split(key)
        k_move, k_box, k_sel, k_pos, k_acc = jax.random.split(k, 5)
        return dict(u_move=jax.random.uniform(k_move, dtype=f64),
                    bit=jax.random.bernoulli(k_box),
                    u_sel=jax.random.uniform(k_sel, dtype=f64),
                    u_pos=jax.random.uniform(k_pos, (3,), f64),
                    u_acc=jax.random.uniform(k_acc, dtype=f64))

    def vol_u(key):
        _, k = jax.random.split(key)
        k_pos, k_acc = jax.random.split(k)
        return (jax.random.uniform(k_pos, dtype=f64),
                jax.random.uniform(k_acc, dtype=f64))

    carry = tuple(getattr(st_j, f) for f in gibbs_j.GibbsState._fields)
    for i in range(60):
        dr = SimpleNamespace(**{k: torch.tensor(np.array(v)) for k, v in
                                jax.vmap(draws)(carry[4]).items()})
        carry = step_j(*carry)
        st = g_t.run_steps.cheap_step(st, dr)
        if i % 20 == 19:
            u_dv, u_acc = (torch.tensor(np.array(x))
                           for x in jax.vmap(vol_u)(carry[4]))
            carry = vol_j(*carry)
            st = g_t.run_steps.volume_step(st, u_dv, u_acc)
    _assert_states_close(st, gibbs_j.GibbsState(*carry), atol=1e-8)
    att = st.att.sum(0).tolist()
    assert att[1] == 3 * C_SEAM and att[0] > 0 and att[2] > 0
    assert int(st.acc[:, 2].sum()) > 0 and int(st.acc[:, 0].sum()) > 0


def test_mega_sweep_matches_jax_interpret(monkeypatch):
    """The hybrid route's kernel sweep of both boxes (folded over the
    chain axis, identity quaternions) against JAX's on zero uniforms."""
    g_j = gibbs_j.GibbsEnsemble(mono_j.lj_system(1), RunParamsJ(**LJ),
                                capacity=32, dv_max=0.05, dtype=jnp.float32,
                                mega="interpret")
    st_j = g_j.init(jax.random.PRNGKey(0), boxes=(5.0, 6.0), n_init=(16, 8),
                    n_chains=4)
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    g_t = gibbs_t.GibbsEnsemble(mono_t.lj_system(1), RunParams(**LJ),
                                capacity=32, dv_max=0.05, dtype=F32,
                                mega=True, device="cpu")
    want = _free(g_j.run_steps, "_sweep_state")(st_j)
    got = g_t.run_steps.sweep(_to_port(st_j))
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.acc[:, 0].sum()) > 0
    np.testing.assert_allclose(got.com.numpy(), np.asarray(want.com),
                               atol=1e-5)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-5, atol=1e-3)


def test_mega_drift_and_bookkeeping():
    """mega=True (tests/test_gibbs.py's mega case on the port): kernel
    displacement sweeps, plain transfers and volume moves; carried per-box
    energies against the recompute, total N conserved."""
    g = gibbs_t.GibbsEnsemble(mono_t.lj_system(1), RunParams(**LJ),
                              capacity=32, dv_max=0.05, dtype=F32,
                              mega=True, device="cpu")
    st = g.init(boxes=(5.0, 6.0), n_init=(16, 8), n_chains=4)
    for _ in range(3):
        st, stats = g.run_block(st, 160, drift_tol=5e-4)
    assert int(st.att[:, 0].sum()) > 0 and int(st.att[:, 2].sum()) > 0
    assert (st.active.sum((1, 2)) == 24).all()


def test_ideal_gas_binomial_partition():
    """eps = 0, volume moves off, equal boxes: each particle is in box 0
    with probability 1/2, N0 ~ Binomial(40, 1/2): mean 20, variance 10.
    The sample of 192 chains x 6 blocks gives the mean to ~0.1 and the
    variance to ~0.4 (one standard error); the gates, the JAX test's
    relative bands (0.6 and 1.5), are ~6 and ~3.5 of them."""
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.0,
                       cutoff_mode="site", coulomb="none", p_translate=0.3,
                       p_volume=0.0, dr_max=1.0, use_lrc=False)
    g = gibbs_t.GibbsEnsemble(mono_t.lj_system(1, eps=0.0), params,
                              capacity=64, device="cpu")
    st = g.init(boxes=(8.0, 8.0), n_init=(20, 20), n_chains=192)
    st, _ = g.run_block(st, 600)
    n0 = []
    for _ in range(6):
        st, _ = g.run_block(st, 150, drift_tol=1e-10)
        n0.append(st.active[:, 0].sum(1).double())
    n0 = torch.cat(n0)
    assert float(n0.mean()) == pytest.approx(20.0, rel=0.03)
    assert float(n0.var(unbiased=False)) == pytest.approx(10.0, rel=0.15)
    assert (st.active.sum((1, 2)) == 40).all()
    np.testing.assert_array_equal(g.widom_boltzmann(st, 8).numpy(), 1.0)


def test_refusals_and_the_card_default():
    params = RunParams(**LJ)
    with pytest.raises(ValueError, match="float32"):
        gibbs_t.make_gibbs(mono_t.lj_system(1), params, 16, mega=True,
                           device="cpu")
    with pytest.raises(ValueError, match="mega must be True"):
        gibbs_t.make_gibbs(mono_t.lj_system(1), params, 16, dtype=F32,
                           mega="full", device="cpu")
    with pytest.raises(ValueError, match="p_translate"):
        gibbs_t.make_gibbs(mono_t.lj_system(1),
                           dataclasses.replace(params, p_translate=0.0), 16,
                           dtype=F32, mega=True, device="cpu")
    g = gibbs_t.GibbsEnsemble(mono_t.lj_system(1), params, 16, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        g.init(boxes=(5.0, 5.0), n_init=(17, 0), n_chains=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gibbs_t.GibbsEnsemble(mono_t.lj_system(1), params, 16)


def test_bridge_roundtrips_the_gibbs_state():
    g = gibbs_t.GibbsEnsemble(mono_t.lj_system(1), RunParams(**LJ), 16,
                              device="cpu")
    st = g.init(boxes=(5.0, 6.0), n_init=(8, 4), n_chains=2)
    arrays = bridge.gibbs_state_to_numpy(st)
    back = bridge.gibbs_state_from_numpy(arrays, "cpu")
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(back, f.name), getattr(st, f.name)), f.name
    with pytest.raises(KeyError, match="active"):
        bridge.gibbs_state_from_numpy(
            {k: v for k, v in arrays.items() if k != "active"}, "cpu")
