"""The port's molecular Gibbs ensemble (mc/gibbs_mol.py) and the Gibbs
cycle of mc/moves.make_mega_gibbs_fn on the CPU, against the JAX package.

* The plain route in float64 through its draw seam: the port's cheap step
  and volume step fed the uniforms, axes and trial orientations that the
  JAX step draws from its keys (reproduced here with jax.random), against
  the JAX step itself (reached through the closures of its run_steps):
  decisions equal, state and energies to 1e-9.
* mega="full" against JAX mega="interpret_full" and mega=True's folded
  kernel sweep against JAX mega="interpret": the interpreter's PRNG
  returns zeros, so the port gets zero uniforms and all-zero deletion
  scores; equal decisions, energies within 2e-5 of the term magnitudes.
* tune_parameters equals JAX's exactly; the ideal-gas pressure and the
  Widom-works identities; the refusals; the bridge round trip.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gibbs_mol as gibbs_j
from metropolismontecarlo_tpu.mc.gcmc_mol import make_mol_slots as slots_j
from metropolismontecarlo_tpu.models import polyatomic as poly_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops import ewald as ewald_j
from metropolismontecarlo_tpu.ops.quaternions import random_unit_vector
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gibbs_mol as gibbs_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.models import linear as linear_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gibbs_op

F32, F64 = torch.float32, torch.float64
C = 4
KL, NK, KSQ = ewald_t.tune_parameters(13.0, 4.5, 1e-3)
WATER = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", kappa_L=KL, nk=NK, ksq_max=KSQ, use_lrc=False,
             p_translate=0.5, p_volume=0.0, dr_max=0.3, dphi_max=0.3,
             strict_min_image=False)
TRI = dict(strict_min_image=False, temperature=2.0, r_cut=2.5,
           cutoff_mode="site", coulomb="none", p_translate=0.5,
           p_volume=0.0, dr_max=0.3, dphi_max=0.5, use_lrc=False)


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
    return bridge.mol_gibbs_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _carry(st_j):
    return tuple(getattr(st_j, f) for f in gibbs_j.MolGibbsState._fields)


def _assert_states_close(st_t, st_j, rtol=1e-9, atol=1e-9):
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)),
                                      err_msg=f)
    for f in ("com", "quat", "coords", "box", "sfac", "energy"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


# ---------------- ops/ewald.tune_parameters ----------------------------


@pytest.mark.parametrize("args", [(20.813, 6.62, 1e-3), (13.0, 4.5, 1e-3),
                                  (16.5, 5.0, 1e-3), (30.0, 10.0, 1e-5),
                                  (9.0, 2.5, 0.1)])
def test_tune_parameters_equals_jax(args):
    assert ewald_t.tune_parameters(*args) == ewald_j.tune_parameters(*args)
    with pytest.raises(ValueError, match="tune_parameters"):
        ewald_t.tune_parameters(args[0], args[1], 1.5)


def test_flagship_ewald_parameters():
    """bench.py's "gibbs" configuration: kappa_L 8.263, nk 7, |k|^2 < 50
    (K = 783) at the largest box a volume exchange reaches."""
    box_l = (85 / 0.0267) ** (1.0 / 3.0)
    box_max = (box_l ** 3 + 18.0 ** 3) ** (1.0 / 3.0)
    kl, nk, ksq = ewald_t.tune_parameters(box_max,
                                          min(7.5, 0.45 * box_l), 1e-3)
    assert (round(box_l, 3), round(box_max, 3)) == (14.711, 20.813)
    assert (round(kl, 3), nk, ksq) == (8.263, 7, 50)
    assert len(ewald_t.make_kvectors(nk, ksq)[0]) == 783


# ---------------- the plain route, float64, through the draw seam -------


def _jax_draws(keys, ms_j, n_or):
    """The draws of JAX's cheap step from each chain's key, as the port's
    draw_cheap lays them out (torch, float64)."""
    f64 = jnp.float64

    def one(key):
        _, k = jax.random.split(key)
        (k_move, k_box, k_sel, k_pos, k_rot, k_insq, k_delq, k_pick,
         k_acc) = jax.random.split(k, 9)
        kax, kang = jax.random.split(k_rot)
        return dict(
            u_move=jax.random.uniform(k_move, dtype=f64),
            bit=jax.random.bernoulli(k_box),
            u_sel=jax.random.uniform(k_sel, dtype=f64),
            u_pos=jax.random.uniform(k_pos, (3,), f64),
            axis=random_unit_vector(kax, (), dtype=f64),
            u_rot=jax.random.uniform(kang, (), dtype=f64),
            quats_in=ms_j.trial_quats(k_insq, n_or),
            quats_del=ms_j.trial_quats(k_delq, n_or - 1),
            u_pick=jax.random.uniform(k_pick, dtype=f64),
            u_acc=jax.random.uniform(k_acc, dtype=f64))

    return SimpleNamespace(**{k: torch.tensor(np.array(v)) for k, v in
                              jax.vmap(one)(keys).items()})


SEAM_CASES = {
    "spce-ewald": (water_j.spce_system, water_t.spce_system,
                   dict(WATER, p_volume=0.05), (11.0, 13.0), (6, 2), 1, 0.4),
    "triatomic-lrc-orient3": (
        poly_j.triatomic_system, poly_t.triatomic_system,
        dict(TRI, use_lrc=True, p_volume=0.05), (5.5, 6.5), (10, 4), 3,
        0.5),
}


@pytest.mark.parametrize("name", list(SEAM_CASES))
def test_plain_steps_match_jax_f64(name):
    sys_j, sys_t, kw, boxes, n_init, n_or, px = SEAM_CASES[name]
    cap = 8 if sys_j is water_j.spce_system else 16
    g_j = gibbs_j.MolGibbsEnsemble(sys_j(cap), RunParamsJ(**kw),
                                   dv_max=0.05, p_transfer=px,
                                   n_orient=n_or)
    st_j = g_j.init(jax.random.PRNGKey(5), boxes=boxes, n_init=n_init,
                    n_chains=C)
    run_chain = _free(g_j.run_steps, "_run_chain")
    step_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_cheap_step")(
        c, None)[0]))
    vol_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_vol_step")(c)))
    ms_j = slots_j(sys_j(cap), RunParamsJ(**kw), jnp.float64)
    g_t = gibbs_t.MolGibbsEnsemble(sys_t(cap), RunParams(**kw), dv_max=0.05,
                                   p_transfer=px, n_orient=n_or,
                                   device="cpu")
    st = _to_port(st_j)
    _assert_states_close(st, st_j)          # full_energy: the same model
    carry = _carry(st_j)
    for i in range(24):
        dr = _jax_draws(carry[7], ms_j, n_or)
        carry = step_j(*carry)
        st = g_t.run_steps.cheap_step(st, dr)
        if i % 8 == 7:
            # a volume move on the uniforms JAX's keys draw
            def vol_u(key):
                _, k = jax.random.split(key)
                k_pos, k_acc = jax.random.split(k)
                return (jax.random.uniform(k_pos, dtype=jnp.float64),
                        jax.random.uniform(k_acc, dtype=jnp.float64))

            u_dv, u_acc = (torch.tensor(np.array(x))
                           for x in jax.vmap(vol_u)(carry[7]))
            carry = vol_j(*carry)
            st = g_t.run_steps.volume_step(st, u_dv, u_acc)
    st_j = gibbs_j.MolGibbsState(*carry)
    _assert_states_close(st, st_j, rtol=1e-9, atol=1e-8)
    att = st.att.sum(0).tolist()
    assert att[2] == 3 * C and att[3] > 0 and att[0] + att[1] > 0
    assert int(st.acc[:, 3].sum()) > 0     # transfers were accepted


# ---------------- the kernel routes against the TPU interpreter ---------


def _zero_draws(monkeypatch, mags):
    """Zero uniforms for every kernel route, and the Gibbs op as the JAX
    interpreter runs it: the plain twin with all-zero deletion scores."""
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))

    def op(*a, **k):
        k.pop("seed", None)
        n_c, m_off = a[0].shape[0], a[1].shape[2]
        out = gibbs_op.sweep_gibbs_plain(
            *a, magnitude=True,
            scores=torch.zeros((n_c, k.get("n_exch", 0), 2 * m_off)), **k)
        mags.append(out[4][:, gibbs_op.N_STATS])
        return out[:4] + (out[4][:, :gibbs_op.N_STATS],) + out[5:]

    monkeypatch.setattr(moves_t.gibbs_op, "sweep_gibbs", op)


FULL_CASES = {
    "spce-ewald": (water_j.spce_system, water_t.spce_system, WATER, 8,
                   (11.0, 13.0), (6, 2), 0.4, 54),
    "triatomic-none": (poly_j.triatomic_system, poly_t.triatomic_system,
                       TRI, 16, (9.0, 10.0), (10, 4), 0.3, 80),
}


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_mega_full_matches_jax_interpret_full(name, monkeypatch):
    sys_j, sys_t, kw, cap, boxes, n_init, px, n_steps = FULL_CASES[name]
    g_j = gibbs_j.MolGibbsEnsemble(sys_j(cap), RunParamsJ(**kw),
                                   p_transfer=px, dtype=jnp.float32,
                                   mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(4), boxes=boxes, n_init=n_init,
                    n_chains=C)
    mags = []
    _zero_draws(monkeypatch, mags)
    g_t = gibbs_t.MolGibbsEnsemble(sys_t(cap), RunParams(**kw),
                                   p_transfer=px, dtype=F32, mega="full",
                                   device="cpu")
    st = _to_port(st_j)
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, n_steps)
    st2 = g_t.run_steps(st, n_steps)
    assert len(mags) == 2                      # two cycles, one launch each
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    assert int(st2.acc[:, 3].sum()) > 0        # transfers were accepted
    mag = torch.stack(mags).sum(0).numpy()[:, None]
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)
    ref = np.asarray(st_j2.sfac)
    np.testing.assert_allclose(st2.sfac.numpy(), ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    on = np.asarray(st_j2.active)
    np.testing.assert_allclose(st2.com.numpy()[on],
                               np.asarray(st_j2.com)[on], atol=1e-5)
    # the port's own recompute agrees with what it carried; N conserved
    _, stats = g_t.run_block(st2, 0)
    assert stats["drift_max_rel"] < 2e-3 and stats["sfac_err_max"] < 1e-4
    assert (st2.active.sum((1, 2)) == sum(n_init)).all()


def test_mega_true_sweep_matches_jax_interpret(monkeypatch):
    """mega=True's folded kernel sweep of both boxes against JAX's
    (the transfer steps that follow it are the plain route, held to JAX
    by test_plain_steps_match_jax_f64)."""
    kw = dict(WATER, p_volume=0.02)
    g_j = gibbs_j.MolGibbsEnsemble(water_j.spce_system(8), RunParamsJ(**kw),
                                   dv_max=0.02, p_transfer=0.4,
                                   dtype=jnp.float32, mega="interpret")
    st_j = g_j.init(jax.random.PRNGKey(4), boxes=(11.0, 13.0),
                    n_init=(6, 2), n_chains=C)
    mags = []
    _zero_draws(monkeypatch, mags)
    g_t = gibbs_t.MolGibbsEnsemble(water_t.spce_system(8), RunParams(**kw),
                                   dv_max=0.02, p_transfer=0.4, dtype=F32,
                                   mega=True, device="cpu")
    st = _to_port(st_j)
    want = _free(g_j.run_steps, "_sweep_state")(st_j)
    got = g_t.run_steps.sweep(st)
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


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-9),
                                            (True, F32, 2e-3),
                                            ("full", F32, 2e-3)])
def test_routes_keep_the_drift_and_sfac_gates(mega, dtype, tol):
    """Every route's carried energies and S(k) against the recompute
    through transfers and volume moves (unequal boxes), N conserved."""
    kw = dict(WATER, p_volume=0.02)
    g = gibbs_t.MolGibbsEnsemble(water_t.spce_system(8), RunParams(**kw),
                                 dv_max=0.02, p_transfer=0.4, dtype=dtype,
                                 mega=mega, device="cpu")
    st = g.init(boxes=(11.0, 13.0), n_init=(6, 2), n_chains=C)
    for _ in range(2):
        st, stats = g.run_block(st, 54, drift_tol=tol)
        assert stats["sfac_err_max"] < (1e-9 if dtype == F64 else 1e-4)
    assert (st.active.sum((1, 2)) == 8).all()
    assert int(st.att[:, 0].sum()) > 0 and int(st.att[:, 3].sum()) > 0
    if mega != True:            # noqa: E712 (the hybrid's cadence: none)
        assert int(st.att[:, 2].sum()) > 0


# ---------------- identities -------------------------------------------


def test_ideal_gas_pressure_and_widom_works():
    """Ideal rigid rotor: pressure_fd is N T / V per box, the insertion
    and deletion works vanish and every ghost's Boltzmann factor is 1."""
    kw = dict(TRI, temperature=1.4)
    g = gibbs_t.MolGibbsEnsemble(poly_t.triatomic_system(24, eps=0.0),
                                 RunParams(**kw), device="cpu")
    st = g.init(boxes=(5.0, 7.0), n_init=(12, 18), n_chains=3)
    p = g.pressure_fd(st)
    n = st.active.sum(2).double()
    np.testing.assert_allclose(p.numpy(), (n * 1.4 / st.box ** 3).numpy(),
                               rtol=1e-9)
    di, ov, dd = g.widom_works(st, 16, 8)
    assert di.shape == (3, 2, 16) and dd.shape == (3, 2, 8)
    assert float(di.abs().max()) == 0.0 and float(dd.abs().max()) == 0.0
    assert not bool(ov.any())
    np.testing.assert_array_equal(g.widom_boltzmann(st, 8).numpy(), 1.0)


def test_widom_works_match_widom_boltzmann():
    """Interacting water, f64: widom_works' insertion energies on the
    ghost poses of widom_boltzmann (one generator state) average to the
    same per-box Boltzmann factors, and the deletion works are finite."""
    gen = torch.Generator().manual_seed(3)
    g = gibbs_t.MolGibbsEnsemble(water_t.spce_system(8), RunParams(**WATER),
                                 device="cpu", generator=gen)
    st = g.init(boxes=(11.0, 13.0), n_init=(6, 2), n_chains=2)
    gen.manual_seed(11)
    bw = g.widom_boltzmann(st, 16)
    gen.manual_seed(11)
    di, ov, dd = g.widom_works(st, 16, 16)
    bw2 = torch.where(ov, 0.0, torch.exp(-di / WATER["temperature"])).mean(2)
    np.testing.assert_allclose(bw2.numpy(), bw.numpy(), rtol=1e-9)
    assert bool(torch.isfinite(dd).all())
    assert float(bw.min()) > 0.0


# ---------------- refusals and bookkeeping -------------------------------


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mega=True, dtype=F64), ValueError, "float32"),
    (dict(mega="full", dtype=F64), ValueError, "float32"),
    (dict(mega="interpret_full", dtype=F32), ValueError, "mega must be"),
    (dict(mega="full", dtype=F32, p_transfer=0.0, p_volume=0.0),
     ValueError, "p_transfer"),
    (dict(mega=True, dtype=F32, p_transfer=1.0), ValueError, "p_transfer"),
    (dict(mega=True, dtype=F32, p_transfer=0.0, p_volume=0.02), ValueError,
     "p_transfer = 0"),
    (dict(mega="full", dtype=F32, n_orient=4), ValueError, "unbiased"),
    (dict(n_orient=0), ValueError, "n_orient"),
])
def test_make_gibbs_mol_refusals(kw, exc, match):
    kw = dict(kw)
    params = RunParams(**dict(WATER, coulomb="none",
                              p_volume=kw.pop("p_volume", 0.0)))
    with pytest.raises(exc, match=match):
        gibbs_t.make_gibbs_mol(water_t.spce_system(8), params, device="cpu",
                               **kw)


def test_guards_of_init_and_the_mega_builders():
    # the Ewald consistency guard: erfc(kappa qq_cut) too large in the big
    # box (the reference convention kappa_L 5.6 with r_cut 4.5)
    g = gibbs_t.MolGibbsEnsemble(
        water_t.spce_system(8), RunParams(**dict(WATER, kappa_L=5.6, nk=5,
                                                 ksq_max=27)), device="cpu")
    with pytest.raises(ValueError, match="erfc"):
        g.init(boxes=(11.0, 22.0), n_init=(4, 4), n_chains=2)
    # the minimum-image guard
    g = gibbs_t.MolGibbsEnsemble(
        water_t.spce_system(8), RunParams(**dict(WATER, coulomb="none",
                                                 strict_min_image=True)),
        device="cpu")
    with pytest.raises(ValueError, match="minimum-image"):
        g.init(boxes=(8.0, 12.0), n_init=(4, 4), n_chains=2)
    with pytest.raises(ValueError, match="capacity"):
        g.init(boxes=(12.0, 12.0), n_init=(9, 4), n_chains=2)
    # the in-kernel cycle takes one uniform species and the site cutoff
    with pytest.raises(ValueError, match="uniform single-species"):
        moves_t.make_mega_gibbs_fn(linear_t.co2_n2_system(4, 4),
                                   RunParams(**WATER), None, None, "cpu")
    with pytest.raises(ValueError, match="site cutoff"):
        moves_t.make_mega_gibbs_fn(
            water_t.spce_system(8),
            RunParams(**dict(WATER, cutoff_mode="com")), None, None, "cpu")
    # the card by default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gibbs_t.MolGibbsEnsemble(water_t.spce_system(8),
                                     RunParams(**WATER))


def test_full_energy_matches_jax_f64():
    kw = dict(WATER, coulomb="wolf", kappa_L=2.0, use_lrc=True)
    g_j = gibbs_j.MolGibbsEnsemble(water_j.spce_system(8), RunParamsJ(**kw))
    st_j = g_j.init(jax.random.PRNGKey(1), boxes=(10.0, 12.5),
                    n_init=(5, 3), n_chains=3)
    g_t = gibbs_t.MolGibbsEnsemble(water_t.spce_system(8), RunParams(**kw),
                                   device="cpu")
    e, sf = g_t.full_energy(_to_port(st_j))
    np.testing.assert_allclose(e.numpy(), np.asarray(st_j.energy),
                               rtol=1e-10)
    assert sf.shape == (3, 2, 1, 2)


def test_bridge_roundtrips_the_gibbs_state():
    g = gibbs_t.MolGibbsEnsemble(water_t.spce_system(8), RunParams(**WATER),
                                 device="cpu")
    st = g.init(boxes=(11.0, 13.0), n_init=(3, 2), n_chains=2)
    arrays = bridge.mol_gibbs_state_to_numpy(st)
    assert arrays["active"].dtype == np.bool_
    back = bridge.mol_gibbs_state_from_numpy(arrays, "cpu")
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(back, f.name), getattr(st, f.name)), f.name
    with pytest.raises(KeyError, match="box"):
        bridge.mol_gibbs_state_from_numpy(
            {k: v for k, v in arrays.items() if k != "box"}, "cpu")
