"""The port's Widom machinery (mc/widom.py) against the JAX package's.

* make_pose_eval pieces and widom_du in float64 on the same numpy
  configuration and ghost poses: rel 1e-9, for every Coulomb style, the
  three cutoff modes, the linear shift, the tail correction and the Ewald
  surface term.
* make_mega_widom_fn: the JAX kernel runs in the TPU interpreter, whose
  PRNG returns zeros, so every ghost sits at the origin with the Shoemake
  quaternion of u = 0, (0, 1, 0, 0), after a sweep of deterministic
  moves.  Feeding the port zero uniforms makes its plain twin take the
  same sweep and ghosts; the deposited Boltzmann means must agree to
  rtol 1e-3 (the JAX test's tolerance: f32 and the TPU kernel's erfc
  polynomial).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import widom as widom_j
from metropolismontecarlo_tpu.mc.driver import MonteCarlo as MonteCarloJ
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops import tail as tail_j
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc import widom as widom_t
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models import monatomic as mono_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops import tail as tail_t
from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

C, N_GHOST = 3, 4
F64 = torch.float64

STYLES = [
    dict(coulomb="ewald"),
    dict(coulomb="ewald", qq_r_cut=4.0),
    dict(coulomb="ewald", ewald_surface=True),
    dict(coulomb="wolf"),
    dict(coulomb="wolf", wolf_style="ref"),
    dict(coulomb="bare"),
    dict(coulomb="none"),
    dict(coulomb="ewald", cutoff_mode="com"),
    dict(coulomb="ewald", cutoff_mode="first", qq_r_cut=4.5),
    dict(coulomb="none", cutoff_mode="first", use_lrc=False),
    dict(coulomb="none", lj_shift="linear"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(kw):
    return "-".join(f"{a}={b}" for a, b in kw.items())


def _config(system, box, seed=5):
    """numpy f64 chains: jittered lattice COMs, random unit quaternions,
    ghost COMs and quaternions."""
    rng = np.random.default_rng(seed)
    M = system.n_mol
    com = cubic_lattice(M, box)[None] + rng.uniform(-0.2, 0.2, (C, M, 3))
    quat = rng.normal(size=(C, M, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    com_t = rng.uniform(0.0, box, (C, N_GHOST, 3))
    quat_t = rng.normal(size=(C, N_GHOST, 4))
    quat_t /= np.linalg.norm(quat_t, axis=-1, keepdims=True)
    return com, quat, com_t, quat_t


def _states(sys_t, sys_j, params_t, params_j, box, dtype_t, dtype_j):
    """The same chains as a port SimState and a JAX SimState."""
    com, quat, com_t, quat_t = _config(sys_t, box)
    mc_t = MonteCarlo(sys_t, params_t, device="cpu", dtype=dtype_t,
                      kernel="plain" if dtype_t == F64 else "auto")
    st_t = mc_t.init_state(com, quat, box=box)
    mc_j = MonteCarloJ(sys_j, params_j, dtype=dtype_j, pallas=False)
    st_j = mc_j.init_state(jax.random.PRNGKey(0), jnp.asarray(com),
                           jnp.asarray(quat), box=box)
    np.testing.assert_allclose(st_t.energy.numpy(), np.asarray(st_j.energy),
                               rtol=1e-9 if dtype_t == F64 else 1e-4)
    return mc_t, st_t, mc_j, st_j, com_t, quat_t


@pytest.mark.parametrize("kw", STYLES, ids=_ids)
def test_widom_du_matches_jax_f64(kw):
    kw = dict(dict(temperature=300.0, r_cut=5.0, nk=3, ksq_max=9,
                   strict_min_image=False), **kw)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    mc_t, st_t, mc_j, st_j, com_t, quat_t = _states(
        water_t.spce_system(8), water_j.spce_system(8), params_t, params_j,
        12.0, F64, jnp.float64)
    du_fn, _ = widom_t.make_widom_fn(mc_t.system, params_t, mc_t.kvecs,
                                     mc_t.kweights, "cpu", dtype=F64, chunk=2)
    du, ovr = du_fn(st_t, torch.tensor(com_t), torch.tensor(quat_t))
    du_j, _ = widom_j.make_widom_fn(mc_j.system, params_j, mc_j.kvecs,
                                    mc_j.kweights, dtype=jnp.float64, chunk=1)
    ref, ovr_j = du_j(st_j, jnp.asarray(com_t), jnp.asarray(quat_t))
    np.testing.assert_array_equal(ovr.numpy(), np.asarray(ovr_j))
    np.testing.assert_allclose(du.numpy(), np.asarray(ref), rtol=1e-9,
                               atol=1e-9 * float(np.abs(ref).max()))


@pytest.mark.parametrize("kw", [STYLES[0], STYLES[4], STYLES[7], STYLES[10]],
                         ids=_ids)
def test_pose_eval_pieces_match_jax_f64(kw):
    """pose_atoms, pair_energy with an activity mask and an excluded
    molecule, pose_sfac and the per-molecule constants."""
    kw = dict(dict(temperature=300.0, r_cut=5.0, nk=3, ksq_max=9,
                   strict_min_image=False), **kw)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    sys_t, sys_j = water_t.spce_system(8), water_j.spce_system(8)
    box = 12.0
    mc_t, st_t, _, st_j, com_t, quat_t = _states(
        sys_t, sys_j, params_t, params_j, box, F64, jnp.float64)
    kv, kwt = (make_kvectors(3, 9) if kw["coulomb"] == "ewald"
               else (None, None))
    ev_t = widom_t.make_pose_eval(sys_t, params_t, kv, kwt, "cpu", F64)
    ev_j = widom_j.make_pose_eval(sys_j, params_j, kv, kwt, jnp.float64)
    rng = np.random.default_rng(3)
    ok = rng.random((C, sys_t.n_atoms_padded)) < 0.7
    ok &= np.asarray(sys_t.mol_of_atom_padded)[None, :] >= 0
    excl = rng.integers(0, 8, (C, N_GHOST))

    ra = ev_t.pose_atoms(torch.tensor(com_t), torch.tensor(quat_t))
    e, ovr = ev_t.pair_energy(torch.tensor(com_t), ra, st_t.coords, st_t.com,
                              st_t.box, torch.tensor(ok), torch.tensor(excl))
    boxes = torch.full((C,), box, dtype=F64)
    for c in range(C):
        for j in range(N_GHOST):
            ra_j = ev_j.pose_atoms(jnp.asarray(com_t[c, j]),
                                   jnp.asarray(quat_t[c, j]))
            np.testing.assert_allclose(ra[c, j].numpy(), np.asarray(ra_j),
                                       rtol=1e-12, atol=1e-12)
            e_j, o_j = ev_j.pair_energy(
                jnp.asarray(com_t[c, j]), ra_j, st_j.coords[c], st_j.com[c],
                st_j.box[c], jnp.asarray(ok[c]), int(excl[c, j]))
            assert float(e[c, j]) == pytest.approx(float(e_j), rel=1e-9,
                                                   abs=1e-9)
            assert bool(ovr[c, j]) == bool(o_j)
            if kv is not None:
                s = ev_t.pose_sfac(ra[c, j], boxes[c])
                np.testing.assert_allclose(
                    s.numpy(), np.asarray(ev_j.pose_sfac(ra_j, box)),
                    rtol=1e-9, atol=1e-12)
    for name in ("self_intra", "wolf_const_coeff", "lrc_delta",
                 "lrc_self_coeff"):
        got = getattr(ev_t, name)(boxes)
        want = float(getattr(ev_j, name)(jnp.asarray(box, jnp.float64)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-300)
    assert ev_t.q_t_tot == pytest.approx(ev_j.q_t_tot, abs=1e-15)
    assert ev_t.use_lrc == ev_j.use_lrc


def test_mol_tail_coeff_matches_jax():
    sys_t = poly_t.triatomic_system(4)
    t_vec = np.bincount(np.asarray(sys_t.type_ids)[0],
                        minlength=sys_t.eps_table.shape[0])
    got = tail_t.mol_tail_coeff(t_vec, t_vec, sys_t.eps_table,
                                sys_t.sig_table, 2.5)
    want = tail_j.mol_tail_coeff(t_vec, t_vec, sys_t.eps_table,
                                 sys_t.sig_table, 2.5)
    assert got == pytest.approx(want, rel=1e-14) and got != 0.0
    assert tail_t.LRC_PREFACTOR == pytest.approx(tail_j.LRC_PREFACTOR)
    # U_lrc = prefactor / V * c_mm N^2 is lrc_energy of the atom counts
    n, vol = 7, 123.0
    e = tail_t.lrc_energy(torch.tensor(n * t_vec, dtype=F64),
                          torch.tensor(np.array(sys_t.eps_table)),
                          torch.tensor(np.array(sys_t.sig_table)), 2.5, vol)
    assert float(e) == pytest.approx(
        tail_t.LRC_PREFACTOR / vol * got * n * n, rel=1e-12)


def test_mu_excess():
    b = torch.tensor([0.5, 2.0], dtype=F64)
    np.testing.assert_allclose(
        widom_t.mu_excess(b, 300.0).numpy(),
        np.asarray(widom_j.mu_excess(jnp.asarray(b.numpy()), 300.0)))


def _zero_uniforms(monkeypatch):
    monkeypatch.setattr(
        moves_t, "draw_uniforms",
        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(
        moves_t, "draw_exchange_uniforms",
        lambda c, n, gen, dev: torch.zeros((c, n, 8)))


MEGA_CASES = {
    "water": (water_t.spce_system, water_j.spce_system, 8, 10.0, 5,
              dict(temperature=500.0, r_cut=4.5, nk=3, ksq_max=9,
                   coulomb="ewald", strict_min_image=False)),
    "lj-lrc": (mono_t.lj_system, mono_j.lj_system, 27, 9.0, 3,
               dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
                    coulomb="none", p_translate=1.0, use_lrc=True,
                    slab_mode="off")),
}


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
def test_widom_mega_twin_matches_jax_interpret_kernel(case, monkeypatch):
    build_t, build_j, n, box, n_g, kw = MEGA_CASES[case]
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    f32 = torch.float32
    mc_t, st_t, mc_j, st_j, _, _ = _states(
        build_t(n), build_j(n), params_t, params_j, box, f32, jnp.float32)
    wm_j = widom_j.make_mega_widom_fn(mc_j.system, params_j, mc_j.kvecs,
                                      mc_j.kweights, n_g, interpret=True)
    st_j2, b_j = wm_j(st_j, jnp.asarray(0, jnp.int32))

    _zero_uniforms(monkeypatch)
    st_t2, out = mc_t.widom_mega(st_t, n_per_sweep=n_g)
    b_t = out["boltzmann_mean"].numpy()
    np.testing.assert_allclose(b_t, np.asarray(b_j), rtol=1e-3, atol=1e-30)
    assert (b_t > 0.0).any()
    np.testing.assert_allclose(out["mu_ex"].numpy(),
                               -kw["temperature"] * np.log(b_t), rtol=1e-6)
    # the sweep ran, on the same deterministic moves as the JAX kernel's
    np.testing.assert_array_equal(st_t2.att.numpy(), np.asarray(st_j2.att))
    np.testing.assert_array_equal(st_t2.acc.numpy(), np.asarray(st_j2.acc))
    assert int(st_t2.att[:, :2].sum()) == C * n
    assert int(st_t2.step) == n + n_g
    np.testing.assert_allclose(st_t2.com.numpy(), np.asarray(st_j2.com),
                               atol=1e-5)
    # and against the port's own plain evaluator at that pose on the
    # post-sweep state
    du_fn, _ = widom_t.make_widom_fn(mc_t.system, params_t, mc_t.kvecs,
                                     mc_t.kweights, "cpu", dtype=f32)
    quat0 = torch.zeros((C, 1, 4))
    quat0[..., 1 if n == 8 else 0] = 1.0
    du, ovr = du_fn(st_t2, torch.zeros((C, 1, 3)), quat0)
    expect = np.where(ovr.numpy()[:, 0], 0.0,
                      np.exp(-du.numpy()[:, 0] / kw["temperature"]))
    np.testing.assert_allclose(b_t, expect, rtol=1e-3, atol=1e-30)
    # the state after the call still carries its energy
    _, m = mc_t.run_block(st_t2, 0)
    assert m["drift_max_rel"] < 1e-4


def test_widom_sample_matches_mega_sampling_statistics():
    """widom() and widom_mega() sample the same ghost measure: on an
    ideal gas (eps = q = 0) every ghost deposits exactly 1."""
    sys_t = poly_t.triatomic_system(8, eps=0.0)
    params = RunParams(temperature=1.5, r_cut=2.5, coulomb="none",
                       use_lrc=False, strict_min_image=False)
    mc = MonteCarlo(sys_t, params, device="cpu")
    st = mc.init_state(cubic_lattice(8, 6.0), box=6.0, n_chains=2)
    np.testing.assert_allclose(mc.widom(st, 6)["boltzmann_mean"].numpy(), 1.0)
    st2, out = mc.widom_mega(st, 6)
    np.testing.assert_allclose(out["boltzmann_mean"].numpy(), 1.0)
    assert int(st2.att[:, :2].sum()) == 2 * 8


@pytest.mark.parametrize("bad", ["zero", "surface", "mixture", "route"])
def test_widom_mega_refusals(bad):
    params = RunParams(temperature=300.0, r_cut=4.5, nk=3, ksq_max=9,
                       coulomb="ewald", strict_min_image=False)
    system = water_t.spce_system(8)
    if bad == "zero":
        with pytest.raises(ValueError, match="n_per_sweep"):
            widom_t.make_mega_widom_fn(system, params, None, None, 0, "cpu")
    elif bad == "surface":
        import dataclasses
        with pytest.raises(ValueError, match="surface"):
            widom_t.make_mega_widom_fn(
                system, dataclasses.replace(params, ewald_surface=True),
                None, None, 4, "cpu")
    elif bad == "mixture":
        with pytest.raises(ValueError, match="single-species"):
            widom_t.make_mega_widom_fn(
                water_t.spce_methane_system(4, 4), params,
                *make_kvectors(3, 9), 4, "cpu")
    else:
        mc = MonteCarlo(system, params, device="cpu", kernel="plain")
        st = mc.init_state(cubic_lattice(8, 10.0), box=10.0, n_chains=2)
        with pytest.raises(ValueError, match="whole-sweep route"):
            mc.widom_mega(st, 4)


def test_bridge_roundtrips_the_widom_state():
    params = RunParams(temperature=300.0, r_cut=4.5, coulomb="none",
                       strict_min_image=False)
    mc = MonteCarlo(water_t.spce_system(8), params, device="cpu")
    st = mc.init_state(cubic_lattice(8, 10.0), box=10.0, n_chains=2)
    back = bridge.state_from_numpy(bridge.state_to_numpy(st), "cpu")
    assert torch.equal(back.coords, st.coords)
