"""The port's NPT volume move (mc/npt.py), pressure_fd and quench
(mc/driver.py), on the CPU in float64:

* the volume move through its seam (with_uniforms) against the JAX
  make_volume_move_fn on the same state and the uniforms its keys draw:
  the same decisions, energies, virials, boxes and COMs;
* ports of the JAX tests/test_mc.py closed forms: the deterministic
  volume schedule, <V> = (M + 1) T / P of the ideal gas, alone and on a
  per-chain pressure ladder, and the ideal gas's pressure_fd = rho T;
* pressure_fd against the closed-form virial on SPC/E with Ewald;
* quench lowers every chain's energy and restores the temperatures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.io.configs import cubic_lattice as lattice_j
from metropolismontecarlo_tpu.mc.driver import MonteCarlo as MonteCarloJ
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import (
    lj_box_for_density,
    lj_system,
)
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system

F64 = torch.float64
IDEAL = dict(r_cut=1.0, cutoff_mode="site", coulomb="none", p_translate=1.0,
             dr_max=1.0, use_lrc=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread per test process leaves the cores to the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mc(system, params, seed, **kw):
    return MonteCarlo(system, params, device="cpu", dtype=F64,
                      generator=torch.Generator().manual_seed(seed), **kw)


def _jax_uniforms(state_j):
    """The two uniforms JAX make_volume_move_fn draws per chain: splits of
    a sentinel fold of fold_in(key, step)."""
    def one(key):
        k_vol = jax.random.fold_in(jax.random.fold_in(key, state_j.step),
                                   0x5DEECE6)
        k_lnv, k_acc = jax.random.split(k_vol)
        return (jax.random.uniform(k_lnv, dtype=jnp.float64),
                jax.random.uniform(k_acc, dtype=jnp.float64))

    u, u_acc = jax.vmap(one)(state_j.key)
    return torch.tensor(np.asarray(u)), torch.tensor(np.asarray(u_acc))


def test_volume_move_matches_jax():
    n, box, C = 27, 11.0, 12
    kw = dict(temperature=298.15, r_cut=5.0, coulomb="ewald", nk=3,
              ksq_max=10, p_translate=0.5, dr_max=0.3, dphi_max=0.3,
              pressure=0.02, p_volume=1.0, dv_max=0.08)
    mc_j = MonteCarloJ(water_j.spce_system(n), RunParamsJ(**kw),
                       dtype=jnp.float64, pallas=False, recompute_chunk=4)
    st_j = mc_j.init_state(jax.random.PRNGKey(3), lattice_j(n, box),
                           box=box, n_chains=C)
    out_j = mc_j._volume_move(st_j)
    u, u_acc = _jax_uniforms(st_j)
    mc_t = _mc(spce_system(n), RunParams(**kw), 0, kernel="plain")
    st_t = bridge.state_from_numpy(st_j._asdict(), "cpu")
    out_t = mc_t._volume_move.with_uniforms(st_t, u, u_acc)
    acc = np.asarray(out_j.acc[:, 2])
    assert 0 < acc.sum() < C        # both outcomes occur
    np.testing.assert_array_equal(out_t.acc.numpy(), np.asarray(out_j.acc))
    np.testing.assert_array_equal(out_t.att.numpy(), np.asarray(out_j.att))
    for name in ("box", "energy", "virial", "com", "coords", "sfac"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(),
                                   np.asarray(getattr(out_j, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    assert int(out_t.step) == int(out_j.step) == 0


def _ideal(n, t, p, p_volume, ladder=None, seed=0):
    system = lj_system(n, eps=0.0, sigma=1.0)
    params = RunParams(temperature=t, pressure=None if ladder is not None
                       else p, p_volume=p_volume, dv_max=0.3, **IDEAL)
    return system, _mc(system, params, seed, recompute_chunk=64,
                       pressure_ladder=ladder)


def test_npt_volume_schedule():
    """Every chain attempts one volume move every round(1/p_volume)
    sweeps; step stays a pure molecule-move counter."""
    n, t = 16, 2.0
    _, mc = _ideal(n, t, 0.5, 0.25, seed=7)
    box0 = (n * t / 0.5) ** (1.0 / 3.0)
    state = mc.init_state(cubic_lattice(n, box0), box=box0, n_chains=4)
    for sweeps, want_att in ((3, 0), (1, 1), (4, 1), (4, 1)):
        att0 = state.att[:, 2].clone()
        state = mc.run_steps(state, sweeps, False)
        assert ((state.att[:, 2] - att0) == want_att).all(), sweeps
    assert int(state.step) == 12 * n


def test_npt_ideal_gas_exact():
    """Interactions off: ln V sampling gives <V> = (M + 1) T / P."""
    n, t, p = 16, 2.0, 0.5
    _, mc = _ideal(n, t, p, 1.0, seed=4)
    box0 = (n * t / p) ** (1.0 / 3.0)
    state = mc.init_state(cubic_lattice(n, box0), box=box0, n_chains=64)
    state = mc.run_steps(state, 200, False)
    vols = []
    for _ in range(10):
        state = mc.run_steps(state, 50, False)
        vols.append(state.box.numpy() ** 3)
    v_mean, v_exact = float(np.mean(vols)), (n + 1) * t / p
    assert abs(v_mean - v_exact) / v_exact < 0.05, (v_mean, v_exact)


def test_npt_pressure_ladder_ideal_gas_exact():
    """A (C,) pressure ladder: every chain on its own isobar."""
    n, t, C = 16, 2.0, 32
    ladder = np.geomspace(0.25, 1.0, C)
    _, mc = _ideal(n, t, None, 1.0, ladder=torch.tensor(ladder), seed=14)
    box0 = (n * t / 0.5) ** (1.0 / 3.0)
    state = mc.init_state(cubic_lattice(n, box0), box=box0, n_chains=C)
    state = mc.run_steps(state, 300, False)
    vols = []
    for _ in range(12):
        state = mc.run_steps(state, 50, False)
        vols.append(state.box.numpy() ** 3)
    ratio = np.mean(vols, axis=0) / ((n + 1) * t / ladder)
    assert np.max(np.abs(ratio - 1.0)) < 0.2, ratio
    assert abs(np.mean(ratio) - 1.0) < 0.03, np.mean(ratio)


def test_pressure_ladder_validation():
    system = lj_system(8, eps=0.0)
    with pytest.raises(ValueError, match="p_volume"):
        _mc(system, RunParams(**IDEAL), 0,
            pressure_ladder=torch.ones(4))
    _, mc = _ideal(8, 2.0, None, 1.0, ladder=torch.ones(3))
    state = mc.init_state(cubic_lattice(8, 4.0), box=4.0, n_chains=4)
    with pytest.raises(ValueError, match="ladder"):
        mc.run_steps(state, 1, False)


def test_pressure_fd_ideal_gas_exact():
    """eps = 0: dU/dV = 0, so the finite difference gives M T / V."""
    n, t, rho = 32, 1.7, 0.4
    system = lj_system(n, eps=0.0)
    mc = _mc(system, RunParams(temperature=t, r_cut=2.0, cutoff_mode="site",
                               coulomb="none", p_translate=1.0, dr_max=1.0,
                               use_lrc=False), 13)
    box = lj_box_for_density(n, rho)
    state = mc.init_state(cubic_lattice(n, box), box=box, n_chains=8)
    state = mc.run_steps(state, 10, False)
    np.testing.assert_allclose(mc.pressure_fd(state).numpy(), rho * t,
                               rtol=1e-9)


@pytest.mark.parametrize("coulomb", ["ewald", "wolf"])
def test_pressure_fd_matches_virial(coulomb):
    """The closed-form molecular virial (state.virial) and the finite
    difference are the same dU/dV: P = M T / V + W / (3 V)."""
    n, box = 27, 11.0
    mc = _mc(spce_system(n), RunParams(temperature=298.15, r_cut=5.0,
                                       coulomb=coulomb, nk=3, ksq_max=10,
                                       dr_max=0.3, dphi_max=0.3), 5,
             kernel="plain")
    state = mc.init_state(cubic_lattice(n, box), box=box, n_chains=3)
    state = mc.run_steps(state, 2, False)
    state = mc.resync(state)
    vol = state.box ** 3
    p_vir = n * state.temp / vol + state.virial / (3.0 * vol)
    np.testing.assert_allclose(mc.pressure_fd(state, rel_eps=1e-5).numpy(),
                               p_vir.numpy(), rtol=1e-6,
                               atol=1e-6 * float(p_vir.abs().max()))


def test_quench_lowers_the_energy():
    n, box = 27, 9.4
    mc = _mc(spce_system(n), RunParams(temperature=298.15, r_cut=4.5,
                                       coulomb="ewald", nk=3, ksq_max=10,
                                       dr_max=0.2, dphi_max=0.3), 9,
             kernel="plain")
    state = mc.init_state(cubic_lattice(n, box), box=box, n_chains=3)
    state = dataclasses.replace(state, temp=state.temp * 1.5)
    out = mc.quench(state, n_steps=3)
    assert (out.energy < state.energy).all()
    np.testing.assert_array_equal(out.temp.numpy(), state.temp.numpy())
    e, _, _ = mc.full_energy(out)
    np.testing.assert_allclose(out.energy.numpy(), e.numpy(), rtol=1e-12)
