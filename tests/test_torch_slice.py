"""The port's whole NVT slice on the CPU: MonteCarlo.init_state ->
run_block against the JAX MonteCarlo on the interpreted whole-sweep
kernel, and the port's own sampling statistics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.io.configs import cubic_lattice
from metropolismontecarlo_tpu.mc.driver import MonteCarlo as MonteCarloJ
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.water import spce_system as spce_j
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import (
    lj_box_for_density,
    lj_system,
)
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system


def test_slice_matches_jax_mega_interpret(monkeypatch):
    """Same numpy start state, one 3-sweep run_block on both packages.
    The JAX interpreter's PRNG is all zeros; the port's uniforms are
    patched to zeros here, so both take the same deterministic moves."""
    kw = dict(temperature=300.0, r_cut=5.0, cutoff_mode="site",
              coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5,
              dr_max=0.3, dphi_max=0.4)
    mc_j = MonteCarloJ(spce_j(8), RunParamsJ(**kw), dtype=jnp.float32,
                       pallas="mega_interpret", recompute_chunk=4)
    s_j = mc_j.init_state(jax.random.PRNGKey(0), cubic_lattice(8, 12.0),
                          box=12.0, n_chains=8)
    mc_t = MonteCarlo(spce_system(8), RunParams(**kw), device="cpu")
    s_t = bridge.state_from_numpy(
        {f: np.asarray(getattr(s_j, f)) for f in s_j._fields}, "cpu")
    monkeypatch.setattr(
        moves_t, "draw_uniforms",
        lambda C, M, gen, dev: torch.zeros((C, M, 10), device=dev))

    s_j, m_j = mc_j.run_block(s_j, 3, adjust=False)
    s_t, m_t = mc_t.run_block(s_t, 3, adjust=False)

    np.testing.assert_array_equal(s_t.acc.numpy(), np.asarray(s_j.acc))
    np.testing.assert_array_equal(s_t.att.numpy(), np.asarray(s_j.att))
    np.testing.assert_allclose(s_t.energy.numpy(), np.asarray(s_j.energy),
                               rtol=2e-4)
    np.testing.assert_allclose(s_t.com.numpy(), np.asarray(s_j.com),
                               rtol=0, atol=1e-5)
    assert int(s_t.step) == int(s_j.step) == 24
    assert m_j["drift_max_rel"] < 5e-5 and m_t["drift_max_rel"] < 5e-5
    for key in ("acc_trans", "acc_rot", "dr_max_mean"):
        assert m_t[key] == pytest.approx(m_j[key], rel=1e-6)


def test_slice_adjust_and_init_from_coords():
    """init_from_coords recovers the orientations of an explicit rigid
    configuration, and run_block(adjust=True) steers the step sizes and
    resets the counters after every sweep."""
    system = spce_system(8)
    params = RunParams(temperature=300.0, r_cut=5.0, coulomb="wolf",
                       p_translate=0.5, dr_max=0.3, dphi_max=0.3)
    gen = torch.Generator().manual_seed(5)
    mc = MonteCarlo(system, params, device="cpu", generator=gen)
    ref = mc.init_state(cubic_lattice(8, 12.0), box=12.0, n_chains=2)
    coords = ref.coords[0, :, :system.n_atoms].T.numpy().astype(np.float64)
    com = ref.com[0].numpy().astype(np.float64)
    state = mc.init_from_coords(coords, com, 12.0, n_chains=4)
    np.testing.assert_allclose(state.coords[0].numpy(),
                               ref.coords[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(state.energy.numpy(),
                               ref.energy[:1].expand(4).numpy(), rtol=1e-5)
    state, m = mc.run_block(state, 4, adjust=True)
    assert (state.att == 0).all() and (state.acc == 0).all()
    assert int(state.step) == 32
    assert m["drift_max_rel"] < 1e-4
    assert m["dr_max_mean"] != pytest.approx(0.3)


def _liquid_start(n, box, seed):
    """Random sequential addition with a 0.9 sigma exclusion: a
    disordered start that relaxes far faster than a lattice."""
    rng = np.random.default_rng(seed)
    pts = np.empty((0, 3))
    while len(pts) < n:
        c = rng.uniform(0.0, box, 3)
        d = pts - c
        d -= box * np.round(d / box)
        if len(pts) == 0 or (d * d).sum(1).min() >= 0.81:
            pts = np.vstack([pts, c])
    return pts


def test_lj256_acceptance_anchor():
    """The port's own generator: LJ-256 at rho = 0.75, T = 1,
    dr_max = box/30, no adaptation -> acceptance 0.47 +- 0.03 (the
    monatomic reference's published ~48%)."""
    n = 256
    box = lj_box_for_density(n, 0.75)
    params = RunParams(temperature=1.0, r_cut=2.5, coulomb="none",
                       p_translate=1.0, dr_max=box / 30)
    gen = torch.Generator().manual_seed(1)
    mc = MonteCarlo(lj_system(n), params, device="cpu", generator=gen)
    state = mc.init_state(_liquid_start(n, box, 0), box=box, n_chains=16)
    state, _ = mc.run_block(state, 25)
    state, m = mc.run_block(state, 10)
    assert abs(m["acc_trans"] - 0.47) < 0.03, m
    assert m["drift_max_rel"] < 1e-4
    assert -5.6 < m["energy_mean"] / n < -4.8, m


def test_unported_routes_raise():
    """Tensor-parallel recomputes with a molecular cutoff are refused (the
    site-cutoff one runs: tests/test_torch_parallel.py), and neighbour
    lists on a kernel route; lists on the plain route, NPT, pressure_fd,
    Widom and sorted slabs run (tests/test_torch_nlist.py,
    test_torch_npt.py, test_torch_widom.py and test_torch_slabs.py hold
    them against JAX)."""
    system = spce_system(8)
    with pytest.raises(ValueError, match="jnp move path"):
        MonteCarlo(system, RunParams(nlist_width=8), device="cpu",
                   kernel="sweep")
    assert MonteCarlo(system, RunParams(nlist_width=8),
                      device="cpu").route == "plain"
    with pytest.raises(NotImplementedError, match="site cutoff"):
        MonteCarlo(system, RunParams(cutoff_mode="com"), device="cpu",
                   tp_mesh=object())
    npt = MonteCarlo(system, RunParams(coulomb="wolf", pressure=1e-5,
                                       p_volume=1.0), device="cpu")
    state = npt.init_state(cubic_lattice(8, 24.0), box=24.0, n_chains=2)
    state = npt.run_steps(state, 1)
    assert int(state.att[:, 2].sum()) == 2
    mc = MonteCarlo(system, RunParams(coulomb="wolf"), device="cpu")
    state = mc.init_state(cubic_lattice(8, 24.0), box=24.0, n_chains=2)
    assert mc.pressure_fd(state).shape == (2,)
    assert mc.widom(state, 4)["boltzmann_mean"].shape == (2,)
    state2, out = mc.widom_mega(state, 4)
    assert out["boltzmann_mean"].shape == (2,) and int(state2.step) == 12
    # a 750-water box where the JAX package's forced slab mode applies
    big = spce_system(750)
    mc = MonteCarlo(big, RunParams(slab_mode="force", dr_max=0.3),
                    device="cpu")
    mc.init_state(cubic_lattice(750, 40.0), box=40.0, n_chains=1)
    assert mc._slab_cfg is not None and mc.tables[0].W > 0
    # species-blocked mixtures now run: one whole-sweep launch per block
    mixed = dataclasses.replace(
        system, species=(("a", 4, 3), ("b", 4, 3)))
    mc = MonteCarlo(mixed, RunParams(r_cut=5.0), device="cpu")
    assert mc.route == "sweep" and len(mc.tables) == 2
    state = mc.init_state(cubic_lattice(8, 12.0), box=12.0, n_chains=2)
    state, m = mc.run_block(state, 1)
    assert int(state.step) == 8 and int(state.att.sum()) == 16
    assert m["drift_max_rel"] < 1e-4
