"""The port's observables.py on the CPU against the JAX package, and the
closed-form anchors of tests/test_io_observables.py.

* Every accumulator fed the same float64 states (made with numpy from a
  seed) agrees with its JAX counterpart to 1e-10 relative: RDF, masked
  RDF, dipole moments, S(k), NPT and energy fluctuations; the numpy
  functions (blocking_analysis, BlockAverager, dielectric_constant,
  kirkwood_buff_integral, heat_of_vaporization) agree to 1e-12.
* Closed forms: the SPC/E dipole, aligned molecules and periodic wrap;
  Bragg peaks of a perfect lattice; S(k) = 1 and g(r) = 1 for an ideal
  gas; the AR(1) autocorrelation time; the Kirkwood-Buff excluded volume;
  dH_vap = 0 for an ideal gas in two boxes.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu import observables as obs_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu_torch import observables as obs_t
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    SPCE_Q_H,
    SPCE_R_OH,
    SPCE_THETA,
    spce_system,
)
from metropolismontecarlo_tpu_torch.ops.quaternions import rotate_vectors
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

F64 = torch.float64
LJ = dict(strict_min_image=False, temperature=1.0, r_cut=2.0,
          cutoff_mode="site", coulomb="none", p_translate=1.0, dr_max=0.1,
          use_lrc=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _water_states(C=5, M=8, box=9.0, seed=0):
    """(port state, JAX state) of C chains of M rigid SPC/E waters at
    random poses and boxes, float64: the same numpy arrays on both."""
    rng = np.random.default_rng(seed)
    boxes = box * rng.uniform(0.95, 1.05, C)
    com = rng.uniform(0.0, 1.0, (C, M, 3)) * boxes[:, None, None]
    q = rng.normal(size=(C, M, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    system = spce_system(M)
    atoms = torch.tensor(com)[:, :, None, :] + rotate_vectors(
        torch.tensor(q), torch.tensor(np.array(system.body)))
    coords = np.zeros((C, 3, system.n_atoms_padded))
    coords[:, :, :3 * M] = atoms.reshape(C, 3 * M, 3).transpose(1, 2).numpy()
    coords[:, :, :3 * M] %= boxes[:, None, None]
    arrays = dict(coords=coords, com=com, box=boxes,
                  energy=rng.normal(-3e3, 40.0, C),
                  temp=rng.uniform(290.0, 310.0, C))
    st_t = SimpleNamespace(**{k: torch.tensor(v) for k, v in arrays.items()})
    st_j = SimpleNamespace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return st_t, st_j


@pytest.mark.parametrize("types", [(0, 0), (0, 1), (1, 1)])
def test_rdf_matches_jax(types):
    sys_t, sys_j = spce_system(8), water_j.spce_system(8)
    r_t = obs_t.RDFAccumulator(sys_t, *types, r_max=4.4, n_bins=30, chunk=2)
    r_j = obs_j.RDFAccumulator(sys_j, *types, r_max=4.4, n_bins=30, chunk=2)
    for seed in (0, 1):
        st_t, st_j = _water_states(seed=seed)
        r_t.update(st_t)
        r_j.update(st_j)
    (r1, g1), (r2, g2) = r_t.result(), r_j.result()
    np.testing.assert_allclose(r1, r2, rtol=1e-12)
    np.testing.assert_allclose(g1, g2, rtol=1e-10, atol=1e-12)
    assert g1.sum() > 0.0


def test_masked_rdf_matches_jax_and_constant_mask():
    sys_t, sys_j = spce_system(8), water_j.spce_system(8)
    st_t, st_j = _water_states(seed=2)
    rng = np.random.default_rng(3)
    ok = rng.random((5, sys_t.n_atoms_padded)) < 0.7
    m_t = obs_t.MaskedRDFAccumulator(sys_t, 0, 1, r_max=4.4, n_bins=30,
                                     chunk=2)
    m_j = obs_j.MaskedRDFAccumulator(sys_j, 0, 1, r_max=4.4, n_bins=30,
                                     chunk=2)
    m_t.update(st_t.coords, st_t.box, torch.tensor(ok))
    m_j.update(st_j.coords, st_j.box, jnp.asarray(ok))
    np.testing.assert_allclose(m_t.result()[1], m_j.result()[1],
                               rtol=1e-10, atol=1e-12)
    # an all-true mask on equal boxes is RDFAccumulator's normalisation
    st_t.box = torch.full((5,), 9.0, dtype=F64)
    full = torch.ones((5, sys_t.n_atoms_padded), dtype=torch.bool)
    m2 = obs_t.MaskedRDFAccumulator(sys_t, 0, 1, r_max=4.4, n_bins=30)
    m2.update(st_t.coords, st_t.box, full)
    r2 = obs_t.RDFAccumulator(sys_t, 0, 1, r_max=4.4, n_bins=30)
    r2.update(st_t)
    np.testing.assert_allclose(m2.result()[1], r2.result()[1], rtol=1e-12)


def test_dipole_and_structure_factor_match_jax():
    sys_t, sys_j = spce_system(8), water_j.spce_system(8)
    d_t = obs_t.DipoleAccumulator(sys_t, chunk=2)
    d_j = obs_j.DipoleAccumulator(sys_j, chunk=2)
    s_t = obs_t.StructureFactorAccumulator(sys_t, type_sel=0, n_max=3,
                                           chunk=2)
    s_j = obs_j.StructureFactorAccumulator(sys_j, type_sel=0, n_max=3,
                                           chunk=2)
    for seed in (4, 5):
        st_t, st_j = _water_states(seed=seed)
        d_t.update(st_t)
        d_j.update(st_j)
        s_t.update(st_t)
        s_j.update(st_j)
    a, b = d_t.result(), d_j.result()
    for k in ("epsilon", "g_kirkwood", "m2_mean"):
        assert a[k] == pytest.approx(float(b[k]), rel=1e-10), k
    np.testing.assert_allclose(a["m_mean"], b["m_mean"], rtol=1e-10,
                               atol=1e-12)
    assert a["n_samples"] == b["n_samples"] == 10
    (k1, s1), (k2, s2) = s_t.result(), s_j.result()
    np.testing.assert_allclose(k1, k2, rtol=1e-12)
    np.testing.assert_allclose(s1, s2, rtol=1e-10)
    np.testing.assert_array_equal(s_t.shells, s_j.shells)


def test_fluctuations_match_jax():
    n_t, n_j = obs_t.NPTFluctuations(0.0024), obs_j.NPTFluctuations(0.0024)
    e_t, e_j = obs_t.EnergyFluctuations(), obs_j.EnergyFluctuations()
    for seed in (6, 7, 8):
        st_t, st_j = _water_states(seed=seed)
        for acc, st in ((n_t, st_t), (n_j, st_j), (e_t, st_t), (e_j, st_j)):
            acc.update(st)
    for a, b in ((n_t.result(), n_j.result()), (e_t.result(), e_j.result())):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == pytest.approx(float(b[k]), rel=1e-10), k
    assert obs_t.excess_heat_capacity(5.0, 2.0, 0.5) == \
        obs_j.excess_heat_capacity(5.0, 2.0, 0.5) == 4.0


def test_host_functions_match_jax():
    rng = np.random.default_rng(9)
    x = np.cumsum(rng.normal(size=4096)) * 0.01 + rng.normal(size=4096)
    a, b = obs_t.blocking_analysis(x), obs_j.blocking_analysis(x)
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=1e-12), k
    av_t, av_j = obs_t.BlockAverager(), obs_j.BlockAverager()
    for v in x[:40]:
        av_t.add(e=float(v), n=1.0)
        av_j.add(e=float(v), n=1.0)
    for f in ("mean", "sem", "sem_blocking"):
        assert getattr(av_t, f)("e") == pytest.approx(
            getattr(av_j, f)("e"), rel=1e-12)
        assert getattr(av_t, f)("e", skip=8) == pytest.approx(
            getattr(av_j, f)("e", skip=8), rel=1e-12)
    m = rng.normal(size=3)
    assert obs_t.dielectric_constant(2.5, m, 1000.0, 300.0) == pytest.approx(
        obs_j.dielectric_constant(2.5, m, 1000.0, 300.0), rel=1e-12)
    r = np.linspace(0.01, 5.0, 300)
    g = 1.0 + np.exp(-r) * np.sin(3.0 * r)
    assert obs_t.kirkwood_buff_integral(r, g) == pytest.approx(
        obs_j.kirkwood_buff_integral(r, g), rel=1e-12)
    assert obs_t.kirkwood_buff_integral(r, g, r_upper=2.0) == \
        pytest.approx(obs_j.kirkwood_buff_integral(r, g, r_upper=2.0),
                      rel=1e-12)
    # a two-box state with numbers drawn from a seed
    C, cap = 6, 10
    arrays = dict(active=rng.random((C, 2, cap)) < 0.6,
                  box=rng.uniform(8.0, 12.0, (C, 2)),
                  energy=rng.normal(-500.0, 50.0, (C, 2)))
    p = rng.uniform(0.001, 0.01, (C, 2))
    h_t = obs_t.heat_of_vaporization(
        SimpleNamespace(**{k: torch.tensor(v) for k, v in arrays.items()}),
        torch.tensor(p))
    h_j = obs_j.heat_of_vaporization(
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in arrays.items()}), p)
    np.testing.assert_allclose(h_t, h_j, rtol=1e-12)


# ---------------- closed-form anchors ----------------------------------


def test_dipole_accumulator_spce_closed_forms():
    """|M| = mu = 2 q_H r_OH cos(theta / 2) for one molecule; aligned
    molecules add (g_K = 2); a molecule wrapped one image over leaves M
    unchanged."""
    mu = 2.0 * SPCE_Q_H * SPCE_R_OH * np.cos(np.deg2rad(SPCE_THETA) / 2.0)
    p = RunParams(strict_min_image=False, temperature=300.0, r_cut=5.0,
                  coulomb="none", use_lrc=False)
    q = np.array([[0.3, 0.5, -0.1, 0.8]])
    q /= np.linalg.norm(q)

    def state(com, n):
        mc = MonteCarlo(spce_system(n), p, device="cpu", dtype=F64)
        return mc.init_state(com, quat=np.repeat(q, n, 0), box=12.0,
                             n_chains=1)

    acc = obs_t.DipoleAccumulator(spce_system(1), chunk=1)
    acc.update(state(np.array([[3.0, 4.0, 5.0]]), 1))
    res = acc.result()
    np.testing.assert_allclose(np.sqrt(res["m2_mean"]), mu, rtol=1e-10)
    np.testing.assert_allclose(res["g_kirkwood"], 1.0, rtol=1e-10)
    com2 = np.array([[3.0, 3.0, 3.0], [9.0, 9.0, 9.0]])
    acc2 = obs_t.DipoleAccumulator(spce_system(2), chunk=1)
    st2 = state(com2, 2)
    acc2.update(st2)
    res2 = acc2.result()
    np.testing.assert_allclose(np.sqrt(res2["m2_mean"]), 2.0 * mu,
                               rtol=1e-10)
    np.testing.assert_allclose(res2["g_kirkwood"], 2.0, rtol=1e-10)
    wrapped = SimpleNamespace(**vars(st2))
    wrapped.coords = st2.coords.clone()
    wrapped.coords[:, :, 3:6] = (wrapped.coords[:, :, 3:6] + 12.0) % 12.0
    wrapped.com = st2.com.clone()
    acc3 = obs_t.DipoleAccumulator(spce_system(2), chunk=1)
    acc3.update(wrapped)
    np.testing.assert_allclose(acc3.result()["m2_mean"], res2["m2_mean"],
                               rtol=1e-10)
    eps = obs_t.dielectric_constant(1.0, np.zeros(3), 1000.0, 300.0)
    np.testing.assert_allclose(
        eps, 1.0 + 4.0 * np.pi / 3.0 * COULOMB_FACTOR / 3.0e5, rtol=1e-12)
    assert obs_t.dielectric_constant(1.0, np.array([1.0, 0, 0]), 1000.0,
                                     300.0) == pytest.approx(1.0, abs=1e-12)


def test_structure_factor_lattice_bragg_and_ideal_gas():
    """A perfect 4^3 lattice: S = N on the |n|^2 = 16 shell and 0 on
    |n|^2 = 1; uniform iid positions: S = 1 on every shell; the RDF of
    the same ideal gas is flat."""
    n, box = 64, 8.0
    mc = MonteCarlo(lj_system(n), RunParams(**LJ), device="cpu", dtype=F64)
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    st = mc.init_state(cubic_lattice(n, box), box=box, n_chains=2)
    acc = obs_t.StructureFactorAccumulator(lj_system(n), n_max=4, chunk=2)
    acc.update(st)
    k, s = acc.result()
    shells = list(acc.shells)
    i16, i1 = shells.index(16), shells.index(1)
    assert s[i16] == pytest.approx(float(n), rel=1e-8)
    assert abs(s[i1]) < 1e-8
    assert k[i1] == pytest.approx(2.0 * np.pi / box, rel=1e-12)

    box, chains = 10.0, 256
    rng = np.random.default_rng(5)
    com = torch.tensor(rng.uniform(0.0, box, (chains, n, 3)))
    coords = torch.zeros((chains, 3, lj_system(n).n_atoms_padded),
                         dtype=F64)
    coords[:, :, :n] = com.transpose(1, 2)
    gas = SimpleNamespace(coords=coords, com=com,
                          box=torch.full((chains,), box, dtype=F64))
    acc = obs_t.StructureFactorAccumulator(lj_system(n), n_max=4, chunk=32)
    acc.update(gas)
    assert np.all(np.abs(acc.result()[1] - 1.0) < 0.15)
    rdf = obs_t.RDFAccumulator(lj_system(n), 0, 0, r_max=box / 2,
                               n_bins=24, chunk=32)
    rdf.update(gas)
    assert np.all(np.abs(rdf.result()[1][4:] - 1.0) < 0.15)


def test_blocking_ar1_and_kirkwood_buff_anchors():
    rng = np.random.default_rng(3)
    phi, n = 0.9, 1 << 17
    eps = rng.normal(size=n)
    x = np.empty(n)
    x[0] = eps[0] / np.sqrt(1 - phi**2)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + eps[t]
    out = obs_t.blocking_analysis(x)
    tau_exact = (1 + phi) / (2 * (1 - phi))
    assert out["tau"] == pytest.approx(tau_exact, rel=0.25)
    assert out["sem"] == pytest.approx(
        out["sem_naive"] * np.sqrt(2 * tau_exact), rel=0.15)
    out_w = obs_t.blocking_analysis(rng.normal(size=1 << 14))
    assert out_w["sem"] < 1.25 * out_w["sem_naive"] and out_w["tau"] < 0.8
    with pytest.raises(ValueError):
        obs_t.blocking_analysis(np.ones(8))
    r = np.linspace(0.005, 8.0, 1600)
    assert obs_t.kirkwood_buff_integral(r, np.ones_like(r)) == 0.0
    assert obs_t.kirkwood_buff_integral(r, np.ones_like(r), r_upper=3.0) \
        == 0.0
    sigma = 1.5
    exact = -4.0 / 3.0 * np.pi * sigma**3
    got = obs_t.kirkwood_buff_integral(r, (r >= sigma).astype(np.float64))
    assert abs(got - exact) < 0.02 * abs(exact)


def test_heat_of_vaporization_ideal_zero():
    """Ideal gas: U = 0 and P v = kT in both boxes, so dH_vap = 0 through
    the port's Gibbs app and its pressure_fd."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble

    params = RunParams(temperature=1.4, r_cut=2.5, cutoff_mode="site",
                       coulomb="none", p_translate=1.0, dr_max=0.4,
                       use_lrc=False, p_volume=0.0, strict_min_image=False)
    g = MolGibbsEnsemble(lj_system(24, eps=0.0), params, p_transfer=0.4,
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))
    st = g.init(boxes=(5.0, 7.0), n_init=(10, 6), n_chains=4)
    st, _ = g.run_block(st, 300)
    dh = obs_t.heat_of_vaporization(st, g.pressure_fd(st))
    assert np.allclose(dh, 0.0, atol=1e-9), dh
