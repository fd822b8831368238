"""The port's monatomic TMMC (mc/tmmc.py make_tmmc, TMMC) and its ln Pi
estimator, on the CPU, against the JAX package.

* The estimator functions on the same numpy inputs: 1e-12 (both are the
  same float64 numpy arithmetic).
* Closed forms through the plain host path (float64): the ideal gas's
  ln Pi(N) = N ln(zV) - ln N! within 1e-8, a strong bias leaves it
  unchanged, the temperature extension leaves it unchanged (U = 0).
* mega="full" against JAX make_tmmc(mega="interpret_full"), whose
  interpreter PRNG returns zeros: zero uniforms and deletion scores; the
  tolerances of tests/test_torch_tmmc_mol.py.
* eta = 0 reproduces the muVT build (mc/gcmc.py) bit for bit on every
  route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

from metropolismontecarlo_tpu.mc import tmmc as tmmc_j
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gcmc as gcmc_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc import tmmc as tmmc_t
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op

F64, F32 = torch.float64, torch.float32
LJ = dict(strict_min_image=False, temperature=1.2, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.4, dr_max=0.4,
          use_lrc=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _ideal_lnpi(zv, nmax):
    n = np.arange(nmax + 1)
    return n * np.log(zv) - gammaln(n + 1.0)


def _max_dev(lnpi, ref, fin):
    lnpi, ref = lnpi[fin], ref[fin]
    return np.max(np.abs((lnpi - lnpi[0]) - (ref - ref[0])))


# ---------------- the estimator, against JAX's --------------------------


def _random_cmat(seed, cap=30):
    rng = np.random.default_rng(seed)
    cm = rng.uniform(0.0, 5.0, (cap + 1, 3))
    cm[:3] = 0.0                       # unvisited low rows
    cm[17, 1] = 0.0                    # a broken edge: two runs, keep longer
    cm[cap, 1] = 0.0
    return cm


@pytest.mark.parametrize("seed", [0, 1])
def test_lnpi_bias_and_reweight_match_jax(seed):
    cm = _random_cmat(seed)
    lnpi, vis = tmmc_t.lnpi_from_cmat(cm)
    lnpi_j, vis_j = tmmc_j.lnpi_from_cmat(cm)
    np.testing.assert_array_equal(vis, vis_j)
    np.testing.assert_allclose(lnpi[vis], lnpi_j[vis_j], rtol=1e-12,
                               atol=1e-12)
    assert np.isneginf(lnpi[~vis]).all()
    np.testing.assert_allclose(tmmc_t.bias_from_lnpi(lnpi),
                               tmmc_j.bias_from_lnpi(lnpi_j), rtol=1e-12,
                               atol=1e-12)
    for z_new in (0.3, 2.0):
        a = tmmc_t.reweight_lnpi(lnpi, 1.0, z_new)
        b = tmmc_j.reweight_lnpi(lnpi_j, 1.0, z_new)
        np.testing.assert_allclose(a[vis], b[vis], rtol=1e-12, atol=1e-12)
    assert np.all(tmmc_t.bias_from_lnpi(np.full(4, -np.inf)) == 0.0)
    with pytest.raises(ValueError, match="no measured transitions"):
        tmmc_t.lnpi_from_cmat(np.zeros((10, 3)))


def _double_gaussian():
    """ln Pi at z0 = 0.03 of two Gaussians of equal weight at z* = 0.07
    (tests/test_tmmc.py)."""
    n = np.arange(301, dtype=np.float64)
    lnpi_star = np.logaddexp(-0.5 * ((n - 20.0) / 6.0) ** 2 - np.log(6.0),
                             -0.5 * ((n - 220.0) / 12.0) ** 2 - np.log(12.0))
    return lnpi_star + n * np.log(0.03 / 0.07)


def test_coexistence_and_surface_tension_match_jax():
    lnpi = _double_gaussian()
    a = tmmc_t.coexistence(lnpi, 0.03, 343.0)
    b = tmmc_j.coexistence(lnpi, 0.03, 343.0)
    for k in ("z_coex", "rho_vap", "rho_liq"):
        assert a[k] == pytest.approx(b[k], rel=1e-12), k
    assert abs(a["dlnw"] - b["dlnw"]) < 1e-12
    np.testing.assert_allclose(a["lnpi_coex"], b["lnpi_coex"], rtol=1e-12,
                               atol=1e-12)
    assert a["z_coex"] == pytest.approx(0.07, rel=1e-3)
    # the Binder estimate of a piecewise barrier with a noise dimple
    n = np.arange(241, dtype=np.float64)
    B, box, temp = 14.0, 7.0, 0.9
    lp = np.full(241, -B)
    lp[:41] = -B * np.abs(n[:41] - 20.0) / 20.0
    lp[200:] = -B * np.abs(n[200:] - 220.0) / 20.0
    lp[100:113] += 0.9 * np.cos(np.pi * (n[100:113] - 106.0) / 6.0) + 0.9
    g = tmmc_t.surface_tension(lp, box, temp)
    assert g == pytest.approx(tmmc_j.surface_tension(lp, box, temp),
                              rel=1e-12)
    assert g == pytest.approx(temp * B / (2 * box ** 2), rel=1e-12)
    with pytest.raises(ValueError, match="bracketed"):
        tmmc_t.coexistence(lnpi, 0.03, 343.0, z_lo=0.5, z_hi=1.0)


def test_basin_split_prefers_the_deepest_valley_as_jax_does():
    n = np.arange(201, dtype=np.float64)
    lnpi = np.logaddexp(-0.5 * ((n - 160.0) / 8.0) ** 2,
                        -12.0 - 0.5 * ((n - 20.0) / 6.0) ** 2)
    lnpi[140:153] += 1.3 * np.cos(np.pi * (n[140:153] - 146) / 6.0) - 1.3
    a = tmmc_t._basin_stats(lnpi, n_sep=10, min_barrier=1.0)
    b = tmmc_j._basin_stats(lnpi, n_sep=10, min_barrier=1.0)
    np.testing.assert_allclose(a, b, rtol=1e-12)
    assert a[2] == pytest.approx(20.0, abs=2.0)
    assert a[3] == pytest.approx(160.0, abs=2.0)
    with pytest.raises(ValueError, match="single-basin"):
        tmmc_t._basin_stats(-0.5 * ((n - 50.0) / 9.0) ** 2)


@pytest.mark.parametrize("second_order", [True, False])
def test_energy_moments_and_temperature_extension_match_jax(second_order):
    rng = np.random.default_rng(3)
    cap = 20
    cnt = rng.integers(0, 6, cap + 1).astype(np.float64)
    cnt[[4, 9]] = [0.0, 1.0]
    e = rng.normal(-3.0 * np.arange(cap + 1), 1.0, (4, cap + 1))
    uh = np.stack([cnt, cnt * e.mean(0), cnt * (e ** 2).mean(0)], 1)
    for a, b in zip(tmmc_t.u_moments(uh), tmmc_j.u_moments(uh)):
        np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
    lnpi = tmmc_t.lnpi_from_cmat(_random_cmat(5, cap))[0]
    a = tmmc_t.reweight_lnpi_temperature(lnpi, uh, 1.2, 1.1, second_order)
    b = tmmc_j.reweight_lnpi_temperature(lnpi, uh, 1.2, 1.1, second_order)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=1e-12)


# ---------------- closed forms through the plain host path -------------


def _tmmc(system, seed, **kw):
    return tmmc_t.TMMC(system, RunParams(**LJ), device="cpu",
                       generator=_gen(seed), **kw)


def test_ideal_gas_lnpi_is_exact_and_bias_invariant():
    """eps = 0: the deposits are closed forms of N, so ln Pi is exact to
    f64 rounding; a strong bias toward large N leaves it unchanged and
    widens the visited range."""
    box, z = 5.0, 0.08
    t0 = _tmmc(lj_system(1, eps=0.0), 0, activity=z, capacity=48)
    st = t0.init(box, 10, 16)
    for _ in range(3):
        st, s0 = t0.run_block(st, 400, drift_tol=1e-9, update_bias=False)
    t1 = _tmmc(lj_system(1, eps=0.0), 1, activity=z, capacity=48)
    t1.eta = 0.7 * np.arange(49, dtype=np.float64)
    st1 = t1.init(box, 10, 16)
    for _ in range(3):
        st1, s1 = t1.run_block(st1, 400, update_bias=False)
    exact = _ideal_lnpi(z * box ** 3, 48)
    for t in (t0, t1):
        lnpi = t.lnpi()
        fin = np.isfinite(lnpi)
        assert fin.sum() > 15
        assert _max_dev(lnpi, exact, fin) < 1e-8
    both = np.isfinite(t0.lnpi()) & np.isfinite(t1.lnpi())
    assert _max_dev(t0.lnpi(), t1.lnpi(), both) < 1e-8
    assert s1["n_max"] > s0["n_max"] + 5
    # U = 0: the temperature extension changes nothing
    out = tmmc_t.reweight_lnpi_temperature(t0.lnpi(), t0.uhist, 1.2, 1.0)
    fin = np.isfinite(t0.lnpi())
    assert _max_dev(out, t0.lnpi(), fin) < 1e-12
    assert t0.u_moments()[0][fin].max() == 0.0


def test_self_tuned_bias_flattens_the_interacting_walk():
    """Interacting LJ with the bias refreshed per block: ln Pi is finite
    on a contiguous range and eta = -ln Pi there (gauged at its start)."""
    t = _tmmc(lj_system(1), 2, activity=0.05, capacity=24)
    st = t.init(4.5, np.linspace(0, 20, 8).astype(np.int64), 8)
    for _ in range(3):
        st, stats = t.run_block(st, 150, drift_tol=1e-9)
    lnpi = t.lnpi()
    fin = np.where(np.isfinite(lnpi))[0]
    assert np.all(np.diff(fin) == 1) and fin.size >= 10
    np.testing.assert_allclose(t.eta[fin], -(lnpi[fin] - lnpi[fin[0]]),
                               atol=1e-12)
    assert stats["visited_frac"] > 0.4 and stats["acc_trans"] > 0.0


# ---------------- the kernel route against the interpreted JAX kernel --


def _zero_draws(monkeypatch, mags, umags):
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))

    def twin(*a, **k):
        scores = torch.zeros((a[0].shape[0], k.get("n_exch", 0),
                              a[1].shape[1]))
        out = sweep_op.sweep_plain(*a, magnitude=True, scores=scores, **k)
        mags.append(out[4][:, sweep_op.N_STATS])
        if k.get("tmmc"):
            umags.append(out[10])
        return out[:4] + (out[4][:, :sweep_op.N_STATS],) + out[5:10]

    monkeypatch.setattr(moves_t.sweep_op, "sweep", twin)


@pytest.mark.parametrize("lrc", [True, False])
def test_mega_full_matches_jax_interpret_full(monkeypatch, lrc):
    kw = dict(LJ, temperature=1.5, p_translate=0.5, dr_max=0.3, use_lrc=lrc)
    if not lrc:
        kw["lj_shift"] = "linear"
    cap, box, C = 16, 4.0, 4
    init_j, run_j, _ = tmmc_j.make_tmmc(mono_j.lj_system(16), RunParamsJ(**kw),
                                        0.05, cap, jnp.float32,
                                        mega="interpret_full")
    st_j = init_j(jax.random.PRNGKey(0), box, 8, C)
    eta = np.zeros(cap + 1)
    st_j2, cm_j, uh_j = run_j(st_j, eta, 64)

    mags, umags = [], []
    _zero_draws(monkeypatch, mags, umags)
    init_t, run_t, _ = tmmc_t.make_tmmc(lj_system(16), RunParams(**kw), 0.05,
                                        cap, F32, mega="full", device="cpu",
                                        generator=_gen())
    st = bridge.mono_gcmc_state_from_numpy(
        {f: np.asarray(getattr(st_j, f)) for f in st_j._fields
         if f != "key"}, "cpu")
    e0 = st.energy.numpy().copy()
    st2, cm, uh = run_t(st, eta, 64)
    assert len(mags) == 2                        # 2 cycles of 16 + 16
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)), f)
    mag = torch.stack(mags).sum(0).numpy()
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)
    on = np.asarray(st_j2.active)
    np.testing.assert_allclose(st2.com.numpy()[on],
                               np.asarray(st_j2.com)[on], atol=1e-5)
    cm_j, uh_j = np.asarray(cm_j, np.float64), np.asarray(uh_j, np.float64)
    cm, uh = cm.double().numpy(), uh.double().numpy()
    count = uh_j[..., 0]
    np.testing.assert_array_equal(uh[..., 0], count)
    assert count.sum() == C * 2 * 16
    assert (np.abs(cm - cm_j).max(-1) <= 1e-4 * count).all()
    umag = torch.stack(umags).sum(0).double().numpy()
    assert (np.abs(uh[..., 1] - uh_j[..., 1]) <= 2e-5 * umag[..., 0]).all()
    # and the port's own recompute agrees with what it carried
    e_full = gcmc_t.make_slot_lj(lj_system(16), RunParams(**kw), cap, F64,
                                 "cpu")[1](st2.com.double(), st2.active,
                                           st2.box.double())
    np.testing.assert_allclose(e_full.numpy(), st2.energy.numpy(),
                               rtol=2e-5, atol=2e-5 * mag.max())


def test_mega_full_ideal_gas_lnpi_is_exact():
    """The kernel route's deposits (here its plain twin's, f32) keep the
    ideal-gas ln Pi exact to f32 rounding."""
    box, z = 5.0, 0.08
    t = _tmmc(lj_system(1, eps=0.0), 3, activity=z, capacity=48, dtype=F32,
              mega="full")
    st = t.init(box, np.linspace(0, 44, 8).astype(np.int64), 8)
    for _ in range(2):
        st, _ = t.run_block(st, 240)
    lnpi = t.lnpi()
    fin = np.isfinite(lnpi)
    assert fin.sum() > 30
    assert _max_dev(lnpi, _ideal_lnpi(z * box ** 3, 48), fin) < 1e-4


# ---------------- eta = 0 is the muVT build ----------------------------


@pytest.mark.parametrize("mega,dtype", [(None, F64), (True, F32),
                                        ("full", F32)])
def test_zero_bias_reproduces_the_gcmc_build(mega, dtype):
    params = RunParams(**dict(LJ, temperature=1.5, p_translate=0.5,
                              use_lrc=True))
    kw = dict(dtype=dtype, mega=mega, device="cpu")
    init_g, run_g, _ = gcmc_t.make_gcmc(lj_system(1), params, 0.05, 24, **kw,
                                        generator=_gen(5))
    init_t, run_t, _ = tmmc_t.make_tmmc(lj_system(1), params, 0.05, 24, **kw,
                                        generator=_gen(5))
    st_g, st_t = init_g(4.5, 10, 6), init_t(4.5, 10, 6)
    for _ in range(2):
        st_g = run_g(st_g, 48)
        st_t, cmat, uhist = run_t(st_t, np.zeros(25), 48)
    for f in dataclasses.fields(st_g):
        assert torch.equal(getattr(st_g, f.name), getattr(st_t, f.name)), \
            f.name
    per_chain = 48 if mega is None else 24
    assert torch.equal(uhist[..., 0].sum(1),
                       torch.full((6,), float(per_chain), dtype=dtype))
    np.testing.assert_allclose(cmat.sum((1, 2)).numpy(), per_chain,
                               rtol=1e-6)
    assert int((st_t.acc[:, 1] + st_t.acc[:, 2]).sum()) > 0


@pytest.mark.parametrize("kw,match", [
    (dict(mega=True), "float32"),
    (dict(mega="full", dtype=F32, p_translate=1.0), "p_translate"),
    (dict(mega=True, dtype=F32, p_translate=0.0), "p_translate"),
    (dict(mega="interpret_full", dtype=F32), "mega must be"),
])
def test_tmmc_refusals(kw, match):
    kw = dict(kw)
    params = RunParams(**dict(LJ, p_translate=kw.pop("p_translate", 0.4)))
    with pytest.raises(ValueError, match=match):
        tmmc_t.make_tmmc(lj_system(1), params, 0.05, 16, device="cpu", **kw)
