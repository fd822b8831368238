"""The port's free-energy estimators (mc/fep.py, mc/mbar.py) on the CPU,
against the JAX package and against closed forms.

* mbar: ports of tests/test_mbar.py (Gaussian states, K = 2 MBAR = BAR,
  prediction states and +inf entries, target weights, temperature,
  activity and joint muVT reweighting, the unconverged refusal), and the
  port's copy returning JAX's numbers to 1e-12 on the same inputs.
* fep: ports of tests/test_fep.py: the BAR solver's closed forms;
  insertion / deletion reciprocity for every Coulomb style and for LJ
  with the tail; the tagged systems at lambda (1, 1) and (0, 0); ghost
  insertions into the decoupled stage equal stage deletions; deletions
  telescope to energy differences; the exact lambda basis; cross-lambda
  works; BAR against Widom on a small LJ fluid.  Also deletion_du and
  the decoupled ghosts against JAX's on the same float64 states (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import fep as fep_j
from metropolismontecarlo_tpu.mc import mbar as mbar_j
from metropolismontecarlo_tpu.mc.driver import MonteCarlo as MonteCarloJ
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import fep, mbar
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gcmc import reweight_activity
from metropolismontecarlo_tpu_torch.mc.widom import make_widom_fn, mu_excess
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops.quaternions import random_quaternion

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- mbar -------------------------------------------------


def gaussian_states(sigmas, mus, n, rng):
    """Samples and exact reduced potentials of states u_k(x) = (x -
    mu_k)^2 / (2 sigma_k^2): f_k - f_0 = -ln(sigma_k / sigma_0)."""
    xs = [rng.normal(m, s, n) for m, s in zip(mus, sigmas)]
    pooled = np.concatenate(xs)
    u_kn = np.stack([(pooled - m) ** 2 / (2 * s ** 2)
                     for m, s in zip(mus, sigmas)])
    f_exact = -np.log(np.asarray(sigmas) / sigmas[0])
    return pooled, u_kn, f_exact


def test_mbar_gaussian_closed_form():
    rng = np.random.default_rng(0)
    _, u_kn, f_exact = gaussian_states([1.0, 1.5, 2.5, 4.0],
                                       [0.0, 0.5, 1.0, 2.0], 20000, rng)
    f = mbar.mbar_solve(u_kn, [20000] * 4)
    np.testing.assert_allclose(f, f_exact, atol=0.05)


def test_two_state_mbar_equals_bar():
    rng = np.random.default_rng(1)
    n = 4000
    _, u_kn, _ = gaussian_states([1.0, 2.0], [0.0, 1.0], n, rng)
    f = mbar.mbar_solve(u_kn, [n, n], tol=1e-13)
    x = fep.bar_solve((u_kn[1] - u_kn[0])[:n], (u_kn[0] - u_kn[1])[n:])
    assert abs(f[1] - x) < 1e-8


def test_mbar_prediction_state_and_inf_entries():
    rng = np.random.default_rng(2)
    sigmas, n = [1.0, 2.0, 3.0], 20000
    pooled = np.concatenate([rng.normal(0.0, sigmas[k], n) for k in (0, 1)])
    u_kn = np.stack([pooled ** 2 / (2 * s ** 2) for s in sigmas])
    f = mbar.mbar_solve(u_kn, [n, n, 0])
    np.testing.assert_allclose(f, -np.log(np.asarray(sigmas)), atol=0.05)
    u_inf = u_kn.copy()
    u_inf[0, 5] = np.inf
    assert np.all(np.isfinite(mbar.mbar_solve(u_inf, [n, n, 0])))


def test_mbar_target_weights_reproduce_direct_mean():
    rng = np.random.default_rng(3)
    n = 30000
    pooled, u_kn, _ = gaussian_states([1.0, 1.6], [0.0, 0.0], n, rng)
    f = mbar.mbar_solve(u_kn, [n, n])
    f1, w, ess = mbar.mbar_weights(u_kn[1], f, u_kn, [n, n])
    assert abs(f1 - f[1]) < 1e-10
    assert ess > n
    assert abs(np.sum(w * pooled ** 2) - 1.6 ** 2) < 4 * 1.6 ** 2 \
        / np.sqrt(ess)


def test_temperature_reweighting_harmonic():
    """E = x^2 / 2: <E>(T) = T / 2 and C = 1 / 2 at every T."""
    rng = np.random.default_rng(4)
    temps = np.asarray([0.8, 1.0, 1.25, 1.6, 2.0])
    s = 40000
    e = 0.5 * rng.normal(0.0, np.sqrt(temps)[:, None], (temps.size, s)) ** 2
    targets = np.asarray([0.9, 1.1, 1.4, 1.8])
    out = mbar.reweight_temperature(e, temps, targets)
    np.testing.assert_allclose(out["e_mean"], targets / 2, rtol=0.02)
    np.testing.assert_allclose(out["c"], 0.5, rtol=0.05)
    assert np.all(out["ess"] > s)
    db = 1.0 / targets[1] - 1.0 / targets[0]
    secant = (out["f"][1] - out["f"][0]) / db
    mid_e = 0.5 * (out["e_mean"][0] + out["e_mean"][1])
    assert abs(secant - mid_e) < 0.05 * abs(mid_e) + 0.02
    at_rung = mbar.reweight_temperature(e, temps, temps[2:3])
    assert abs(at_rung["e_mean"][0] - e[2].mean()) < 6 * e[2].std() \
        / np.sqrt(s)
    assert mbar.reweight_temperature(e, temps, [8.0])["ess"][0] \
        < 0.05 * e.size


def test_activity_pooling_ideal_gas_and_k1_histogram():
    """Ideal gas: N ~ Poisson(z V) at every activity, also between the
    pooled rungs (8000 samples each: the pooled mean's standard error at
    the targets is ~0.5%, the variance's ~4%; gates 2% and 15%); a one-run
    pool is histogram reweighting (mc/gcmc.reweight_activity) to solver
    tolerance."""
    rng = np.random.default_rng(6)
    v, zs = 50.0, np.asarray([0.5, 1.0, 2.0])
    n_kn = np.stack([rng.poisson(z * v, 8000) for z in zs])
    out = mbar.reweight_activity_mbar(n_kn, zs, [0.7, 1.5])
    np.testing.assert_allclose(out["n_mean"], np.asarray([0.7, 1.5]) * v,
                               rtol=0.02)
    np.testing.assert_allclose(out["n_var"], np.asarray([0.7, 1.5]) * v,
                               rtol=0.15)
    assert np.all(out["ess"] > 0.02 * n_kn.size)
    np.testing.assert_allclose(out["pn"].sum(axis=1), 1.0, atol=1e-12)
    assert mbar.reweight_activity_mbar(n_kn, zs, [20.0])["ess"][0] \
        < 0.01 * n_kn.size
    n = rng.poisson(30.0, 5000)
    hist = np.bincount(n, minlength=n.max() + 1)
    for z_new in (0.8, 1.3):
        ref = reweight_activity(hist, 1.0, z_new)
        got = mbar.reweight_activity_mbar(n[None, :], [1.0], [z_new])
        assert abs(got["n_mean"][0] - ref["n_mean"]) < 1e-9
        assert abs(got["n_var"][0] - ref["n_var"]) < 1e-7


def test_joint_muvt_reweighting():
    """Exponential-molecule toy model: N ~ Poisson(z V T), <E> = <N> T at
    every (T, z)."""
    rng = np.random.default_rng(8)
    v, s = 30.0, 20000
    states = [(0.8, 1.0), (1.0, 1.0), (1.0, 1.5), (1.25, 1.2)]
    e_kn, n_kn = [], []
    for t, z in states:
        n = rng.poisson(z * v * t, s)
        e_kn.append(np.asarray([rng.exponential(t, k).sum() for k in n]))
        n_kn.append(n.astype(np.float64))
    temps, zs = [t for t, _ in states], [z for _, z in states]
    targets = [(0.9, 1.2), (1.1, 1.1), (1.0, 1.25)]
    out = mbar.reweight_muvt(np.stack(e_kn), np.stack(n_kn), temps, zs,
                             targets)
    exact_n = np.asarray([z * v * t for t, z in targets])
    np.testing.assert_allclose(out["n_mean"], exact_n, rtol=0.02)
    np.testing.assert_allclose(out["e_mean"], np.asarray(
        [t for t, _ in targets]) * exact_n, rtol=0.03)
    np.testing.assert_allclose(out["n_var"], exact_n, rtol=0.06)
    assert np.all(out["ess"] > 0.05 * s)
    far = mbar.reweight_muvt(np.stack(e_kn), np.stack(n_kn), temps, zs,
                             [(3.0, 5.0)])
    assert far["ess"][0] < 0.01 * 4 * s
    with pytest.raises(ValueError, match="positive"):
        mbar.reweight_muvt(np.stack(e_kn), np.stack(n_kn), temps, zs,
                           [(0.0, 1.0)])


def test_mbar_unconverged_raises_and_copy_matches_jax():
    rng = np.random.default_rng(5)
    _, u_kn, _ = gaussian_states([1.0, 2.0], [0.0, 0.0], 100, rng)
    with pytest.raises(RuntimeError):
        mbar.mbar_solve(u_kn, [100, 100], max_iter=1)
    _, u_kn, _ = gaussian_states([1.0, 1.3, 2.0], [0.0, 0.4, 0.1], 500, rng)
    f = mbar.mbar_solve(u_kn, [500] * 3)
    np.testing.assert_allclose(f, mbar_j.mbar_solve(u_kn, [500] * 3),
                               rtol=0, atol=1e-12)
    got = mbar.mbar_weights(u_kn[1] * 0.9, f, u_kn, [500] * 3)
    want = mbar_j.mbar_weights(u_kn[1] * 0.9, f, u_kn, [500] * 3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)


# ---------------- the BAR solver ---------------------------------------


def test_bar_solver_closed_forms():
    """Identical states give 0; Gaussian works give m - sigma^2 / 2;
    +inf forward works count as attempts with zero weight."""
    assert fep.bar_solve(np.zeros(100), np.zeros(37)) == pytest.approx(
        0.0, abs=1e-9)
    rng = np.random.default_rng(0)
    m, sig = 3.0, 1.5
    df = fep.bar_solve(rng.normal(m, sig, 200_000),
                       rng.normal(sig ** 2 - m, sig, 200_000))
    assert df == pytest.approx(m - sig ** 2 / 2.0, abs=0.02)
    w_f = np.concatenate([np.zeros(50), np.full(50, np.inf)])
    assert fep.bar_solve(w_f, np.zeros(100)) == pytest.approx(np.log(2.0),
                                                              abs=1e-9)
    assert fep.bar_mu_ex(np.zeros(4), np.zeros(4, bool), np.zeros(4),
                         2.0) == pytest.approx(0.0, abs=1e-9)


# ---------------- deletion energies and reciprocity --------------------


STYLES = [
    dict(coulomb="ewald"),
    dict(coulomb="ewald", ewald_surface=True),
    dict(coulomb="wolf", wolf_style="ref"),
    dict(coulomb="bare", use_lrc=False),
]


def _ids(kw):
    return "-".join(f"{a}={b}" for a, b in kw.items())


def _mc(system, params):
    return MonteCarlo(system, params, device="cpu", dtype=F64,
                      kernel="plain", recompute_chunk=1)


def _water_poses(m, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.tensor(cubic_lattice(m, 12.0), dtype=F64),
            random_quaternion(gen, (m,), dtype=F64))


@pytest.mark.parametrize("kw", STYLES, ids=_ids)
def test_insertion_deletion_reciprocity_water(kw):
    """A ghost water at pose X inserted into the 8-molecule state costs
    exactly what deleting that molecule from the 9-molecule state returns
    (every per-style term), and deletion_du equals JAX's on the same
    state (float64, 1e-10)."""
    box, m = 12.0, 8
    params = RunParams(strict_min_image=False, temperature=300.0, r_cut=5.0,
                       cutoff_mode="site", **kw)
    sys8, sys9 = spce_system(m), spce_system(m + 1)
    com8, quat8 = _water_poses(m, 11)
    com_t = torch.tensor([3.3, 7.1, 9.2], dtype=F64)
    quat_t = random_quaternion(torch.Generator().manual_seed(101), (),
                               dtype=F64)
    mc8 = _mc(sys8, params)
    state8 = mc8.init_state(com8, quat8, box, n_chains=1)
    widom_du, _ = make_widom_fn(sys8, params, mc8.kvecs, mc8.kweights,
                                device="cpu", dtype=F64, chunk=1)
    du_ins, ovr = widom_du(state8, com_t[None, None], quat_t[None, None])
    assert not bool(ovr[0, 0])

    com9 = torch.cat([com8, com_t[None]])
    quat9 = torch.cat([quat8, quat_t[None]])
    mc9 = _mc(sys9, params)
    state9 = mc9.init_state(com9, quat9, box, n_chains=1)
    deletion_du = fep.make_deletion_fn(sys9, params, mc9.kvecs, mc9.kweights,
                                       device="cpu", dtype=F64, chunk=1)
    du_del, ovr_del = deletion_du(state9)
    assert du_del.shape == (1, m + 1) and not bool(ovr_del[0, m])
    assert float(du_del[0, m]) == pytest.approx(float(du_ins[0, 0]),
                                                rel=1e-8)

    mc_j = MonteCarloJ(water_j.spce_system(m + 1), RunParamsJ(
        strict_min_image=False, temperature=300.0, r_cut=5.0,
        cutoff_mode="site", **kw), dtype=jnp.float64, pallas=False,
        recompute_chunk=1)
    st_j = mc_j.init_state(jax.random.PRNGKey(0), com9.numpy(),
                           quat=quat9.numpy(), box=box, n_chains=1)
    want, _ = fep_j.make_deletion_fn(mc_j.system, mc_j.params, mc_j.kvecs,
                                     mc_j.kweights, dtype=jnp.float64,
                                     chunk=1)(st_j)
    np.testing.assert_allclose(du_del.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-8)


def test_insertion_deletion_reciprocity_lj():
    """One-site LJ with the tail: the tail increment of insertion equals
    the tail decrement of deletion."""
    n, box = 32, 6.0
    params = RunParams(strict_min_image=False, temperature=1.0, r_cut=2.5,
                       coulomb="none", use_lrc=True)
    com_n = torch.tensor(cubic_lattice(n, box), dtype=F64)
    com_t = torch.tensor([0.71, 2.9, 4.13], dtype=F64)
    s_n = _mc(lj_system(n), params).init_state(com_n, box=box, n_chains=1)
    widom_du, _ = make_widom_fn(lj_system(n), params, None, None,
                                device="cpu", dtype=F64, chunk=1)
    q1 = torch.tensor([[[1.0, 0.0, 0.0, 0.0]]], dtype=F64)
    du_ins, _ = widom_du(s_n, com_t[None, None], q1)
    s_n1 = _mc(lj_system(n + 1), params).init_state(
        torch.cat([com_n, com_t[None]]), box=box, n_chains=1)
    du_del, _ = fep.make_deletion_fn(lj_system(n + 1), params, None, None,
                                     device="cpu", dtype=F64, chunk=1)(s_n1)
    assert float(du_del[0, n]) == pytest.approx(float(du_ins[0, 0]),
                                                rel=1e-10)


# ---------------- staged decoupling ------------------------------------


def _water9_states(kw, lj_scale, q_scale):
    """(params, sys_tag, mc at lambda, state at lambda, mc at 0, state at
    0, tagged pose): 8 lattice waters and 1 tagged water; the lambda = 0
    state's inert tagged molecule parked elsewhere."""
    box, m = 12.0, 8
    params = RunParams(strict_min_image=False, temperature=300.0, r_cut=5.0,
                       cutoff_mode="site", **kw)
    sys_tag = fep.tag_last_molecule(spce_system(m + 1), lj_scale, q_scale)
    sys_0 = fep.tag_last_molecule(spce_system(m + 1), 0.0, 0.0)
    com8, quat8 = _water_poses(m, 11)
    com_t = torch.tensor([3.3, 7.1, 9.2], dtype=F64)
    quat_t = random_quaternion(torch.Generator().manual_seed(101), (),
                               dtype=F64)
    com9 = torch.cat([com8, com_t[None]])
    quat9 = torch.cat([quat8, quat_t[None]])
    mc_l = _mc(sys_tag, params)
    state_l = mc_l.init_state(com9, quat9, box, n_chains=1)
    mc_0 = _mc(sys_0, params)
    com9_far = com9.clone()
    com9_far[m] = torch.tensor([1.0, 1.0, 1.0], dtype=F64)
    state_0 = mc_0.init_state(com9_far, quat9, box, n_chains=1)
    return params, sys_tag, mc_l, state_l, mc_0, state_0, com_t, quat_t


def test_tagged_systems_at_full_and_zero_coupling():
    """lambda = (1, 1) leaves the energy of the untagged system; lambda =
    (0, 0) is the (N - 1)-molecule system, even with the tagged molecule
    on top of another one."""
    box = 12.0
    params = RunParams(strict_min_image=False, temperature=300.0, r_cut=5.0,
                       cutoff_mode="site", coulomb="ewald")
    com, quat = _water_poses(9, 3)
    e = [float(_mc(s, params).init_state(com, quat, box, 1).energy[0])
         for s in (spce_system(9), fep.tag_last_molecule(spce_system(9),
                                                         1.0, 1.0))]
    assert e[1] == pytest.approx(e[0], rel=1e-12)
    com8, quat8 = _water_poses(8, 5)
    e8 = float(_mc(spce_system(8), params).init_state(com8, quat8, box,
                                                      1).energy[0])
    com9 = torch.cat([com8, com8[:1]])
    quat9 = torch.cat([quat8, random_quaternion(
        torch.Generator().manual_seed(7), (1,), dtype=F64)])
    st0 = _mc(fep.tag_last_molecule(spce_system(9), 0.0, 0.0),
              params).init_state(com9, quat9, box, 1)
    assert np.isfinite(float(st0.energy[0]))
    assert float(st0.energy[0]) == pytest.approx(e8, rel=1e-12)
    blocks = fep.tag_last_molecule(spce_system(9), 0.5, 0.5).species
    assert [b[1:] for b in blocks] == [(8, 3), (1, 3)]


@pytest.mark.parametrize("kw", STYLES[:1] + STYLES[2:], ids=_ids)
def test_ghost_insertion_matches_stage_deletion(kw):
    """The leg-0 works: a lambda-scaled ghost inserted into the decoupled
    state costs what make_deletion_fn reports on the coupled state at the
    same pose; both equal JAX's (float64)."""
    (params, sys_tag, mc_l, state_l, mc_0, state_0, com_t,
     quat_t) = _water9_states(kw, 0.37, 0.61)
    du_del, _ = fep.make_deletion_fn(sys_tag, params, mc_l.kvecs,
                                     mc_l.kweights, device="cpu", dtype=F64,
                                     chunk=1, species=-1)(state_l)
    ghost = fep.make_decoupled_insertion_fn(sys_tag, params, mc_0.kvecs,
                                            mc_0.kweights, device="cpu",
                                            dtype=F64, chunk=1)
    du_ins, ovr = ghost(state_0, com_t[None, None], quat_t[None, None])
    assert not bool(ovr[0, 0])
    assert float(du_ins[0, 0]) == pytest.approx(float(du_del[0, 0]),
                                                rel=1e-9)
    sys_j = fep_j.tag_last_molecule(water_j.spce_system(9), 0.37, 0.61)
    pj = RunParamsJ(strict_min_image=False, temperature=300.0, r_cut=5.0,
                    cutoff_mode="site", **kw)
    mc_j = MonteCarloJ(fep_j.tag_last_molecule(water_j.spce_system(9), 0.0,
                                               0.0), pj, dtype=jnp.float64,
                       pallas=False, recompute_chunk=1)
    st_j = mc_j.init_state(jax.random.PRNGKey(0), state_0.com[0].numpy(),
                           quat=state_0.quat[0].numpy(), box=12.0,
                           n_chains=1)
    want, _ = fep_j.make_decoupled_insertion_fn(
        sys_j, pj, mc_j.kvecs, mc_j.kweights, dtype=jnp.float64, chunk=1)(
        st_j, jnp.asarray(com_t.numpy())[None, None],
        jnp.asarray(quat_t.numpy())[None, None])
    np.testing.assert_allclose(du_ins.numpy(), np.asarray(want), rtol=1e-10)


def test_stage_deletion_telescopes_and_cross_lambda_works():
    """U_lambda - U_0 from make_deletion_fn equals the difference of two
    independent recomputes; cross-rung works (state_system) telescope too
    when the charge scaling differs."""
    (params, sys_a, mc_a, state_a, mc_0, _, _, _) = _water9_states(
        dict(coulomb="ewald"), 0.7, 0.4)
    e0 = mc_0.init_state(state_a.com[0], state_a.quat[0],
                         float(state_a.box[0]), 1).energy
    d_a, _ = fep.make_deletion_fn(sys_a, params, mc_a.kvecs, mc_a.kweights,
                                  device="cpu", dtype=F64, chunk=1,
                                  species=-1)(state_a)
    assert float(d_a[0, 0]) == pytest.approx(float(state_a.energy[0] - e0[0]),
                                             rel=1e-10)
    sys_b = fep.tag_last_molecule(spce_system(9), 1.0, 0.9)
    mc_b = _mc(sys_b, params)
    state_b = mc_b.init_state(state_a.com[0], state_a.quat[0],
                              float(state_a.box[0]), 1)
    d_b, _ = fep.make_deletion_fn(sys_b, params, mc_b.kvecs, mc_b.kweights,
                                  device="cpu", dtype=F64, chunk=1,
                                  species=-1, state_system=sys_a)(state_a)
    assert float(d_b[0, 0] - d_a[0, 0]) == pytest.approx(
        float(state_b.energy[0] - state_a.energy[0]), rel=1e-10)


def test_lambda_basis_decomposition_exact():
    """d(lj, q) = lj A + lj^2 A2 + q B + q^2 C: the basis from the works at
    (1/2, 0), (1, 0), (1, 1/2), (1, 1) reproduces the work at any (lj, q)
    to round-off."""
    (params, sys_a, mc_a, state_a, _, _, _, _) = _water9_states(
        dict(coulomb="ewald"), 0.7, 0.4)

    def work_at(lj, q):
        s = fep.tag_last_molecule(spce_system(9), lj, q)
        return float(fep.make_deletion_fn(
            s, params, mc_a.kvecs, mc_a.kweights, device="cpu", dtype=F64,
            chunk=1, species=-1, state_system=sys_a)(state_a)[0][0, 0])

    basis = fep.lambda_basis(work_at(0.5, 0.0), work_at(1.0, 0.0),
                             work_at(1.0, 0.5), work_at(1.0, 1.0))
    for lj, q in ((0.7, 0.4), (0.3, 0.9), (0.05, 0.0), (1.0, 0.75)):
        assert float(fep.lambda_work(lj, q, *basis)) == pytest.approx(
            work_at(lj, q), rel=1e-9, abs=1e-6)


def test_decoupled_insertion_refuses_the_surface_term():
    sys_tag = fep.tag_last_molecule(spce_system(3), 0.5, 0.5)
    with pytest.raises(ValueError, match="tinfoil"):
        fep.make_decoupled_insertion_fn(sys_tag, RunParams(
            coulomb="ewald", ewald_surface=True), None, None, device="cpu")


def test_bar_matches_widom_lj():
    """A small LJ fluid (16 atoms, rho* 0.3, T* 1.5): mu_ex from BAR
    (insertions into N = 16 and deletions from N = 17) agrees with the
    direct Widom estimate within max(6 standard errors of the per-block
    Widom estimates, 0.15), as JAX's dense-fluid gate does."""
    n, t = 16, 1.5
    box = float((n / 0.3) ** (1.0 / 3.0))
    params = RunParams(temperature=t, r_cut=2.5, coulomb="none",
                       use_lrc=True, p_translate=1.0, dr_max=0.8,
                       strict_min_image=False)
    C, n_ins, blocks, steps = 8, 128, 4, 15
    gen = torch.Generator().manual_seed(42)
    mc_n = MonteCarlo(lj_system(n), params, device="cpu", generator=gen,
                      dtype=F64, kernel="plain", recompute_chunk=8)
    st_n, _ = mc_n.run_block(mc_n.init_state(cubic_lattice(n, box), box=box,
                                             n_chains=C), 30, adjust=True)
    widom_du, _ = make_widom_fn(lj_system(n), params, None, None,
                                device="cpu", dtype=F64, chunk=8)
    mc_n1 = MonteCarlo(lj_system(n + 1), params, device="cpu", generator=gen,
                       dtype=F64, kernel="plain", recompute_chunk=8)
    st_n1, _ = mc_n1.run_block(mc_n1.init_state(
        cubic_lattice(n + 1, box), box=box, n_chains=C), 30, adjust=True)
    deletion_du = fep.make_deletion_fn(lj_system(n + 1), params, None, None,
                                       device="cpu", dtype=F64, chunk=8)
    du_f, ov_f, du_r, boltz = [], [], [], []
    q1 = torch.zeros((C, n_ins, 4), dtype=F64)
    q1[..., 0] = 1.0
    for _ in range(blocks):
        st_n, stats = mc_n.run_block(st_n, steps)
        assert stats["drift_max_rel"] < 1e-10
        u = torch.rand((C, n_ins, 3), generator=gen, dtype=F64) * box
        du, ov = widom_du(st_n, u, q1)
        du_f.append(du.numpy())
        ov_f.append(ov.numpy())
        boltz.append(np.where(ov.numpy(), 0.0, np.exp(-du.numpy() / t)))
        st_n1, stats1 = mc_n1.run_block(st_n1, steps)
        assert stats1["drift_max_rel"] < 1e-10
        du_r.append(deletion_du(st_n1)[0].numpy())
    mu_widom = float(mu_excess(torch.tensor(np.mean(boltz)), t))
    mu_bar = fep.bar_mu_ex(np.concatenate([a.ravel() for a in du_f]),
                           np.concatenate([a.ravel() for a in ov_f]),
                           np.concatenate([a.ravel() for a in du_r]), t)
    per_block = [-t * np.log(max(np.mean(b), 1e-300)) for b in boltz]
    sem = np.std(per_block) / np.sqrt(len(per_block))
    assert mu_bar == pytest.approx(mu_widom, abs=max(6.0 * sem, 0.15)), \
        (mu_bar, mu_widom, sem)
    assert mu_bar < 0.0


def test_staged_bar_equals_widom_lj():
    """mu_ex summed over a 3-leg lambda ladder (ghosts -> 0.25 -> 0.6 ->
    1.0, epsilon scaling; each stage warm-started from the previous one's
    samples) agrees with direct Widom insertion into the rest system
    within max(6 standard errors of the per-block Widom estimates, 0.2),
    JAX's gate, on the small LJ fluid above (16 + 1 atoms, rho* 0.3, T*
    1.5; 32 chains, 4 blocks of 15 sweeps per stage, 128 insertions a
    chain and block: 128 deletion works per stage)."""
    n, t = 16, 1.5
    box = float(((n + 1) / 0.3) ** (1.0 / 3.0))
    params = RunParams(temperature=t, r_cut=2.5, coulomb="none",
                       use_lrc=True, p_translate=1.0, dr_max=0.8,
                       strict_min_image=False)
    C, n_ins, blocks, steps = 32, 128, 4, 15
    gen = torch.Generator().manual_seed(7)
    lams = [0.0, 0.25, 0.6, 1.0]
    systems = [fep.tag_last_molecule(lj_system(n + 1), lam, 0.0)
               for lam in lams]
    mcs = [MonteCarlo(s, params, device="cpu", generator=gen, dtype=F64,
                      kernel="plain", recompute_chunk=8) for s in systems]
    dels = [None] + [fep.make_deletion_fn(s, params, None, None,
                                          device="cpu", dtype=F64, chunk=8,
                                          species=-1) for s in systems[1:]]
    ghost_du = fep.make_decoupled_insertion_fn(systems[1], params, None,
                                               None, device="cpu", dtype=F64,
                                               chunk=8)
    q1 = torch.zeros((C, n_ins, 4), dtype=F64)
    q1[..., 0] = 1.0

    mc_w = MonteCarlo(lj_system(n), params, device="cpu", generator=gen,
                      dtype=F64, kernel="plain", recompute_chunk=8)
    st_w, _ = mc_w.run_block(mc_w.init_state(cubic_lattice(n, box), box=box,
                                             n_chains=C), 30, adjust=True)
    widom_du, _ = make_widom_fn(lj_system(n), params, None, None,
                                device="cpu", dtype=F64, chunk=8)
    boltz = []
    for _ in range(blocks):
        st_w, _ = mc_w.run_block(st_w, steps)
        du, ov = widom_du(st_w, torch.rand((C, n_ins, 3), generator=gen,
                                           dtype=F64) * box, q1)
        boltz.append(np.where(ov.numpy(), 0.0, np.exp(-du.numpy() / t)))
    mu_widom = -t * np.log(np.mean(boltz))
    per_block = [-t * np.log(np.mean(b)) for b in boltz]
    sem = np.std(per_block) / np.sqrt(len(per_block))

    st, _ = mcs[0].run_block(mcs[0].init_state(
        cubic_lattice(n + 1, box), box=box, n_chains=C), 30, adjust=True)
    d_here, d_next, d_prev = ([[] for _ in lams] for _ in range(3))
    ins_f, ins_o = [], []
    for i in range(len(lams)):
        if i > 0:
            st, _ = mcs[i].run_block(mcs[i].resync(st), 15, adjust=True)
        for _ in range(blocks):
            st, stats = mcs[i].run_block(st, steps)
            assert stats["drift_max_rel"] < 1e-9
            if i == 0:
                du, ov = ghost_du(st, torch.rand((C, n_ins, 3), generator=gen,
                                                 dtype=F64) * box, q1)
                ins_f.append(du.numpy().ravel())
                ins_o.append(ov.numpy().ravel())
                continue
            d_here[i].append(dels[i](st)[0].numpy().ravel())
            if i + 1 < len(lams):
                d_next[i].append(dels[i + 1](st)[0].numpy().ravel())
            d_prev[i].append(dels[i - 1](st)[0].numpy().ravel() if i > 1
                             else np.zeros_like(d_here[i][-1]))
    x_tot = 0.0
    for leg in range(len(lams) - 1):
        if leg == 0:
            w_f = np.where(np.concatenate(ins_o), np.inf,
                           np.concatenate(ins_f) / t)
        else:
            w_f = (np.concatenate(d_next[leg])
                   - np.concatenate(d_here[leg])) / t
        w_r = (np.concatenate(d_prev[leg + 1])
               - np.concatenate(d_here[leg + 1])) / t
        x_tot += fep.bar_solve(w_f, w_r)
    assert t * x_tot == pytest.approx(mu_widom, abs=max(6.0 * sem, 0.2)), \
        (t * x_tot, mu_widom, sem)


def test_phase27_basis_identity_f64_plain():
    """chip_smoke.py phase 27's gate (c) on the CPU in float64 on the plain
    route: at run_bar_water.py's density (8 + 1 waters, r_cut 0.45 box +
    LRC), the deletion works at the four basis systems of states sampled
    at lambda (0.4, 0) give, through lambda_basis / lambda_work, the rung's
    own deletion work to round-off; JAX's lambda_basis / lambda_work on
    the same works give the same reconstruction."""
    import chip_smoke

    params, box = chip_smoke.fep_state_point(8)
    system = fep.tag_last_molecule(spce_system(9), *chip_smoke.FEP_RUNG)
    mc = MonteCarlo(system, params, device="cpu", dtype=F64,
                    kernel="plain", recompute_chunk=1,
                    generator=torch.Generator().manual_seed(27))
    st = mc.init_state(cubic_lattice(9, box), box=box, n_chains=3)
    st, _ = mc.run_block(st, 2)
    works, direct, recon, mag = chip_smoke.fep_basis_identity(
        mc, st, F64, chunk=1)
    assert recon.shape == direct.shape == (3, 1)
    assert np.all(mag > np.abs(direct))
    np.testing.assert_allclose(recon, direct, rtol=1e-10, atol=1e-9)
    want = fep_j.lambda_work(*chip_smoke.FEP_RUNG,
                             *fep_j.lambda_basis(*works))
    np.testing.assert_allclose(recon, np.asarray(want), rtol=1e-14, atol=0)
    # the rung's work is not a basis work: the identity is not trivial
    assert all(np.abs(w - direct).max() > 1.0 for w in works)
