"""The port's molecular TMMC (make_gcmc_mol(tmmc=True), mc/tmmc.TMMCMol)
and the sweep op's tmmc deposits, on the CPU, against the JAX package.

* The twin with tmmc and eta = 0 takes the n_exch twin's decisions bit for
  bit (both branches are summed as the selected branch is).
* mega="full" with tmmc against JAX make_gcmc_mol(tmmc=True,
  mega="interpret_full"), whose interpreter PRNG returns zeros: the port
  gets zero uniforms and zero deletion scores; activity and counters
  equal, cmat within 1e-4 of each row's deposit count (the deposits are
  exp(min(ln_acc, 0)) of f32 energies), uhist counts equal, sum E within
  2e-5 of its magnitude scale (f32 rounding of the energy deltas, as in
  tests/test_torch_gcmc_mol.py).
* The host builds with eta = 0 reproduce the muVT builds on one generator
  seed; a -1e6 bias wall pins N while the deposits go on; the ideal rigid
  rotor's ln Pi is exact; SPC/E under a bias keeps the drift gates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

from metropolismontecarlo_tpu.mc import gcmc_mol as gcmc_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gcmc_mol as gcmc_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc.tmmc import TMMCMol, lnpi_from_cmat
from metropolismontecarlo_tpu_torch.mc.widom import make_pose_eval
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op

F64, F32 = torch.float64, torch.float32
WATER = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", use_lrc=False, p_translate=0.5, dr_max=0.25,
             dphi_max=0.3, strict_min_image=False)
BOX, CAP, N_INIT, C = 10.0, 8, 5, 4


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


def _params(kind):
    kw = dict(WATER)
    if kind == "wolf_ref":
        kw.update(coulomb="wolf", wolf_style="ref", temperature=5000.0)
    elif kind == "lj_lrc":
        kw.update(coulomb="none", use_lrc=True)
    return kw


# ---------------- the twin: eta = 0 is the n_exch twin ------------------


def _twin_case(kind, seed):
    """The sweep op's arguments for a cap-8 SPC/E state with random
    uniforms and about half the slots active (chain 0 full, chain 1
    empty), and an activity near N / V exp(si / T) that accepts
    insertions and deletions alike."""
    params = RunParams(**_params(kind))
    system = water_t.spce_system(CAP)
    gen = _gen(seed)
    g = gcmc_t.MolGCMC(system, params, activity=1.0, dtype=F32,
                       device="cpu", generator=gen)
    active = torch.rand((C, CAP), generator=gen) < 0.5
    active[0], active[1] = True, False
    st = g.init(box=BOX, n_init=CAP, n_chains=C)
    st = dataclasses.replace(st, active=active)
    e, sf = g.full_energy(st)
    kvk = ewald_t.make_kvectors(params.nk, params.ksq_max) \
        if params.coulomb == "ewald" else (None, None)
    (tables,) = moves_t.sweep_tables(system, params, *kvk, "cpu")
    act, actm = moves_t.activity_planes(system, active)
    ones = torch.ones(C)
    args = [x.to(F32).contiguous() for x in (st.coords, st.com, st.quat, sf,
                                             st.box)] + [
        params.temperature * ones, params.dr_max * ones,
        params.dphi_max * ones, torch.rand((C, CAP, 10), generator=gen),
        tables]
    ev = make_pose_eval(system, params, *kvk, "cpu", F32)
    si = ev.self_intra(st.box).to(F32)
    wc = (ev.wolf_const_coeff(st.box) * ev.q_t_tot ** 2
          + ev.lrc_self_coeff(st.box)).to(F32)
    z = (0.5 * CAP / BOX ** 3 * torch.exp(si / params.temperature)).to(F32)
    n_exch = 12
    ux = torch.rand((C, n_exch, 8), generator=gen)
    kw = dict(act=act, actm=actm, n_exch=n_exch, ux=ux, z=z, si=si, wc=wc,
              seed=7)
    return args, kw, e.to(F32), tables


@pytest.mark.parametrize("kind", ["ewald", "wolf_ref", "lj_lrc"])
def test_twin_zero_bias_takes_the_n_exch_twins_decisions(kind):
    args, kw, e0, tables = _twin_case(kind, 11)
    ref = sweep_op.sweep_plain(*args, **kw)
    out = sweep_op.sweep_plain(*args, **kw, tmmc=True,
                               eta=torch.zeros(CAP + 1), e_in=e0)
    for name, a, b in zip(("coords", "com", "quat", "sfac", "stats", "act",
                           "actm", "wid"), ref, out[:8]):
        assert torch.equal(a, b), name
    stats = ref[4]
    # both directions were taken somewhere
    assert float(stats[:, 5].sum()) > 0 and float(stats[:, 6].sum()) > 0
    cmat, uhist = out[8], out[9]
    assert cmat.shape == uhist.shape == (C, CAP + 1, 3)
    # one unit of row mass per attempt; deposits only where it stood
    np.testing.assert_allclose(cmat.sum((1, 2)).numpy(), 12.0, rtol=1e-6)
    assert torch.equal(uhist[..., 0].sum(1), torch.full((C,), 12.0))
    assert float(cmat[0, CAP, 1]) == 0.0        # a full chain cannot insert
    assert float(cmat[1, 0, 2]) == 0.0          # an empty one cannot delete
    assert bool((cmat >= 0).all()) and bool((cmat <= 12.0).all())
    # the sweep wrapper dispatches CPU tensors to the twin
    again = sweep_op.sweep(*args, **kw, tmmc=True, eta=torch.zeros(CAP + 1),
                           e_in=e0)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_twin_energy_moments_follow_the_running_energy():
    """uhist's sum E is the sum over attempts of e_in + the energy delta
    the launch had accepted before the attempt; with every attempt an
    insertion at a negligible activity none is accepted, so it is count x
    (e_in + the moves' delta)."""
    args, kw, e0, _ = _twin_case("lj_lrc", 3)
    kw = dict(kw, z=torch.full((C,), 1e-30))
    kw["ux"][:, :, 0] = 0.1                      # insertions only
    out = sweep_op.sweep_plain(*args, **kw, tmmc=True,
                               eta=torch.zeros(CAP + 1), e_in=e0,
                               magnitude=True)
    stats, uhist, umag = out[4], out[9], out[10]
    assert float(stats[:, 5].sum()) == 0.0
    e = e0 + stats[:, 0]
    np.testing.assert_allclose(uhist[..., 1].sum(1).numpy(),
                               (12.0 * e).numpy(), rtol=1e-5)
    np.testing.assert_allclose(uhist[..., 2].sum(1).numpy(),
                               (12.0 * e * e).numpy(), rtol=1e-5)
    # the moments' scales cover |e_in| + the moves' magnitudes
    s_e = e0.abs() + stats[:, sweep_op.N_STATS]
    np.testing.assert_allclose(umag[..., 0].sum(1).numpy(),
                               (12.0 * s_e).numpy(), rtol=1e-5)
    assert bool((umag[..., 1:] >= 0).all())
    # no exchange passed: the deposits' energy scale is beta up m_ins
    assert float(umag[..., 2].sum()) > 0.0


def test_twin_refuses_tmmc_without_attempts():
    args, kw, e0, _ = _twin_case("lj_lrc", 4)
    kw = dict(kw, n_exch=0, ux=None)
    with pytest.raises(ValueError, match="n_exch"):
        sweep_op.sweep(*args, **kw, tmmc=True, eta=torch.zeros(CAP + 1),
                       e_in=e0)
    kw2 = dict(_twin_case("lj_lrc", 4)[1])
    with pytest.raises(ValueError, match="eta: shape"):
        sweep_op.sweep(*args, **kw2, tmmc=True, eta=torch.zeros(CAP),
                       e_in=e0)


# ---------------- against the interpreted JAX kernel ---------------------


def test_mega_full_tmmc_matches_jax_interpret_full(monkeypatch):
    params_t, params_j = RunParams(**WATER), RunParamsJ(**WATER)
    init_j, run_j, _ = gcmc_j.make_gcmc_mol(
        water_j.spce_system(CAP), params_j, activity=2e-4, p_exchange=0.3,
        dtype=jnp.float32, tmmc=True, mega="interpret_full")
    st_j = init_j(jax.random.PRNGKey(0), box=BOX, n_init=N_INIT, n_chains=C)
    eta = np.zeros(CAP + 1)
    st_j2, cm_j, uh_j = run_j(st_j, eta, 44)

    mags, umags = [], []
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))

    def twin(*a, **k):
        scores = torch.zeros((a[0].shape[0], k["n_exch"], a[1].shape[1]))
        out = sweep_op.sweep_plain(*a, magnitude=True, scores=scores, **k)
        mags.append(out[4][:, sweep_op.N_STATS])
        umags.append(out[10])
        return out[:4] + (out[4][:, :sweep_op.N_STATS],) + out[5:10]

    monkeypatch.setattr(moves_t.sweep_op, "sweep", twin)
    init_t, run_t, _ = gcmc_t.make_gcmc_mol(
        water_t.spce_system(CAP), params_t, activity=2e-4, p_exchange=0.3,
        dtype=F32, tmmc=True, mega="full", device="cpu", generator=_gen())
    st = bridge.gcmc_state_from_numpy(
        {f: np.asarray(getattr(st_j, f)) for f in st_j._fields
         if f != "key"}, "cpu")
    e0 = st.energy.numpy().copy()
    st2, cm, uh = run_t(st, eta, 44)
    assert len(mags) == 4                        # 4 cycles, one call each
    np.testing.assert_array_equal(st2.active.numpy(),
                                  np.asarray(st_j2.active))
    np.testing.assert_array_equal(st2.acc.numpy(), np.asarray(st_j2.acc))
    np.testing.assert_array_equal(st2.att.numpy(), np.asarray(st_j2.att))
    assert int(st2.acc[:, 2].sum()) > 0          # insertions were accepted
    mag = torch.stack(mags).sum(0).numpy()
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)

    cm_j, uh_j = np.asarray(cm_j, np.float64), np.asarray(uh_j, np.float64)
    cm, uh = cm.double().numpy(), uh.double().numpy()
    count = uh_j[..., 0]
    np.testing.assert_array_equal(uh[..., 0], count)
    assert count.sum() == C * 4 * 3              # x_per = 3 per cycle
    assert (np.abs(cm - cm_j).max(-1) <= 1e-4 * count).all(), \
        np.abs(cm - cm_j).max()
    # both branches deposit: the deletion's down column is non-zero
    assert cm[..., 2].sum() > 0.0 and cm[..., 1].sum() > 0.0
    umag = torch.stack(umags).sum(0).double().numpy()
    assert (np.abs(uh[..., 1] - uh_j[..., 1]) <= 2e-5 * umag[..., 0]).all()
    assert (np.abs(uh[..., 2] - uh_j[..., 2]) <= 2e-5 * umag[..., 1]).all()


# ---------------- the host builds: eta = 0 is the muVT build ------------


@pytest.mark.parametrize("mega,dtype", [(None, F64), (True, F32),
                                        ("full", F32)])
def test_zero_bias_reproduces_the_muvt_build(mega, dtype):
    system = water_t.spce_system(CAP)
    params = RunParams(**WATER)
    kw = dict(activity=2e-4, p_exchange=0.3, dtype=dtype, mega=mega,
              device="cpu")
    init_g, run_g, _ = gcmc_t.make_gcmc_mol(system, params, **kw,
                                            generator=_gen(8))
    init_t, run_t, _ = gcmc_t.make_gcmc_mol(system, params, **kw, tmmc=True,
                                            generator=_gen(8))
    st_g = init_g(box=BOX, n_init=N_INIT, n_chains=C)
    st_t = init_t(box=BOX, n_init=N_INIT, n_chains=C)
    n_steps = 22 if mega else 30
    st_g = run_g(st_g, n_steps)
    st_t, cmat, uhist = run_t(st_t, np.zeros(CAP + 1), n_steps)
    for f in dataclasses.fields(st_g):
        assert torch.equal(getattr(st_g, f.name), getattr(st_t, f.name)), \
            f.name
    # one unit of row mass per exchange attempt (every plain step deposits)
    x_per = max(1, round(CAP * 0.3 / 0.7))
    per_chain = n_steps if mega is None else 2 * x_per
    np.testing.assert_allclose(cmat.sum((1, 2)).numpy(), per_chain,
                               rtol=1e-6)
    assert torch.equal(uhist[..., 0].sum(1),
                       torch.full((C,), float(per_chain), dtype=dtype))
    assert int((st_t.acc[:, 2] + st_t.acc[:, 3]).sum()) > 0


def test_bias_wall_blocks_exchanges_and_keeps_depositing():
    """A -1e6 wall on every row but the start's pins N (every exchange is
    refused by the biased threshold), while the unbiased deposits land in
    the start's row only."""
    g = TMMCMol(water_t.spce_system(CAP), RunParams(**WATER), activity=2e-4,
                p_exchange=0.3, dtype=F32, mega="full", device="cpu",
                generator=_gen(9))
    st = g.init(BOX, N_INIT, C)
    g.eta = np.full(CAP + 1, -1.0e6)
    g.eta[N_INIT] = 0.0
    st, stats = g.run_block(st, 44, update_bias=False)
    assert torch.equal(st.active.sum(1), torch.full((C,), N_INIT))
    assert g.cmat[N_INIT].sum() == pytest.approx(C * 4 * 3)
    assert g.cmat[np.arange(CAP + 1) != N_INIT].sum() == 0.0
    assert g.cmat[N_INIT, 1] > 0.0 and g.cmat[N_INIT, 2] > 0.0
    assert stats["acc_insert"] == 0.0 and stats["acc_delete"] == 0.0
    assert stats["n_min"] == stats["n_max"] == N_INIT


def _lj_params(**kw):
    return RunParams(**dict(dict(
        strict_min_image=False, temperature=1.5, r_cut=2.5,
        cutoff_mode="site", coulomb="none", p_translate=0.5, dr_max=1.0,
        dphi_max=1.0, use_lrc=False), **kw))


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-8),
                                            ("full", F32, 1e-4)])
def test_ideal_rotor_lnpi_is_exact(mega, dtype, tol):
    """eps = q = 0: every deposit is a closed form of N, so ln Pi(N) =
    N ln(zV) - ln N! on the visited range, to rounding."""
    z, box, cap = 0.02, 6.0, 16
    t = TMMCMol(poly_t.triatomic_system(cap, eps=0.0), _lj_params(),
                activity=z, p_exchange=0.6, dtype=dtype, mega=mega,
                device="cpu", generator=_gen(10))
    st = t.init(box, np.linspace(0, cap, 8).astype(np.int64), 8)
    st, stats = t.run_block(st, 60 if mega is None else 80,
                            drift_tol=1e-6)
    lnpi, visited = lnpi_from_cmat(t.cmat)
    n = np.arange(cap + 1)
    exact = n * np.log(z * box ** 3) - gammaln(n + 1.0)
    fin = np.where(visited)[0]
    assert fin.size >= 8, fin
    d = (lnpi[fin] - lnpi[fin[0]]) - (exact[fin] - exact[fin[0]])
    assert np.max(np.abs(d)) < tol, np.max(np.abs(d))
    assert stats["visited_frac"] > 0.5


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-9),
                                            (True, F32, 2e-3),
                                            ("full", F32, 2e-3)])
def test_spce_under_a_bias_keeps_the_drift_gates(mega, dtype, tol):
    t = TMMCMol(water_t.spce_system(CAP), RunParams(**WATER), activity=2e-4,
                p_exchange=0.5, dtype=dtype, mega=mega, device="cpu",
                generator=_gen(12))
    st = t.init(BOX, np.array([1, 3, 5, 7]), C)
    t.eta = 0.8 * np.arange(CAP + 1, dtype=np.float64)
    for _ in range(2):
        st, stats = t.run_block(st, 24, drift_tol=tol)
        assert stats["sfac_err_max"] < (1e-4 if dtype == F32 else 1e-9)
    assert int((st.acc[:, 2] + st.acc[:, 3]).sum()) > 0
    assert set(stats) >= {"n_mean", "n_min", "n_max", "visited_frac",
                          "full_frac", "acc_trans", "acc_rot", "acc_insert",
                          "acc_delete", "drift_max_rel", "sfac_err_max"}
    t.reset_collection()
    assert t.cmat.sum() == 0.0 and t.uhist.sum() == 0.0
    assert t.eta[3] != 0.0                       # the bias is kept


# ---------------- refusals, layout, bridge ---------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(mega=True, dtype=F32, p_exchange=0.0), "mc/tmmc.py"),
    (dict(mega="full"), "float32"),
    (dict(mega="full", dtype=F32, p_exchange=0.0), "p_exchange"),
    (dict(mega="full", dtype=F32, n_orient=3), "unbiased"),
])
def test_tmmc_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        gcmc_t.make_gcmc_mol(water_t.spce_system(CAP), RunParams(**WATER),
                             activity=1e-4, tmmc=True, device="cpu", **kw)


def test_multi_block_tmmc_is_refused():
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system

    kv, kw = ewald_t.make_kvectors(5, 27)
    with pytest.raises(ValueError, match="single species block"):
        moves_t.make_mega_sweep_fn(co2_n2_system(4, 4),
                                   RunParams(**dict(WATER, r_cut=4.0)), kv,
                                   kw, "cpu", with_activity=True,
                                   n_exch=(2, 2), tmmc_exch=True)


def test_smem_bytes_counts_the_tmmc_regions():
    """The tmmc instantiation adds a second 32 x 8 B slot-pick row, a
    second set of warp queues (the deletion branch's live pair terms),
    the deletion pose (4 P), its S(k) row (2 K) and its warp partials
    (32)."""
    M, P, A, K, T = 512, 3, 1536, 337, 2
    queues = 2 * 8 * 128
    base = sweep_op.smem_bytes(M, P, A, K, T, True)
    tmmc = sweep_op.smem_bytes(M, P, A, K, T, True, True)
    assert tmmc == base + 4 * (64 + queues + 4 * P + 2 * K + 32)
    # capacity-512 SPC/E TMMC: three blocks fit an SM's 228 KB (1 KB of
    # it reserved per block)
    assert 3 * (tmmc + 1024) <= 228 * 1024
    # the monatomic capacity-192 LJ (A_pad 256, a dummy S(k) row)
    assert sweep_op.smem_bytes(192, 1, 256, 1, 1, True, True) == \
        4 * (64 + queues + 8 * 64 + 4 * 256 + 8 + 4 + 23 + 96 + 256 + 192
             + 64 + queues + 4 + 2 + 32)


def test_bridge_roundtrips_the_estimator_state():
    t = TMMCMol(lj_system(4), _lj_params(), activity=0.02, device="cpu")
    arrays = {"cmat": np.arange(15.0).reshape(5, 3),
              "uhist": np.ones((5, 3)), "eta": np.linspace(0, 1, 5)}
    bridge.tmmc_estimator_from_numpy(t, arrays)
    back = bridge.tmmc_estimator_to_numpy(t)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError, match="eta"):
        bridge.tmmc_estimator_from_numpy(t, dict(arrays, eta=np.zeros(4)))
