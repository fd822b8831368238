"""The port's binary Gibbs ensemble (mc/gibbs_binary.py) and the binary
Gibbs cycle of mc/moves.make_mega_gibbs_binary_fn on the CPU, against the
JAX package.

* The plain route in float64 through its draw seam: the port's cheap step
  and volume step fed the uniforms, axes and trial orientations that the
  JAX steps draw from their keys (reproduced with jax.random), against the
  JAX steps themselves (reached through the closures of its run_steps):
  decisions equal, state and energies to 1e-9.  NVT-Gibbs on two SPC/E
  blocks with Ewald; NPT-Gibbs with Rosenbluth transfers on the ragged
  one-site LJ + triatomic blocks with the tail.
* mega="full" against JAX mega="interpret_full" and mega=True's folded
  sweep against JAX mega="interpret": the interpreter's PRNG returns
  zeros, so the port gets zero uniforms and all-zero deletion scores;
  equal decisions, energies within 2e-5 of the cycle's term magnitudes.
* Ports of the JAX gates (tests/test_gibbs_binary.py): the recompute is
  the model energy; ideal species partition Binomially; NPT-Gibbs boxes
  of an ideal gas are Gamma(N_b + 1, kT/P) in volume; the ideal pressure
  and Widom identities; colour symmetry against the one-species Gibbs
  ensemble and equal box pressures of an interacting pair (both at
  reduced size); every route's drift and S(k) gates with each
  species' N conserved; the refusals; the CLI end to end.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gibbs_binary as gb_j
from metropolismontecarlo_tpu.mc.gcmc_binary import (
    make_binary_slots as slots_j,
)
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.quaternions import random_unit_vector
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gibbs_binary as gb_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.polyatomic import lj_trimer_blocks
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gibbs_op
from tests.test_gcmc_binary import lj_two_blocks, water_two_blocks
from tests.test_gcmc_osmotic import lj_plus_trimer

F32, F64 = torch.float32, torch.float64
C = 3
KL, NK, KSQ = ewald_t.tune_parameters(12.0, 4.5, 5e-3)
WATER = dict(strict_min_image=False, temperature=600.0, r_cut=4.5,
             cutoff_mode="site", coulomb="ewald", use_lrc=False,
             p_translate=0.5, dr_max=1.0, dphi_max=0.8, p_volume=0.02,
             kappa_L=KL, nk=NK, ksq_max=KSQ)
KERNEL = dict(WATER, temperature=700.0, dr_max=0.3, dphi_max=0.3)
LJ = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=1.0, dr_max=0.4,
          use_lrc=False, p_volume=0.0)


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


def _port(sys_j):
    """The port's System with the JAX System's fields."""
    return bridge.system_from_numpy(
        {f: getattr(sys_j, f) for f in sys_j.__dataclass_fields__})


def _to_port(st_j):
    return bridge.binary_gibbs_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _assert_states_close(st_t, st_j, rtol=1e-9, atol=1e-9):
    for f in ("active0", "active1", "acc", "att"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)),
                                      err_msg=f)
    for f in ("com", "quat", "coords", "box", "sfac", "energy"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


def _jax_cheap_draws(keys, ms_j, n_or):
    """The draws of JAX's cheap step from each chain's key, as the port's
    draw_cheap lays them out (torch, float64)."""
    f64 = jnp.float64

    def one(key):
        _, k = jax.random.split(key)
        (k_move, k_box, k_xpos, k_sel, k_pos, k_rot, k_insq, k_delq, k_dsel,
         k_pick, k_acc) = jax.random.split(k, 11)
        kax, kang = jax.random.split(k_rot)
        k_ip, k_iq, k_dq, k_ds, k_pk = (jax.random.split(x, 2) for x in (
            k_xpos, k_insq, k_delq, k_dsel, k_pick))
        u = lambda kk, shape=(): jax.random.uniform(kk, shape, f64)  # noqa
        return dict(
            u_move=u(k_move), bit=jax.random.bernoulli(k_box), u_sel=u(k_sel),
            u_pos=u(k_pos, (3,)), axis=random_unit_vector(kax, (), dtype=f64),
            u_rot=u(kang),
            u_ins=jnp.stack([u(k_ip[s], (3,)) for s in (0, 1)]),
            quats_ins=jnp.stack([ms_j.trial_quats[s](k_iq[s], n_or)
                                 for s in (0, 1)]),
            u_del=jnp.stack([u(k_ds[s]) for s in (0, 1)]),
            quats_del=jnp.stack([ms_j.trial_quats[s](k_dq[s], n_or - 1)
                                 for s in (0, 1)]),
            u_pick=jnp.stack([u(k_pk[s]) for s in (0, 1)]), u_acc=u(k_acc))

    return SimpleNamespace(**{k: torch.tensor(np.array(v)) for k, v in
                              jax.vmap(one)(keys).items()})


def _jax_vol_draws(keys):
    def one(key):
        _, k = jax.random.split(key)
        k_pos, k_box, k_acc = jax.random.split(k, 3)
        return (jax.random.uniform(k_pos, dtype=jnp.float64),
                jax.random.uniform(k_acc, dtype=jnp.float64),
                jax.random.bernoulli(k_box))

    return tuple(torch.tensor(np.array(x)) for x in jax.vmap(one)(keys))


# (JAX system, params, boxes, n_init, p_transfer, n_orient, npt_pressure)
SEAM_CASES = {
    "spce-ewald-nvt": (lambda: water_two_blocks(6, 6), WATER, (10.0, 12.0),
                       [[4, 2], [2, 4]], 0.4, 1, None),
    "lj-trimer-npt-lrc-orient3": (lambda: lj_plus_trimer(12, 8),
                                  dict(LJ, use_lrc=True, p_translate=0.5,
                                       dphi_max=0.8, temperature=2.0),
                                  (5.5, 6.5), [[8, 4], [3, 5]], 0.4, 3,
                                  0.2),
}


@pytest.mark.parametrize("name", list(SEAM_CASES))
def test_plain_steps_match_jax_f64(name):
    sys_j, kw, boxes, n_init, px, n_or, npt = SEAM_CASES[name]
    g_j = gb_j.BinaryGibbsEnsemble(sys_j(), RunParamsJ(**kw), dv_max=0.05,
                                   p_transfer=px, n_orient=n_or,
                                   npt_pressure=npt)
    st_j = g_j.init(jax.random.PRNGKey(5), boxes=boxes, n_init=n_init,
                    n_chains=C)
    run_chain = _free(g_j.run_steps, "_run_chain")
    step_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_cheap_step")(
        c, None)[0]))
    vol_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_vol_step")(c)))
    ms_j = slots_j(sys_j(), RunParamsJ(**kw), jnp.float64)
    g = gb_t.BinaryGibbsEnsemble(_port(sys_j()), RunParams(**kw),
                                 dv_max=0.05, p_transfer=px, n_orient=n_or,
                                 npt_pressure=npt, device="cpu")
    st = _to_port(st_j)
    _assert_states_close(st, st_j)          # full_energy: the same model
    carry = tuple(st_j)
    for i in range(24):
        dr = _jax_cheap_draws(carry[8], ms_j, n_or)
        carry = step_j(*carry)
        st = g.run_steps.cheap_step(st, dr)
        if i % 8 == 7:
            u_dv, u_acc, bit = _jax_vol_draws(carry[8])
            carry = vol_j(*carry)
            st = g.run_steps.volume_step(st, u_dv, u_acc, bit)
    st_j = gb_j.BinaryGibbsState(*carry)
    _assert_states_close(st, st_j, rtol=1e-9, atol=1e-8)
    att, acc = st.att.sum(0).tolist(), st.acc.sum(0).tolist()
    assert att[2] == 3 * C and acc[2] > 0 and acc[0] + acc[1] > 0
    assert acc[3] + acc[4] > 0              # transfers were accepted
    e_j, sf_j = g_j.full_energy(st_j)
    e, sf = g.full_energy(st)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-10)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_j), rtol=1e-10,
                               atol=1e-10)


def test_full_energy_is_the_model_energy():
    """Every slot of both species active in both boxes: the recompute
    equals models/energy.energy_breakdown per box, before and after a
    drift-gated block of NVT moves."""
    system = spce_two_blocks(4, 3)
    params = RunParams(temperature=400.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=0.5, dphi_max=0.5, p_volume=0.0)
    g = gb_t.BinaryGibbsEnsemble(system, params, p_transfer=0.0,
                                 device="cpu")
    st = g.init(boxes=(12.0, 14.0), n_init=[[4, 4], [3, 3]], n_chains=2)
    kv, kw = ewald_t.make_kvectors(params.nk, params.ksq_max)
    A = system.n_atoms

    def model(st):
        return torch.stack([energy_breakdown(
            system, params, st.coords[:, b, :, :A].transpose(1, 2),
            st.com[:, b], st.box[:, b], kv, kw)["total"] for b in (0, 1)], 1)

    np.testing.assert_allclose(st.energy.numpy(), model(st).numpy(),
                               rtol=1e-9)
    st, stats = g.run_block(st, 60, drift_tol=1e-9)
    assert stats["acc_disp"] > 0.0
    np.testing.assert_allclose(st.energy.numpy(), model(st).numpy(),
                               rtol=1e-9)


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


def test_mega_full_matches_jax_interpret_full(monkeypatch):
    """One Gibbs launch per species block, each with its species'
    transfers, the activity planes threaded between them."""
    kw = dict(KERNEL, p_volume=0.0)
    g_j = gb_j.BinaryGibbsEnsemble(water_two_blocks(6, 6), RunParamsJ(**kw),
                                   p_transfer=0.4, dtype=jnp.float32,
                                   mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(6), boxes=(10.0, 12.0),
                    n_init=[[4, 2], [2, 4]], n_chains=2)
    mags = []
    _zero_draws(monkeypatch, mags)
    g = gb_t.BinaryGibbsEnsemble(spce_two_blocks(6, 6), RunParams(**kw),
                                 p_transfer=0.4, dtype=F32, mega="full",
                                 device="cpu")
    st = _to_port(st_j)
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 40)
    st2 = g.run_steps(st, 40)
    assert len(mags) == 2                      # one cycle, one launch a block
    for f in ("active0", "active1", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    att = st2.att.numpy()
    assert att[:, 3].sum() > 0 and att[:, 4].sum() > 0
    assert int(st2.acc[:, 3:].sum()) > 0       # transfers were accepted
    mag = torch.stack(mags).sum(0).numpy()[:, None]
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)
    ref = np.asarray(st_j2.sfac)
    np.testing.assert_allclose(st2.sfac.numpy(), ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(st2.coords.numpy(), np.asarray(st_j2.coords),
                               atol=1e-4)
    _, stats = g.run_block(st2, 0)
    assert stats["drift_max_rel"] < 2e-3 and stats["sfac_err_max"] < 1e-4


def test_mega_true_sweep_matches_jax_interpret(monkeypatch):
    """mega=True's kernel sweep of both boxes, folded over the chain axis
    and one launch per species block, against JAX's _sweep_state (the
    transfer steps that follow it are the plain route, held above)."""
    g_j = gb_j.BinaryGibbsEnsemble(water_two_blocks(6, 6),
                                   RunParamsJ(**KERNEL), dv_max=0.02,
                                   p_transfer=0.4, dtype=jnp.float32,
                                   mega="interpret")
    st_j = g_j.init(jax.random.PRNGKey(6), boxes=(10.0, 12.0),
                    n_init=[[4, 2], [2, 4]], n_chains=2)
    _zero_draws(monkeypatch, [])
    g = gb_t.BinaryGibbsEnsemble(spce_two_blocks(6, 6), RunParams(**KERNEL),
                                 dv_max=0.02, p_transfer=0.4, dtype=F32,
                                 mega=True, device="cpu")
    want = _free(g_j.run_steps, "_sweep_state")(st_j)
    got = g.run_steps.sweep(_to_port(st_j))
    for f in ("active0", "active1", "acc", "att"):
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


def test_binary_cycle_threads_the_species_launches():
    """make_mega_gibbs_binary_fn on the CPU: one op call per species block
    addressed by m_start / a_start, the second reading the first's planes;
    each species' transfer counters are its own launch's column."""
    system = lj_trimer_blocks(6, 4)
    params = RunParams(**dict(LJ, p_translate=0.5, dphi_max=0.5,
                              temperature=2.0))
    fn = moves_t.make_mega_gibbs_binary_fn(system, params, None, None, "cpu",
                                           n_exch=(3, 2))
    assert [(t.m_start, t.a_start, t.M, t.P) for t in fn.tables] == \
        [(0, 0, 6, 1), (6, 6, 4, 3)]
    g = gb_t.BinaryGibbsEnsemble(system, params, p_transfer=0.4, dtype=F32,
                                 device="cpu")
    st = g.init(boxes=(5.5, 6.5), n_init=[[4, 2], [1, 3]], n_chains=4)
    calls = []
    real = moves_t.gibbs_op.sweep_gibbs

    def spy(*a, **k):
        calls.append((a[9].m_start, k["n_exch"], a[10].clone()))
        out = real(*a, **k)
        calls[-1] += (out[5].clone(), out[4][:, 6].clone())
        return out

    z = torch.zeros((4, 2))
    try:
        moves_t.gibbs_op.sweep_gibbs = spy
        out = fn(st.com, st.quat, st.coords, st.active0, st.active1, st.box,
                 st.sfac, torch.Generator().manual_seed(1), (z, z), (z, z))
    finally:
        moves_t.gibbs_op.sweep_gibbs = real
    assert [(m, n) for m, n, *_ in calls] == [(0, 3), (6, 2)]
    assert torch.equal(calls[1][2], calls[0][3])     # planes threaded
    acc, att = out[7], out[8]
    np.testing.assert_array_equal(acc[:, 2].numpy(), calls[0][4].numpy())
    np.testing.assert_array_equal(acc[:, 3].numpy(), calls[1][4].numpy())
    np.testing.assert_array_equal(att[:, 2:].numpy(), [[3.0, 2.0]] * 4)
    for s, a in enumerate(out[3:5]):
        assert (a.sum((1, 2)) == int(np.sum([[4, 2], [1, 3]][s]))).all()


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-9),
                                            (True, F32, 2e-3),
                                            ("full", F32, 2e-3)])
def test_routes_keep_the_drift_and_sfac_gates(mega, dtype, tol):
    """Every route through transfers and volume moves (unequal boxes):
    carried energies and S(k) against the recompute, each species' total
    N conserved, both species' transfers attempted."""
    g = gb_t.BinaryGibbsEnsemble(spce_two_blocks(6, 6), RunParams(**KERNEL),
                                 dv_max=0.02, p_transfer=0.4, dtype=dtype,
                                 mega=mega, device="cpu")
    st = g.init(boxes=(10.0, 12.0), n_init=[[4, 2], [2, 4]], n_chains=2)
    for _ in range(2):
        st, stats = g.run_block(st, 60, drift_tol=tol)
        assert stats["sfac_err_max"] < (1e-9 if dtype == F64 else 1e-4)
    assert int(st.att[:, 0].sum()) > 0
    assert int(st.att[:, 3].sum()) > 0 and int(st.att[:, 4].sum()) > 0
    assert (st.active0.sum((1, 2)) == 6).all()
    assert (st.active1.sum((1, 2)) == 6).all()


def test_npt_mega_full_ragged_drift():
    """NPT-Gibbs composed with the in-kernel transfers on the ragged
    one-site + triatomic blocks: drift, per-species N, volume moves."""
    params = RunParams(**dict(LJ, p_translate=0.5, dphi_max=0.8,
                              p_volume=0.02, temperature=2.0))
    g = gb_t.BinaryGibbsEnsemble(lj_trimer_blocks(20, 12), params,
                                 dv_max=0.1, p_transfer=0.4, dtype=F32,
                                 mega="full", npt_pressure=0.2, device="cpu")
    st = g.init(boxes=(5.5, 6.5), n_init=[[10, 6], [4, 6]], n_chains=4)
    st, stats = g.run_block(st, 200, drift_tol=2e-3)
    assert (st.active0.sum((1, 2)) == 16).all()
    assert (st.active1.sum((1, 2)) == 10).all()
    assert stats["acc_vol"] > 0.0 and int(st.att[:, 3:].sum()) > 0


# ---------------- physics gates -----------------------------------------


def test_ideal_species_partition_binomially():
    """eps = 0, fixed volumes: each molecule sits in box 0 with probability
    V0 / (V0 + V1) independently, so each species' box-0 count averages
    N_s V0 / (V0 + V1).  256 chains, transfers only; the standard error of
    the pooled mean is ~1.5% of it, the gate 6% (as JAX's)."""
    g = gb_t.BinaryGibbsEnsemble(_port(lj_two_blocks(24, 36, eps=0.0)),
                                 RunParams(**LJ), p_transfer=1.0,
                                 device="cpu")
    b0, b1 = 5.0, 6.5
    st = g.init(boxes=(b0, b1), n_init=[[8, 8], [12, 12]], n_chains=256)
    st, _ = g.run_block(st, 200)
    f0 = b0 ** 3 / (b0 ** 3 + b1 ** 3)
    m0, m1 = [], []
    for _ in range(3):
        st, stats = g.run_block(st, 100, drift_tol=1e-10)
        m0.append(stats["n0_mean"][0])
        m1.append(stats["n1_mean"][0])
    assert np.mean(m0) == pytest.approx(16 * f0, rel=0.06), m0
    assert np.mean(m1) == pytest.approx(24 * f0, rel=0.06), m1


def test_npt_ideal_boxes_are_gamma_distributed():
    """NPT-Gibbs at eps = 0 with transfers off: each box is an ideal-gas
    NPT cell, V_b ~ Gamma(N_b + 1, kT / P) (mean (N_b + 1) kT / P, variance
    (N_b + 1) (kT / P)^2).  Volume moves only (p_volume 1); 128 chains,
    five snapshots 40 moves apart after 100; mean within 5 standard errors,
    variance within 25% (its standard error here is ~7%)."""
    params = RunParams(**dict(LJ, p_volume=1.0, temperature=1.3))
    init, run = gb_t.make_gibbs_binary(
        _port(lj_two_blocks(4, 4, eps=0.0)), params, dv_max=0.4,
        p_transfer=0.0, npt_pressure=0.05, chunk=256, device="cpu")[:2]
    st = init(boxes=(5.0, 5.0), n_init=[[3, 3], [2, 2]], n_chains=128)
    st = run(st, 100)
    vs = []
    for _ in range(5):
        st = run(st, 40)
        vs.append(st.box.numpy() ** 3)
    v = np.stack(vs)                                       # (5, C, 2)
    kt_over_p = 1.3 / 0.05
    for b, n_b in enumerate((5, 5)):
        vb = v[:, :, b].reshape(-1)
        sem = vb.std() / np.sqrt(vb.size)
        assert abs(vb.mean() - (n_b + 1) * kt_over_p) < 5 * sem, \
            (b, vb.mean(), sem)
        assert vb.var() == pytest.approx((n_b + 1) * kt_over_p ** 2,
                                         rel=0.25)


def test_ideal_pressure_and_widom_identities():
    """pressure_fd is N_tot T / V exactly for ideal species; every ghost's
    Boltzmann factor is 1."""
    g = gb_t.BinaryGibbsEnsemble(_port(lj_two_blocks(16, 24, eps=0.0)),
                                 RunParams(**LJ), p_transfer=0.5,
                                 device="cpu")
    st = g.init(boxes=(5.0, 7.0), n_init=[[8, 8], [12, 12]], n_chains=4)
    p = g.pressure_fd(st)
    n_tot = (st.active0.sum(2) + st.active1.sum(2)).double()
    np.testing.assert_allclose(p.numpy(), (n_tot * 1.5 / st.box ** 3)
                               .numpy(), rtol=1e-9)
    for s in (0, 1):
        np.testing.assert_allclose(g.widom_boltzmann(st, 32, s).numpy(),
                                   1.0, atol=1e-12)


def test_colour_symmetry_against_one_species_gibbs():
    """Two identical interacting LJ species are colours of one fluid: the
    binary ensemble's liquid-box density (both species counted) matches
    MolGibbsEnsemble's at the same total N.  JAX's state point (40 + 40
    slots, 20 + 20 molecules, boxes 5.0 / 5.5, T* 1.5, p_volume 0.02,
    p_transfer 0.5) cut from 128 chains and 2500 + 5 x 800 steps to 64
    chains and 300 + 4 x 100; JAX's gate, max(4 standard errors of the
    four block means of each ensemble, 6% of the one-species mean)."""
    from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble

    params = RunParams(**dict(LJ, p_translate=0.6, p_volume=0.02))
    g2 = gb_t.BinaryGibbsEnsemble(_port(lj_two_blocks(40, 40)), params,
                                  dv_max=0.05, p_transfer=0.5, device="cpu",
                                  generator=torch.Generator().manual_seed(3))
    st2 = g2.init(boxes=(5.0, 5.5), n_init=[[14, 6], [6, 14]], n_chains=64)
    g1 = MolGibbsEnsemble(lj_system(80), params, dv_max=0.05,
                          p_transfer=0.5, device="cpu",
                          generator=torch.Generator().manual_seed(4))
    st1 = g1.init(boxes=(5.0, 5.5), n_init=(20, 20), n_chains=64)
    st2, _ = g2.run_block(st2, 300)
    st1, _ = g1.run_block(st1, 300)
    tot2, tot1 = [], []
    for _ in range(4):
        st2, s2 = g2.run_block(st2, 100, drift_tol=1e-10)
        st1, s1 = g1.run_block(st1, 100, drift_tol=1e-10)
        tot2.append(s2["rho_liq"])
        tot1.append(s1["rho_liq"])
    m2, m1 = np.mean(tot2), np.mean(tot1)
    sem = (np.std(tot2) + np.std(tot1)) / np.sqrt(4)
    assert abs(m2 - m1) < max(4 * sem, 0.06 * m1), (m2, m1, sem)


def test_interacting_boxes_reach_equal_pressure():
    """An interacting supercritical pair (32 + 32 LJ slots, 10 + 6 and 6 +
    10 molecules in 5.0 / 6.0 boxes, T* 2.0): at the Gibbs fixed point the
    two boxes' pressure_fd agree.  JAX's gate, max(4 standard errors of
    the four block means, 5% of box 0's), cut from 128 chains and 2000 +
    4 x 500 steps at p_volume 0.02 to 64 chains and 300 + 4 x 100 steps at
    p_volume 0.1, so that the boxes still make ~70 volume attempts each."""
    params = RunParams(**dict(LJ, temperature=2.0, p_translate=0.6,
                              p_volume=0.1))
    g = gb_t.BinaryGibbsEnsemble(_port(lj_two_blocks(32, 32)), params,
                                 dv_max=0.05, p_transfer=0.5, device="cpu",
                                 generator=torch.Generator().manual_seed(6))
    st = g.init(boxes=(5.0, 6.0), n_init=[[10, 6], [6, 10]], n_chains=64)
    st, _ = g.run_block(st, 300)
    p0, p1 = [], []
    for _ in range(4):
        st, _ = g.run_block(st, 100, drift_tol=1e-10)
        p = g.pressure_fd(st).double()
        p0.append(float(p[:, 0].mean()))
        p1.append(float(p[:, 1].mean()))
    m0, m1 = np.mean(p0), np.mean(p1)
    sem = (np.std(p0) + np.std(p1)) / np.sqrt(4)
    assert abs(m0 - m1) < max(4 * sem, 0.05 * abs(m0)), (m0, m1, sem)


# ---------------- refusals, bookkeeping, the CLI ------------------------


@pytest.mark.parametrize("system,kw,match", [
    (lj_system(8), {}, "two species"),
    (spce_two_blocks(4, 4), dict(mega="full", dtype=F32, n_orient=4),
     "n_orient=1"),
    (spce_two_blocks(4, 4), dict(mega="full", dtype=F32, p_transfer=0.0),
     "0 < p_transfer"),
    (spce_two_blocks(4, 4), dict(mega=True, dtype=F64), "float32"),
    (spce_two_blocks(4, 4), dict(mega="interpret", dtype=F32),
     "mega must be"),
    (spce_two_blocks(4, 4), dict(mega=True, dtype=F32, p_transfer=1.0),
     "p_transfer < 1"),
    (spce_two_blocks(4, 4), dict(n_orient=0), "n_orient"),
])
def test_make_gibbs_binary_guards(system, kw, match):
    params = RunParams(**dict(LJ, p_translate=0.5, dphi_max=0.5))
    with pytest.raises(ValueError, match=match):
        gb_t.make_gibbs_binary(system, params, device="cpu", **kw)


def test_init_guards_bridge_and_device():
    g = gb_t.BinaryGibbsEnsemble(_port(lj_two_blocks(8, 8)), RunParams(**LJ),
                                 device="cpu")
    with pytest.raises(ValueError, match="2 species, 2 boxes"):
        g.init(boxes=(5.0, 5.0), n_init=[4, 4], n_chains=2)
    with pytest.raises(ValueError, match="exceeds capacity"):
        g.init(boxes=(5.0, 5.0), n_init=[[9, 0], [4, 4]], n_chains=2)
    g_e = gb_t.BinaryGibbsEnsemble(spce_two_blocks(4, 4), RunParams(**dict(
        WATER, kappa_L=5.6, nk=5, ksq_max=27)), device="cpu")
    with pytest.raises(ValueError, match="erfc"):
        g_e.init(boxes=(11.0, 22.0), n_init=[[2, 2], [2, 2]], n_chains=2)
    st = g.init(boxes=(5.0, 6.0), n_init=[[6, 2], [3, 5]], n_chains=2)
    arrays = bridge.binary_gibbs_state_to_numpy(st)
    back = bridge.binary_gibbs_state_from_numpy(arrays, "cpu")
    for f in arrays:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gb_t.BinaryGibbsEnsemble(spce_two_blocks(4, 4),
                                     RunParams(**KERNEL))


def test_cli_gibbs_binary_end_to_end(tmp_path, monkeypatch):
    """The port's CLI on `"kind": "gibbs_binary"` with a two-block LJ model
    (the builder patched, as the JAX CLI test does) writes, for every
    block, the keys the JAX CLI writes (JAX run_block's scalar statistics,
    "block", "phase" and the logger's time "t"), finite; an optional
    "pressure" runs NPT-Gibbs."""
    import metropolismontecarlo_tpu_torch.run as run_t
    import metropolismontecarlo_tpu_torch.utils.config as cfg_t

    params = dict(LJ, p_volume=0.02)
    g_j = gb_j.BinaryGibbsEnsemble(lj_two_blocks(16, 16), RunParamsJ(
        **params), dv_max=0.05, p_transfer=0.4)
    _, stats_j = g_j.run_block(g_j.init(
        jax.random.PRNGKey(1), boxes=(5.0, 6.0), n_init=[[6, 4], [4, 6]],
        n_chains=2), 2)
    want = sorted([k for k, v in stats_j.items() if not isinstance(v, list)]
                  + ["block", "phase", "t"])
    monkeypatch.setattr(cfg_t, "build_system",
                        lambda cfg, base_dir=".": _port(
                            lj_two_blocks(16, 16)))
    ens = {"kind": "gibbs_binary", "boxes": [5.0, 6.0],
           "n_init": [[6, 4], [4, 6]], "dv_max": 0.05, "p_transfer": 0.4}
    for name, extra in (("nvt", {}), ("npt", {"pressure": 0.5})):
        cfg = {"model": {"kind": "lj", "n_mol": 1}, "params": params,
               "run": {"n_chains": 4, "n_blocks": 2, "n_steps": 100,
                       "seed": 1, "dtype": "float64",
                       "ensemble": dict(ens, **extra),
                       "output": {"dir": str(tmp_path / name)}}}
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cfg))
        state = run_t.main([str(path), "--quiet"], device="cpu")
        lines = [json.loads(ln) for ln in (tmp_path / name / "metrics.jsonl")
                 .read_text().splitlines()]
        assert len(lines) == 2 and all(sorted(m) == want for m in lines)
        assert all(np.isfinite(m["rho_liq"]) and np.isfinite(m["x0_liq"])
                   for m in lines)
        assert (state.active0.sum((1, 2)) == 10).all()
