"""The port's molecular muVT app (mc/gcmc_mol.py) and the sweep op's
activity, exchange and Widom arguments, on the CPU, against the JAX
package.

* Slot machinery (full_one, exchange_const, pose_batch) in float64: 1e-9.
* The exchange seam: a forced insertion pose and a forced deletion slot
  through the plain twin (f32) against JAX's pair_energy +
  recip_energy_delta + exchange_const in float64, within 2e-5 of the
  summed term magnitudes (f32 rounding of the terms; the TPU kernel's
  erfc polynomial is that far from erfc).
* mega="full" and the activity-masked sweep against the JAX kernel in
  the TPU interpreter, whose PRNG returns zeros: the port is fed zero
  uniforms and must take the same decisions (equal activity masks and
  counters), energies within 2e-5 of the magnitudes, S(k) within 1e-4
  of its largest component.
* The in-kernel score generator's torch reproduction against published
  Philox4x32-10 vectors and an independent numpy implementation.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gcmc_mol as gcmc_j
from metropolismontecarlo_tpu.mc.moves import (
    make_mega_sweep_fn as make_mega_sweep_fn_j,
)
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops import ewald as ewald_j
from metropolismontecarlo_tpu.utils import activity as activity_j
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gcmc_mol as gcmc_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors
from metropolismontecarlo_tpu_torch.utils import activity as activity_t

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


def _jax_init(params_j, dtype, mega=None, system=None, n_init=N_INIT,
              **kw):
    g = gcmc_j.MolGCMC(system or water_j.spce_system(CAP), params_j,
                       activity=2e-4, p_exchange=0.3, dtype=dtype, mega=mega,
                       **kw)
    return g, g.init(jax.random.PRNGKey(0), box=BOX, n_init=n_init,
                     n_chains=C)


def _to_port(st_j):
    return bridge.gcmc_state_from_numpy(
        {f: np.asarray(getattr(st_j, f)) for f in st_j._fields
         if f != "key"}, "cpu")


# ---------------- slot machinery, f64 ----------------------------------


@pytest.mark.parametrize("kw", [
    dict(coulomb="ewald"), dict(coulomb="wolf"),
    dict(coulomb="wolf", wolf_style="ref"), dict(coulomb="bare"),
    dict(coulomb="none", use_lrc=True)], ids=lambda k: "-".join(
        f"{a}={b}" for a, b in k.items()))
def test_full_energy_all_active_equals_energy_breakdown(kw):
    params = RunParams(**dict(WATER, temperature=300.0, r_cut=5.0, **kw))
    system = water_t.spce_system(CAP)
    g = gcmc_t.MolGCMC(system, params, activity=1e-4, p_exchange=0.0,
                       device="cpu", generator=_gen())
    st = g.init(box=12.0, n_init=CAP, n_chains=3)
    kv, kw_ = make_kvectors(params.nk, params.ksq_max) \
        if params.coulomb == "ewald" else (None, None)
    ref = energy_breakdown(system, params,
                           st.coords[:, :, :system.n_atoms].transpose(1, 2),
                           st.com, st.box, kv, kw_)
    np.testing.assert_allclose(st.energy.numpy(), ref["total"].numpy(),
                               rtol=1e-9)
    if params.coulomb == "ewald":
        np.testing.assert_allclose(st.sfac.numpy(), ref["sfac"].numpy(),
                                   atol=1e-10)
    # and again after a block of pure NVT steps (every slot stays active)
    st, stats = g.run_block(st, 40, drift_tol=1e-9)
    assert stats["n_mean"] == CAP and stats["acc_trans"] > 0.0


@pytest.mark.parametrize("kw", [
    dict(coulomb="ewald"), dict(coulomb="wolf", wolf_style="ref"),
    dict(coulomb="none", use_lrc=True)], ids=lambda k: "-".join(
        f"{a}={b}" for a, b in k.items()))
def test_slot_machinery_matches_jax_f64(kw):
    """full_one with a partial mask, exchange_const, pose_batch."""
    kw = dict(WATER, temperature=300.0, **kw)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    _, st_j = _jax_init(params_j, jnp.float64)
    ms_j = gcmc_j.make_mol_slots(water_j.spce_system(CAP), params_j,
                                 jnp.float64)
    ms_t = gcmc_t.make_mol_slots(water_t.spce_system(CAP), params_t, "cpu",
                                 F64)
    st = _to_port(st_j)
    e, sf = ms_t.full_one(st.com, st.quat, st.coords, st.active, st.box)
    np.testing.assert_allclose(e.numpy(), np.asarray(st_j.energy), rtol=1e-9)
    np.testing.assert_allclose(sf.numpy(), np.asarray(st_j.sfac), rtol=1e-9,
                               atol=1e-10)

    n_old = torch.tensor([0, 3, 5, 7])
    for dn in (+1.0, -1.0):
        got = ms_t.exchange_const(st.box, n_old, dn)
        want = [float(ms_j.exchange_const(jnp.asarray(BOX), jnp.asarray(n),
                                          dn)) for n in n_old.tolist()]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)

    rng = np.random.default_rng(2)
    k = 3
    com_t = rng.uniform(0, BOX, (C, 3))
    quats = rng.normal(size=(C, k, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    excl = rng.integers(0, N_INIT, C)
    a_ok = ms_t.atom_ok_of(st.active)
    cf_t = None
    if ms_t.use_ewald:
        from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
        cf_t = ewald_t.cfac_coeffs(ms_t.kv, ms_t.kw, params_t.kappa_L / st.box,
                                   st.box)
    u, ovr, s = ms_t.pose_batch(torch.tensor(com_t), torch.tensor(quats),
                                st.coords, st.com, st.box, a_ok,
                                torch.tensor(excl), st.sfac, cf_t)
    for c in range(C):
        cf_j = None
        if ms_j.use_ewald:
            cf_j = ewald_j.cfac_coeffs(ms_j.kv, ms_j.kw,
                                       params_j.kappa_L / BOX, BOX,
                                       jnp.float64)
        a_ok_j = ms_j.atom_ok_of(st_j.active[c])
        np.testing.assert_array_equal(a_ok[c].numpy(), np.asarray(a_ok_j))
        u_j, o_j, s_j = ms_j.pose_batch(
            jnp.asarray(com_t[c]), jnp.asarray(quats[c]), st_j.coords[c],
            st_j.com[c], st_j.box[c], a_ok_j, int(excl[c]), st_j.sfac[c],
            cf_j)
        np.testing.assert_allclose(u[c].numpy(), np.asarray(u_j), rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_array_equal(ovr[c].numpy(), np.asarray(o_j))
        np.testing.assert_allclose(s[c].numpy(), np.asarray(s_j), rtol=1e-9,
                                   atol=1e-12)


def test_rosenbluth_and_trial_quats():
    x = torch.tensor([[-1.0, -float("inf"), 2.0],
                      [-float("inf")] * 3], dtype=F64)
    m, w = gcmc_t.rosenbluth(x)
    for c in range(2):
        m_j, w_j = gcmc_j.rosenbluth(jnp.asarray(x[c].numpy()))
        assert float(m[c]) == float(m_j)
        np.testing.assert_allclose(w[c].numpy(), np.asarray(w_j))
    q = gcmc_t.make_trial_quats(3, F64)(_gen(), (5, 2))
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, rtol=1e-12)
    q1 = gcmc_t.make_trial_quats(1, F64)(_gen(), (4,))
    assert torch.equal(q1, torch.tensor([[1.0, 0, 0, 0]] * 4, dtype=F64))


# ---------------- the exchange seam ------------------------------------


def _twin_args(st, params, tables):
    f = [x.to(F32).contiguous() for x in (st.coords, st.com, st.quat,
                                          st.sfac, st.box)]
    ones = torch.ones(st.com.shape[0])
    act, actm = moves_t.activity_planes(water_t.spce_system(CAP), st.active)
    u = torch.zeros((st.com.shape[0], tables.M, sweep_op.N_UNIFORMS))
    return f + [params.temperature * ones, params.dr_max * ones,
                params.dphi_max * ones, u, tables], act, actm


@pytest.mark.parametrize("coulomb", ["ewald", "wolf_ref", "lj_lrc"])
def test_exchange_seam_forced_insertion_and_deletion(coulomb):
    kw = dict(WATER)
    if coulomb == "wolf_ref":
        kw.update(coulomb="wolf", wolf_style="ref")
    elif coulomb == "lj_lrc":
        kw.update(coulomb="none", use_lrc=True)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    sys_j, sys_t = water_j.spce_system(CAP), water_t.spce_system(CAP)
    _, st_j = _jax_init(params_j, jnp.float64)
    ms_j = gcmc_j.make_mol_slots(sys_j, params_j, jnp.float64)
    ev_j = ms_j.ev
    st = _to_port(st_j)
    kvk = make_kvectors(params_t.nk, params_t.ksq_max) \
        if params_t.coulomb == "ewald" else (None, None)
    (tables,) = moves_t.sweep_tables(sys_t, params_t, *kvk, "cpu")
    # the moves before the attempt get zero step sizes: a null displacement
    # has d_e = 0 and is accepted as a no-op, so the attempt sees the start
    # state; the active slots' moves add 1 + ... + n to the fingerprint
    args, act, actm = _twin_args(st, params_t, tables)
    args[6] = torch.zeros(C)            # dr_max
    args[7] = torch.zeros(C)            # dphi_max
    args[8][:, :, 0] = 0.0              # translate
    args[8][:, :, 4] = 0.999
    beta = 1.0 / params_t.temperature
    si = torch.tensor([float(ev_j.self_intra(jnp.asarray(BOX)))] * C)
    wc_v = float(ev_j.wolf_const_coeff(jnp.asarray(BOX))) * ms_j.q_t2 \
        + float(ev_j.lrc_self_coeff(jnp.asarray(BOX)))
    wc = torch.tensor([wc_v] * C, dtype=F32)
    n = N_INIT
    fp_moves = n * (n + 1) // 2
    vol = BOX ** 3
    cf = None
    if ms_j.use_ewald:
        cf = ewald_j.cfac_coeffs(ms_j.kv, ms_j.kw, params_j.kappa_L / BOX,
                                 BOX, jnp.float64)

    # ---- forced insertion at a given pose, into slot n (the first free)
    rng = np.random.default_rng(9)
    up = rng.uniform(0.05, 0.95, (C, 6))
    # in the lattice's empty corner (slots 5-7 are inactive), where the
    # insertion energy is of moderate size
    up[:, :3] = np.array([0.75, 0.75, 0.5]) + rng.uniform(-0.03, 0.03, (C, 3))
    u1, u2, u3 = up[:, 3], up[:, 4], up[:, 5]
    quat_ref = np.stack([np.sqrt(1 - u1) * np.sin(2 * np.pi * u2),
                         np.sqrt(1 - u1) * np.cos(2 * np.pi * u2),
                         np.sqrt(u1) * np.sin(2 * np.pi * u3),
                         np.sqrt(u1) * np.cos(2 * np.pi * u3)], -1)
    com_ref = up[:, :3] * BOX
    du_ref, ra_ref, s_ref = [], [], []
    for c in range(C):
        ra = ev_j.pose_atoms(jnp.asarray(com_ref[c]), jnp.asarray(quat_ref[c]))
        e_p, ovr = ev_j.pair_energy(jnp.asarray(com_ref[c]), ra,
                                    st_j.coords[c], st_j.com[c], st_j.box[c],
                                    ms_j.atom_ok_of(st_j.active[c]), n)
        assert not bool(ovr)
        du = float(e_p) + float(ms_j.exchange_const(st_j.box[c],
                                                    jnp.asarray(n), +1.0))
        s = np.zeros((1, 2))
        if cf is not None:
            s = ev_j.pose_sfac(ra, BOX)
            du += float(ewald_j.recip_energy_delta(st_j.sfac[c], s, cf))
        du_ref.append(du)
        ra_ref.append(np.asarray(ra))
        s_ref.append(np.asarray(s))
    du_ref = np.asarray(du_ref)
    # activities that put every chain's log acceptance ratio at -1
    z = np.exp(-1.0 + beta * du_ref) * (n + 1) / vol
    ux = torch.zeros((C, 1, 8))
    ux[:, 0, 0] = 0.2
    ux[:, 0, 1:7] = torch.tensor(up, dtype=F32)
    for u_acc, expect in ((np.exp(-1.02), True), (np.exp(-0.98), False)):
        ux[:, 0, 7] = float(u_acc)
        out = sweep_op.sweep_plain(
            *args, act=act, actm=actm, n_exch=1, ux=ux,
            z=torch.tensor(z, dtype=F32), si=si.to(F32), wc=wc,
            magnitude=True)
        stats = out[4].numpy()
        assert (stats[:, 5] == float(expect)).all(), (u_acc, stats[:, 5])
        assert (stats[:, 7] == 1.0).all() and (stats[:, 6] == 0.0).all()
    # (the last run rejected: rerun the accepting one for the state checks)
    ux[:, 0, 7] = float(np.exp(-1.02))
    coords, com, quat, sfac, stats, act2, actm2, _ = sweep_op.sweep_plain(
        *args, act=act, actm=actm, n_exch=1, ux=ux,
        z=torch.tensor(z, dtype=F32), si=si.to(F32), wc=wc, magnitude=True)
    mag = stats[:, sweep_op.N_STATS].numpy()
    assert (np.abs(stats[:, 0].numpy() - du_ref) <= 2e-5 * mag).all(), \
        (stats[:, 0].numpy() - du_ref, mag)
    P = tables.P
    np.testing.assert_allclose(
        coords[:, :, n * P:(n + 1) * P].transpose(1, 2).numpy(),
        np.asarray(ra_ref), atol=2e-5)
    np.testing.assert_allclose(com[:, n].numpy(), com_ref, atol=2e-6)
    np.testing.assert_allclose(quat[:, n].numpy(), quat_ref, atol=2e-6)
    assert (actm2[:, :n + 1] == 1.0).all() and (actm2[:, n + 1:] == 0.0).all()
    assert (act2[:, :(n + 1) * P] == 1.0).all() \
        and (act2[:, (n + 1) * P:] == 0.0).all()
    assert (stats[:, 8] == fp_moves + n + 1).all()
    if cf is not None:
        want = np.asarray(st_j.sfac) + np.asarray(s_ref)
        np.testing.assert_allclose(sfac.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())

    # ---- forced deletion of slot `victim` through explicit scores
    victim = 2
    scores = torch.zeros((C, 1, CAP))
    scores[:, 0, victim] = 0.9
    scores[:, 0, CAP - 1] = 0.99        # inactive: must not win
    du_ref = []
    s_olds = []
    for c in range(C):
        ra = st_j.coords[c][:, victim * P:(victim + 1) * P].T
        e_old, _ = ev_j.pair_energy(st_j.com[c, victim], ra, st_j.coords[c],
                                    st_j.com[c], st_j.box[c],
                                    ms_j.atom_ok_of(st_j.active[c]), victim)
        du = -float(e_old) + float(ms_j.exchange_const(st_j.box[c],
                                                       jnp.asarray(n), -1.0))
        s_old = np.zeros((1, 2))
        if cf is not None:
            s_old = ev_j.pose_sfac(ra, BOX)
            du -= float(ewald_j.recip_energy_delta(st_j.sfac[c] - s_old,
                                                   s_old, cf))
        du_ref.append(du)
        s_olds.append(np.asarray(s_old))
    du_ref = np.asarray(du_ref)
    z = n / vol * np.exp(1.0 - beta * du_ref)      # ln_acc = -1 again
    ux = torch.zeros((C, 1, 8))
    ux[:, 0, 0] = 0.7
    for u_acc, expect in ((np.exp(-0.98), False), (np.exp(-1.02), True)):
        ux[:, 0, 7] = float(u_acc)
        out = sweep_op.sweep_plain(
            *args, act=act, actm=actm, n_exch=1, ux=ux,
            z=torch.tensor(z, dtype=F32), si=si.to(F32), wc=wc,
            magnitude=True, scores=scores)
        stats = out[4].numpy()
        assert (stats[:, 6] == float(expect)).all(), (u_acc, stats[:, 6])
        assert (stats[:, 7] == 0.0).all() and (stats[:, 5] == 0.0).all()
    coords, com, quat, sfac, stats, act2, actm2, _ = out
    mag = stats[:, sweep_op.N_STATS].numpy()
    assert (np.abs(stats[:, 0].numpy() - du_ref) <= 2e-5 * mag).all(), \
        (stats[:, 0].numpy() - du_ref, mag)
    keep = [m for m in range(n) if m != victim]
    assert (actm2[:, keep] == 1.0).all() and (actm2[:, victim] == 0.0).all()
    assert (act2[:, victim * P:(victim + 1) * P] == 0.0).all()
    assert float(act2.sum()) == C * (n - 1) * P
    assert (stats[:, 8] == fp_moves + victim + 1 + CAP).all()
    # a deletion moves no atom (the null moves rebuild theirs: last bits)
    np.testing.assert_allclose(coords.numpy(), args[0].numpy(), atol=1e-5)
    if cf is not None:
        want = np.asarray(st_j.sfac) - np.asarray(s_olds)
        np.testing.assert_allclose(sfac.numpy(), want,
                                   atol=1e-4 * np.abs(want).max())


def test_empty_and_full_chains_refuse_and_count():
    """n = 0 refuses deletions, n = M refuses insertions; the attempts are
    still counted, nothing changes, Widom ghosts read n from the mask."""
    params = RunParams(**WATER)
    sys_t = water_t.spce_system(CAP)
    g = gcmc_t.MolGCMC(sys_t, params, activity=1.0, dtype=F32, device="cpu",
                       generator=_gen())
    st = g.init(box=BOX, n_init=np.array([0, CAP, 0, CAP]), n_chains=C)
    (tables,) = moves_t.sweep_tables(sys_t, params, *make_kvectors(5, 27),
                                     "cpu")
    args, act, actm = _twin_args(st, params, tables)
    ux = torch.rand((C, 6, 8), generator=_gen(1))
    ux[0, :, 0], ux[1, :, 0] = 0.9, 0.1          # empty deletes, full inserts
    ux[2, :, 0], ux[3, :, 0] = 0.1, 0.9          # and the allowed direction
    ux[:, :, 7] = 0.0
    zeros = torch.zeros(C)
    out = sweep_op.sweep_plain(*args, act=act, actm=actm, n_exch=4,
                               n_widom=2, ux=ux, z=torch.full((C,), 1e3),
                               si=zeros, wc=zeros, seed=3)
    stats, actm2, wid = out[4], out[6], out[7]
    assert stats[:2, 5:7].abs().sum() == 0.0
    assert torch.equal(actm2[:2], actm[:2])
    assert stats[:, 7].tolist() == [0.0, 4.0, 4.0, 0.0]
    assert float(stats[2, 5]) > 0.0 and float(stats[3, 6]) > 0.0
    assert actm2[2].sum() == stats[2, 5] and \
        actm2[3].sum() == CAP - stats[3, 6]
    # an empty chain's ghosts feel nothing but the reciprocal self-image
    assert bool(torch.isfinite(wid).all()) and float(wid[0, 0]) > 0.0
    # attempts of inactive slots are not counted
    assert stats[:, 3:5].sum(1).tolist() == [0.0, CAP, 0.0, CAP]


# ---------------- against the interpreted JAX kernel ---------------------


def _zero_uniforms(monkeypatch, mags=None):
    monkeypatch.setattr(
        moves_t, "draw_uniforms",
        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(
        moves_t, "draw_exchange_uniforms",
        lambda c, n, gen, dev: torch.zeros((c, n, 8)))
    if mags is not None:
        def with_magnitude(*a, **k):
            out = sweep_op.sweep_plain(*a, magnitude=True, **k)
            mags.append(out[4][:, sweep_op.N_STATS])
            return out[:4] + (out[4][:, :sweep_op.N_STATS],) + out[5:]

        monkeypatch.setattr(moves_t.sweep_op, "sweep", with_magnitude)


def test_mega_full_matches_jax_interpret_full(monkeypatch):
    params_t, params_j = RunParams(**WATER), RunParamsJ(**WATER)
    g_j, st_j = _jax_init(params_j, jnp.float32, mega="interpret_full")
    mags = []
    _zero_uniforms(monkeypatch, mags)
    g_t = gcmc_t.MolGCMC(water_t.spce_system(CAP), params_t, activity=2e-4,
                         p_exchange=0.3, dtype=F32, mega="full", device="cpu",
                         generator=_gen())
    st = _to_port(st_j)
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 44)
    st2 = g_t.run_steps(st, 44)
    assert len(mags) == 4                      # 4 cycles, one call each
    np.testing.assert_array_equal(st2.active.numpy(),
                                  np.asarray(st_j2.active))
    np.testing.assert_array_equal(st2.acc.numpy(), np.asarray(st_j2.acc))
    np.testing.assert_array_equal(st2.att.numpy(), np.asarray(st_j2.att))
    assert int(st2.acc[:, 2].sum()) > 0        # insertions were accepted
    assert (st2.att[:, 2] == 4 * 3).all()      # zero draws: all insertions
    mag = torch.stack(mags).sum(0).numpy()
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)
    ref = np.asarray(st_j2.sfac)
    np.testing.assert_allclose(st2.sfac.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())
    on = np.asarray(st_j2.active)
    np.testing.assert_allclose(st2.com.numpy()[on], np.asarray(st_j2.com)[on],
                               atol=1e-5)
    # and the port's own recompute agrees with what it carried
    _, stats = g_t.run_block(st2, 0)
    assert stats["sfac_err_max"] < 1e-4 and stats["drift_max_rel"] < 2e-3


def test_sweep_act_matches_jax_interpret_sweep_act(monkeypatch):
    params_t, params_j = RunParams(**WATER), RunParamsJ(**WATER)
    _, st_j = _jax_init(params_j, jnp.float32)
    kv, kw = make_kvectors(params_t.nk, params_t.ksq_max)
    sweep_j = make_mega_sweep_fn_j(water_j.spce_system(CAP), params_j, kv, kw,
                                   interpret=True, with_activity=True)
    ref = sweep_j(st_j.com, st_j.quat, st_j.coords, st_j.active, st_j.box,
                  st_j.sfac, jnp.zeros((C,), jnp.int32),
                  jnp.zeros((), jnp.int32))
    mags = []
    _zero_uniforms(monkeypatch, mags)
    sweep_t = moves_t.make_mega_sweep_fn(water_t.spce_system(CAP), params_t,
                                         kv, kw, "cpu", with_activity=True)
    st = _to_port(st_j)
    out = sweep_t(st.com, st.quat, st.coords, st.active, st.box, st.sfac,
                  _gen())
    com, quat, coords, sfac, d_e, acc, att = out
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref[5]))
    np.testing.assert_array_equal(att.numpy(), np.asarray(ref[6]))
    assert (att.sum(1) == N_INIT).all()        # active slots only
    assert (np.abs(d_e.numpy() - np.asarray(ref[4]))
            <= 2e-5 * mags[0].numpy()).all()
    rs = np.asarray(ref[3])
    np.testing.assert_allclose(sfac.numpy(), rs, atol=1e-4 * np.abs(rs).max())
    np.testing.assert_allclose(com.numpy(), np.asarray(ref[0]), atol=1e-5)
    # inactive slots did not move
    assert torch.equal(com[:, N_INIT:], st.com[:, N_INIT:])
    assert torch.equal(coords[:, :, N_INIT * 3:], st.coords[:, :, N_INIT * 3:])


# ---------------- the three routes' invariants on the CPU --------------


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-9),
                                            (True, F32, 2e-3),
                                            ("full", F32, 2e-3)])
def test_routes_keep_drift_and_sfac_gates(mega, dtype, tol):
    g = gcmc_t.MolGCMC(water_t.spce_system(CAP), RunParams(**WATER),
                       activity=2e-4, p_exchange=0.3, dtype=dtype, mega=mega,
                       device="cpu", generator=_gen(4))
    st = g.init(box=BOX, n_init=N_INIT, n_chains=C)
    for _ in range(3):
        st, stats = g.run_block(st, 44, drift_tol=tol)
        assert stats["sfac_err_max"] < (1e-4 if dtype == F32 else 1e-9), stats
    assert int(st.att[:, 0].sum()) > 0
    assert int((st.att[:, 2] + st.att[:, 3]).sum()) > 0
    assert int((st.acc[:, 2] + st.acc[:, 3]).sum()) > 0
    mask = g.atom_mask(st)
    assert mask.shape == (C, 128)
    assert torch.equal(mask.sum(1), 3 * st.active.sum(1))


@pytest.mark.parametrize("n_orient,bias", [(3, "orientation"), (3, "pose")])
def test_rosenbluth_biased_steps_keep_the_drift_gate(n_orient, bias):
    g = gcmc_t.MolGCMC(water_t.spce_system(CAP), RunParams(**WATER),
                       activity=2e-4, p_exchange=0.5, n_orient=n_orient,
                       bias=bias, device="cpu", generator=_gen(5))
    st = g.init(box=BOX, n_init=N_INIT, n_chains=C)
    st, stats = g.run_block(st, 60, drift_tol=1e-9)
    assert stats["sfac_err_max"] < 1e-9
    assert int((st.acc[:, 2] + st.acc[:, 3]).sum()) > 0


def test_ideal_rigid_rotor_poisson_mean_on_the_host_path():
    """eps = q = 0: N is Poisson(z V).  192 chains x 6 samples of mean
    10.8: the standard error of the mean is sqrt(10.8 / (192 x 6)) = 0.10
    were the samples independent; they are not (60 steps apart), so the
    gate is +-0.6."""
    z, box = 0.05, 6.0
    params = RunParams(strict_min_image=False, temperature=1.5, r_cut=2.5,
                       coulomb="none", p_translate=0.5, dr_max=1.0,
                       dphi_max=1.0, use_lrc=False)
    g = gcmc_t.MolGCMC(poly_t.triatomic_system(32, eps=0.0), params,
                       activity=z, p_exchange=0.6, device="cpu",
                       generator=_gen(6))
    st = g.init(box=box, n_init=10, n_chains=192)
    st, _ = g.run_block(st, 250)
    means = []
    for _ in range(6):
        st, stats = g.run_block(st, 60, drift_tol=1e-10)
        means.append(stats["n_mean"])
        assert stats["full_frac"] == 0.0
    assert abs(np.mean(means) - z * box ** 3) < 0.6, means


def test_activity_ladder_and_per_chain_n_init():
    params = RunParams(**WATER)
    z = np.array([1e-4, 2e-4, 3e-4])
    g = gcmc_t.MolGCMC(water_t.spce_system(CAP), params, activity=z,
                       dtype=F32, mega="full", device="cpu", generator=_gen())
    st = g.init(box=BOX, n_init=np.array([0, 3, 8]), n_chains=3)
    assert st.active.sum(1).tolist() == [0, 3, 8]
    st, stats = g.run_block(st, 22, drift_tol=2e-3)
    with pytest.raises(ValueError, match="ladder"):
        g.init(box=BOX, n_init=2, n_chains=4)
    with pytest.raises(ValueError, match="n_chains entries"):
        g.init(box=BOX, n_init=np.array([1, 2]), n_chains=3)
    with pytest.raises(ValueError, match="capacity"):
        g.init(box=BOX, n_init=9, n_chains=3)


# ---------------- refusals ------------------------------------------------


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mega="full"), ValueError, "float32"),
    (dict(mega=True), ValueError, "float32"),
    (dict(dtype=F32, mega="full", n_orient=4), ValueError, "unbiased"),
    (dict(dtype=F32, mega="full", bias="pose"), ValueError, "unbiased"),
    (dict(dtype=F32, mega="full", p_exchange=0.0), ValueError, "p_exchange"),
    (dict(dtype=F32, mega=True, p_exchange=1.0), ValueError, "p_exchange"),
    (dict(dtype=F32, mega="interpret"), ValueError, "mega must be"),
    (dict(n_orient=0), ValueError, "n_orient"),
    (dict(bias="cavity"), ValueError, "bias"),
    (dict(activity=np.ones((2, 2))), ValueError, "ladder"),
    (dict(tmmc=True, dtype=F32, mega=True, p_exchange=0.0), ValueError,
     "mc/tmmc.py"),
])
def test_make_gcmc_mol_refusals(kw, exc, match):
    kw = dict(dict(activity=1e-4, device="cpu"), **kw)
    with pytest.raises(exc, match=match):
        gcmc_t.make_gcmc_mol(water_t.spce_system(CAP), RunParams(**WATER),
                             **kw)


@pytest.mark.parametrize("bad", ["mixture", "surface", "nlist", "charged",
                                 "min_image", "cuda"])
def test_mol_slots_refusals(bad):
    params = RunParams(**WATER)
    system = water_t.spce_system(CAP)
    if bad == "mixture":
        system, match = water_t.spce_methane_system(4, 4), "uniform"
    elif bad == "surface":
        params, match = dataclasses.replace(params, ewald_surface=True), \
            "ewald_surface"
    elif bad == "nlist":
        params, match = dataclasses.replace(params, nlist_width=8), "neighbor"
    elif bad == "charged":
        q = np.array(system.charges)
        q[:, 0] += 0.1
        system, match = dataclasses.replace(system, charges=q), "neutral"
    if bad == "min_image":
        init, _, _ = gcmc_t.make_gcmc_mol(
            system, dataclasses.replace(params, strict_min_image=True), 1e-4,
            device="cpu")
        with pytest.raises(ValueError, match="minimum-image"):
            init(box=8.0, n_init=2, n_chains=2)
    elif bad == "cuda":
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gcmc_t.make_gcmc_mol(system, params, 1e-4)
    else:
        with pytest.raises(ValueError, match=match):
            gcmc_t.make_gcmc_mol(system, params, 1e-4, device="cpu")


@pytest.mark.parametrize("bad", ["no_activity", "counts", "tmmc", "wolf"])
def test_mega_sweep_fn_exchange_refusals(bad):
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system

    params = RunParams(**dict(WATER, r_cut=4.0))
    kv, kw = make_kvectors(5, 27)
    mix = co2_n2_system(4, 4)
    if bad == "no_activity":
        with pytest.raises(ValueError, match="with_activity"):
            moves_t.make_mega_sweep_fn(mix, params, kv, kw, "cpu", n_exch=2)
    elif bad == "counts":
        with pytest.raises(ValueError, match="per species block"):
            moves_t.make_mega_sweep_fn(mix, params, kv, kw, "cpu",
                                       with_activity=True, n_exch=(1, 2, 3))
    elif bad == "tmmc":
        with pytest.raises(ValueError, match="TMMC"):
            moves_t.make_mega_sweep_fn(mix, params, kv, kw, "cpu",
                                       with_activity=True, n_exch=2,
                                       tmmc_exch=True)
    else:
        q = np.array(mix.charges)
        q[:4, 0] += 0.2
        charged = dataclasses.replace(mix, charges=q)
        with pytest.raises(ValueError, match="charge-neutral"):
            moves_t.make_mega_sweep_fn(
                charged, dataclasses.replace(params, coulomb="wolf"), None,
                None, "cpu", with_activity=True, n_exch=(1, 1))


def test_signature_switch_and_two_block_exchanges():
    """All-zero counts give the 7-argument sweep_act; per-block counts
    give sweep_x, whose per-species counters come from each launch."""
    from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system

    params = RunParams(**dict(WATER, r_cut=4.0, temperature=300.0))
    kv, kw = make_kvectors(5, 27)
    mix = co2_n2_system(4, 4)
    f = moves_t.make_mega_sweep_fn(mix, params, kv, kw, "cpu",
                                   with_activity=True, n_exch=(0, 0))
    assert f.__name__ == "sweep_act"
    f = moves_t.make_mega_sweep_fn(mix, params, kv, kw, "cpu",
                                   with_activity=True, n_exch=(3, 2),
                                   n_widom=(0, 2))
    assert f.__name__ == "sweep_x"
    from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
    mc = MonteCarlo(mix, params, device="cpu", generator=_gen())
    s = mc.init_state(cubic_lattice(8, 9.0), box=9.0, n_chains=C)
    active = torch.tensor([[1, 1, 0, 0, 1, 0, 0, 0]] * C, dtype=torch.bool)
    ones = torch.ones(C)
    out = f(s.com, s.quat, s.coords, active, s.box, s.sfac, _gen(2),
            (0.05 * ones, 0.05 * ones), (0 * ones, 0 * ones),
            (0 * ones, 0 * ones))
    com, quat, coords, act_o, sfac, d_e, acc, att, wid = out
    assert acc.shape == (C, 6) and att.shape == (C, 6)
    assert (att[:, 2] + att[:, 3] == 3).all() and \
        (att[:, 4] + att[:, 5] == 2).all()
    assert (att[:, :2].sum(1) == 3).all()
    n0 = act_o[:, :4].sum(1) - 2
    n1 = act_o[:, 4:].sum(1) - 1
    assert torch.equal(n0.float(), acc[:, 2] - acc[:, 3])
    assert torch.equal(n1.float(), acc[:, 4] - acc[:, 5])
    assert wid.shape == (C, 2, 2) and (wid[:, 0] == 0).all() \
        and bool((wid[:, 1, 0] >= 0).all())


# ---------------- helpers -------------------------------------------------


def test_activity_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((3, 6)) < 0.5
    i = np.array([0, 5, 2])
    flag = np.array([True, False, True])
    for name in ("set_slot", "clear_slot"):
        got = getattr(activity_t, name)(torch.tensor(a), torch.tensor(i),
                                        torch.tensor(flag))
        want = np.stack([np.asarray(getattr(activity_j, name)(
            jnp.asarray(a[c]), int(i[c]), bool(flag[c]))) for c in range(3)])
        np.testing.assert_array_equal(got.numpy(), want)
    a2 = rng.random((3, 2, 6)) < 0.5
    b = np.array([1, 0, 1])
    for name in ("set_slot2", "clear_slot2"):
        got = getattr(activity_t, name)(torch.tensor(a2), torch.tensor(b),
                                        torch.tensor(i), torch.tensor(flag))
        want = np.stack([np.asarray(getattr(activity_j, name)(
            jnp.asarray(a2[c]), int(b[c]), int(i[c]), bool(flag[c])))
            for c in range(3)])
        np.testing.assert_array_equal(got.numpy(), want)
    # unbatched, as the JAX functions are called
    got = activity_t.set_slot(torch.tensor(a[0]), 3, True)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(activity_j.set_slot(jnp.asarray(a[0]), 3,
                                                    True)))


def _philox_numpy(ctr, key):
    """Philox4x32-10 with numpy uint64 arithmetic."""
    c = [np.uint64(x) for x in ctr]
    k = [np.uint64(x) for x in key]
    m32 = np.uint64(0xFFFFFFFF)
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & m32]
        k = [(k[0] + np.uint64(0x9E3779B9)) & m32,
             (k[1] + np.uint64(0xBB67AE85)) & m32]
    return [int(x) for x in c]


# Random123's known-answer vectors for philox4x32 with 10 rounds
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_reproduction_matches_known_answers(ctr, key, want):
    got = sweep_op.philox4x32([torch.tensor(x) for x in ctr],
                              [torch.tensor(x) for x in key])
    assert tuple(int(x) for x in got) == want
    assert tuple(_philox_numpy(ctr, key)) == want


def test_philox_scores_are_the_first_word_of_slot_attempt_seed_chain():
    sc = sweep_op.philox_scores(seed=0x1234ABCD, n_chains=3, attempt=7,
                                m_start=5, M=4, device="cpu")
    assert sc.shape == (3, 4) and sc.dtype == torch.int64
    for c in range(3):
        for i in range(4):
            w0 = _philox_numpy((5 + i, 7, 0, 0), (0x1234ABCD, c))[0]
            assert int(sc[c, i]) == w0 >> 8
    # a uniform pick: over many attempts each active slot wins equally
    wins = torch.zeros(4)
    for a in range(400):
        wins[sweep_op.philox_scores(1, 1, a, 0, 4, "cpu")[0].argmax()] += 1
    assert float(wins.min()) > 70 and float(wins.max()) < 130


def test_smem_bytes_counts_every_region_of_the_layout():
    """The kernel's shared-memory regions, added up (an earlier count
    left out one of the P-wide site rows).  The COM and quaternion rows
    and the per-atom charge and type rows live in global memory, so no
    region grows with the molecule count but the activity planes."""
    M, P, A, K, T = 750, 3, 2304, 337, 2
    # 8 warps x 128 live pair terms (key + d^2) and 64 near (atom, pose)
    queues = 2 * 8 * 128 + 8 * 64
    regions = (64                       # slot-pick reduction, 32 x 8 B
               + queues                 # live pair terms, near pairs
               + 4 * A                  # x, y, z, molecule
               + 8 * K                  # S re/im, cfac, dS re/im, kx, ky, kz
               + 4 * P * T              # eps, sig2, lam1, lam2
               + 3 * P + P + P + P + P  # body, charge, LJ/charge flag, cut
               + 2 * (4 * P + 4 * P)    # two proposals: old, new site rows
               + 2 * 16 + 16 + 32       # proposals, uniforms, partials
               + 16)                    # the chain's statistics
    assert sweep_op.smem_bytes(M, P, A, K, T) == 4 * regions
    assert sweep_op.smem_bytes(M, P, A, K, T, True) == 4 * (regions + A + M)
    assert sweep_op.smem_bytes(10, P, A, K, T) == 4 * regions
    # three flagship blocks per SM: 228 KB, 1 KB of it reserved per block
    assert 3 * (sweep_op.smem_bytes(M, P, A, K, T) + 1024) <= 228 * 1024
    # capacity-512 SPC/E muVT with its activity planes: three too
    muvt = sweep_op.smem_bytes(512, 3, 1536, 337, 2, True)
    assert 3 * (muvt + 1024) <= 228 * 1024
    # the global layout keeps the atom rows in global memory too: whatever
    # the atom and molecule counts, the rest remains
    glob = regions - 4 * A
    for shape in ((M, P, A, K, T), (6859, 3, 33408, K, T)):
        assert sweep_op.smem_bytes(*shape, layout="global") == 4 * glob
    # the 6859-water cell: K = 2874, two blocks per SM
    big = sweep_op.smem_bytes(6859, 3, 33408, 2874, 2, layout="global")
    assert big == 4 * (64 + queues + 8 * 2874 + 4 * 3 * 2 + 23 * 3 + 96)
    assert 2 * (big + 1024) <= 228 * 1024


def test_bridge_roundtrips_the_muvt_state():
    g = gcmc_t.MolGCMC(water_t.spce_system(CAP), RunParams(**WATER),
                       activity=1e-4, device="cpu", generator=_gen())
    st = g.init(box=BOX, n_init=3, n_chains=2)
    arrays = bridge.gcmc_state_to_numpy(st)
    assert arrays["active"].dtype == np.bool_
    back = bridge.gcmc_state_from_numpy(arrays, "cpu")
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(back, f.name), getattr(st, f.name)), f.name
    with pytest.raises(KeyError, match="active"):
        bridge.gcmc_state_from_numpy(
            {k: v for k, v in arrays.items() if k != "active"}, "cpu")
