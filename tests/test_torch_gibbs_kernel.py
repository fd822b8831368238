"""The port's two-box Gibbs op (ops/cuda/gibbs_kernel.py) on the CPU,
against the JAX package's Pallas kernel in the TPU interpreter.

* sweep_gibbs_plain against JAX sweep_gibbs_pallas(interpret=True) through
  the two make_mega_gibbs_fn wrappers: the interpreter's PRNG returns
  zeros, so the port is fed zero uniforms and all-zero deletion scores
  (every move translates by -dr_max / 2, every transfer goes box 0 -> 1,
  deletes the lowest active slot and inserts at the origin with the
  quaternion (0, 1, 0, 0)).  Unequal boxes (11 and 13 A), so a kernel
  that used one box's constants for the other would differ.  Equal
  decisions, coordinates within 1e-5 A, S(k) within 1e-5 of its largest
  component, per-box energy deltas within 1e-5 of the cycle's term
  magnitudes (sweep_gibbs_plain's magnitude column).
* A two-block CO2/N2 state through m_start / a_start against JAX's
  make_mega_gibbs_binary_fn, the same way.
* One transfer of the f32 twin against the float64 slot machinery
  (pair energies, S(k) deltas, exchange constants) of each box.
* The refusals: an empty source box or a full destination box changes
  nothing; the wrapper's device and shape checks; the shared-memory count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gibbs_mol as gibbs_mol_j
from metropolismontecarlo_tpu.mc.moves import (
    make_mega_gibbs_binary_fn as make_binary_j,
)
from metropolismontecarlo_tpu.mc.moves import (
    make_mega_gibbs_fn as make_gibbs_j,
)
from metropolismontecarlo_tpu.models import linear as linear_j
from metropolismontecarlo_tpu.models import polyatomic as poly_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import make_mol_slots
from metropolismontecarlo_tpu_torch.models import linear as linear_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from metropolismontecarlo_tpu_torch.ops.cuda import gibbs_kernel as gibbs_op
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.ops.quaternions import (
    normalize,
    rotate_vectors,
)

F32 = torch.float32
BOXES = (11.0, 13.0)
C, CAP, NX = 4, 8, 5
KL, NK, KSQ = ewald_t.tune_parameters(13.0, 4.5, 1e-3)
WATER = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", kappa_L=KL, nk=NK, ksq_max=KSQ, use_lrc=False,
             p_translate=0.5, p_volume=0.0, dr_max=0.3, dphi_max=0.3,
             strict_min_image=False)
CASES = {
    "ewald": (water_j.spce_system, water_t.spce_system, WATER),
    "wolf": (water_j.spce_system, water_t.spce_system,
             dict(WATER, coulomb="wolf", kappa_L=2.0)),
    "none-linear": (poly_j.triatomic_system, poly_t.triatomic_system,
                    dict(WATER, temperature=2.0, r_cut=2.5, coulomb="none",
                         lj_shift="linear", dr_max=0.3, dphi_max=0.5)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _consts(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-60.0, -40.0, (C, 2)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (C, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_cycles():
    """JAX's interpreted cycle of every case, once per module: (state,
    outputs, si2, wc2, boxes)."""
    out = {}
    for name, (sys_j, _, kw) in CASES.items():
        boxes = BOXES if kw["coulomb"] != "none" else (6.0, 7.0)
        g = gibbs_mol_j.MolGibbsEnsemble(sys_j(CAP), RunParamsJ(**kw),
                                         p_transfer=0.4, dtype=jnp.float32,
                                         mega="interpret_full")
        st = g.init(jax.random.PRNGKey(4), boxes=boxes, n_init=(6, 2),
                    n_chains=C)
        kv, kw_ = (ewald_t.make_kvectors(NK, KSQ) if kw["coulomb"] == "ewald"
                   else (None, None))
        fn = make_gibbs_j(sys_j(CAP), RunParamsJ(**kw), kv, kw_,
                          interpret=True, n_exch=NX)
        si2, wc2 = _consts(len(out))
        res = fn(st.com, st.quat, st.coords, st.active, st.box, st.sfac,
                 jnp.zeros((C,), jnp.int32), jnp.zeros((), jnp.int32),
                 jnp.asarray(si2), jnp.asarray(wc2))
        out[name] = (st, [np.asarray(x) for x in res], si2, wc2)
    return out


def _plain_with_zero_scores(mags):
    """sweep_gibbs as the JAX interpreter runs it: the plain twin with
    all-zero deletion scores (the lowest active slot), recording the
    magnitude column."""
    def op(*a, **k):
        k.pop("seed", None)
        n_c, m_off = a[0].shape[0], a[1].shape[2]
        out = gibbs_op.sweep_gibbs_plain(
            *a, magnitude=True,
            scores=torch.zeros((n_c, k.get("n_exch", 0), 2 * m_off)), **k)
        mags.append(out[4][:, gibbs_op.N_STATS])
        return out[:4] + (out[4][:, :gibbs_op.N_STATS],) + out[5:]

    return op


def _zero_draws(monkeypatch, mags):
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))
    monkeypatch.setattr(moves_t.gibbs_op, "sweep_gibbs",
                        _plain_with_zero_scores(mags))


def _to_port(st_j):
    return bridge.mol_gibbs_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _assert_cycle_agrees(got, want, mag):
    names = ("com", "quat", "coords", "active", "sfac", "d_e", "acc", "att")
    got = dict(zip(names, (x.numpy() for x in got)))
    want = dict(zip(names, want))
    for k in ("active", "acc", "att"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("com", "quat", "coords"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["sfac"], want["sfac"],
                               atol=1e-5 * max(1.0, np.abs(want["sfac"])
                                               .max()))
    assert (np.abs(got["d_e"] - want["d_e"]) <= 1e-5 * mag[:, None]).all(), \
        (got["d_e"] - want["d_e"], mag)


@pytest.mark.parametrize("name", list(CASES))
def test_sweep_gibbs_plain_matches_jax_interpreted_kernel(name, jax_cycles,
                                                          monkeypatch):
    _, sys_t, kw = CASES[name]
    st_j, want, si2, wc2 = jax_cycles[name]
    mags = []
    _zero_draws(monkeypatch, mags)
    params = RunParams(**kw)
    kv, kw_ = (ewald_t.make_kvectors(NK, KSQ) if kw["coulomb"] == "ewald"
               else (None, None))
    fn = moves_t.make_mega_gibbs_fn(sys_t(CAP), params, kv, kw_, "cpu",
                                    n_exch=NX)
    st = _to_port(st_j)
    got = fn(st.com, st.quat, st.coords, st.active, st.box, st.sfac,
             torch.Generator(), torch.tensor(si2), torch.tensor(wc2))
    assert len(mags) == 1
    _assert_cycle_agrees(got, want, mags[0].numpy())
    # transfers were accepted, and both boxes' energies moved
    assert want[6][:, 2].sum() > 0
    assert (np.abs(want[5]) > 0).all()


def _binary_state(system, boxes, n_act):
    """A two-box f32 CO2/N2 state (numpy, JAX's binary layout): lattice
    COMs, random orientations, the first n_act[b][s] slots of species s
    active in box b, S(k) of the active charges."""
    rng = np.random.default_rng(7)
    M, A, A_pad = system.n_mol, system.n_atoms, system.n_atoms_padded
    from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice

    com = np.stack([cubic_lattice(M, b) for b in boxes])[None].repeat(C, 0)
    quat = normalize(torch.tensor(rng.normal(size=(C, 2, M, 4)))).numpy()
    body = torch.tensor(np.asarray(system.body))               # (M, P, 3)
    ra = torch.tensor(com)[..., None, :] + rotate_vectors(
        torch.tensor(quat), body)                               # (C,2,M,P,3)
    mol, slot = system.atom_mol_slot
    atoms = ra[:, :, mol, slot]                                 # (C,2,A,3)
    coords = np.zeros((C, 2, 3, A_pad))
    coords[..., :A] = atoms.transpose(2, 3).numpy()
    caps = [m1 - m0 for _, m0, m1, _, _ in system.species_slices]
    act = [np.zeros((C, 2, cap), bool) for cap in caps]
    for b in range(2):
        for s in range(2):
            act[s][:, b, :n_act[b][s]] = True
    on_mol = np.concatenate(act, axis=2)                        # (C, 2, M)
    q = torch.tensor(system.flat(system.charges))
    kv, _ = ewald_t.make_kvectors(NK, KSQ)
    sfac = ewald_t.structure_factor(
        atoms, q * torch.tensor(on_mol[..., mol]),
        torch.tensor(kv), torch.tensor(boxes)[None].expand(C, 2))
    f32 = np.float32
    return dict(com=com.astype(f32), quat=quat.astype(f32),
                coords=coords.astype(f32), act=act,
                box=np.broadcast_to(np.asarray(boxes, f32), (C, 2)).copy(),
                sfac=sfac.numpy().astype(f32))


def test_two_species_blocks_match_jax_binary_kernel(monkeypatch):
    """m_start / a_start: one call per species block with the activity
    planes threaded, against JAX's make_mega_gibbs_binary_fn."""
    kw = dict(WATER, temperature=300.0, r_cut=5.0, dr_max=0.4)
    n_x = (3, 2)
    sys_j, sys_t = linear_j.co2_n2_system(8, 4), linear_t.co2_n2_system(8, 4)
    s = _binary_state(sys_t, BOXES, ((6, 3), (2, 1)))
    kv, kw_ = ewald_t.make_kvectors(NK, KSQ)
    rng = np.random.default_rng(3)
    si2s = [rng.uniform(-60, -40, (C, 2)).astype(np.float32)
            for _ in range(2)]
    wc2s = [np.zeros((C, 2), np.float32)] * 2
    fn_j = make_binary_j(sys_j, RunParamsJ(**kw), kv, kw_, interpret=True,
                         n_exch=n_x)
    want = [np.asarray(x) for x in fn_j(
        jnp.asarray(s["com"]), jnp.asarray(s["quat"]),
        jnp.asarray(s["coords"]), jnp.asarray(s["act"][0]),
        jnp.asarray(s["act"][1]), jnp.asarray(s["box"]),
        jnp.asarray(s["sfac"]), jnp.zeros((C,), jnp.int32),
        jnp.zeros((), jnp.int32), tuple(map(jnp.asarray, si2s)),
        tuple(map(jnp.asarray, wc2s)))]

    tables = moves_t.sweep_tables(sys_t, RunParams(**kw), kv, kw_, "cpu")
    assert [(t.m_start, t.a_start, t.M, t.P) for t in tables] == \
        [(0, 0, 8, 3), (8, 24, 4, 3)]
    on = np.concatenate(s["act"], axis=2)
    act, actm = moves_t.activity_planes(
        sys_t, torch.tensor(on.reshape(2 * C, -1)))
    args = [torch.tensor(s[k]) for k in ("coords", "com", "quat", "sfac",
                                         "box")]
    act, actm = act.reshape(C, 2, -1), actm.reshape(C, 2, -1)
    ones = torch.ones(C)
    stats, mag = 0.0, 0.0
    for t, nx, si2, wc2 in zip(tables, n_x, si2s, wc2s):
        out = gibbs_op.sweep_gibbs_plain(
            *args, kw["temperature"] * ones, kw["dr_max"] * ones,
            kw["dphi_max"] * ones, torch.zeros((C, 2 * t.M, 10)), t, act,
            actm, n_exch=nx, ux=torch.zeros((C, nx, 8)),
            si2=torch.tensor(si2), wc2=torch.tensor(wc2), magnitude=True,
            scores=torch.zeros((C, nx, 2 * sys_t.n_mol)))
        args[:4], (st, act, actm) = list(out[:4]), out[4:]
        stats, mag = stats + st, mag + st[:, gibbs_op.N_STATS]
    coords, com, quat, sfac = args[:4]
    (com_j, quat_j, coords_j, a0_j, a1_j, sfac_j, de_j, acc_j,
     att_j) = want
    np.testing.assert_array_equal(actm.numpy() > 0.5,
                                  np.concatenate([a0_j, a1_j], axis=2))
    np.testing.assert_array_equal(stats[:, [2, 3]].numpy(), acc_j[:, :2])
    np.testing.assert_array_equal(stats[:, 6].numpy(),
                                  acc_j[:, 2] + acc_j[:, 3])
    np.testing.assert_array_equal(stats[:, [4, 5]].numpy(), att_j[:, :2])
    assert acc_j[:, 2:].sum() > 0
    for got, ref in ((com, com_j), (quat, quat_j), (coords, coords_j)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(sfac.numpy(), sfac_j,
                               atol=1e-5 * np.abs(sfac_j).max())
    assert (np.abs(stats[:, :2].numpy() - de_j)
            <= 1e-5 * mag.numpy()[:, None]).all()


def _water_slots(kw, dtype):
    return make_mol_slots(water_t.spce_system(CAP), RunParams(**kw), "cpu",
                          dtype)


@pytest.mark.parametrize("coulomb", ["ewald", "wolf"])
def test_one_transfer_matches_the_f64_slot_machinery(coulomb):
    """A forced transfer from box 1 (13 A) into box 0 (11 A) at a given
    pose: the twin's per-box energy deltas of the attempt (the cycle's
    stats less those of the same cycle without it) against -u_exist +
    const(box 1) and u_ins + const(box 0) from the float64 pair energies,
    S(k) deltas and exchange constants of the state the moves left, each
    with its own box's kappa, cfac and constants."""
    kw = dict(WATER, coulomb=coulomb)
    if coulomb == "wolf":
        kw["kappa_L"] = 2.0
    sys_t = water_t.spce_system(CAP)
    args, kx = _cycle_inputs(sys_t, kw, ((3, 5),) * C, 1)
    ms64 = make_mol_slots(sys_t, RunParams(**kw), "cpu", torch.float64)
    ev = ms64.ev
    box = args[4].double()
    si2 = ev.self_intra(box)
    wc2 = ev.wolf_const_coeff(box) * ms64.q_t2
    kx.update(si2=si2.to(F32), wc2=wc2.to(F32))
    kx["ux"][:, 0, 0] = 0.9                        # box 1 -> box 0
    kx["ux"][:, 0, 7] = 0.0                        # ln u = -69
    kx["ux"][:, 0, 1:4] = 0.0     # at the origin, clear of the lattice
    del_slot = 2
    scores = torch.zeros((C, 1, 2 * CAP))
    scores[:, 0, CAP + del_slot] = 1.0             # box 1, slot 2
    if coulomb == "ewald":
        args[3] = ewald_t.structure_factor(
            args[0].transpose(2, 3), _charges(sys_t, args[10]),
            ms64.kv, args[4]).contiguous()
    moves = gibbs_op.sweep_gibbs_plain(*args, magnitude=True)
    out = gibbs_op.sweep_gibbs_plain(*args, **kx, magnitude=True,
                                     scores=scores)
    assert (out[4][:, 6] == 1).all()
    for i in range(4):
        assert torch.equal(out[4][:, 2 + i], moves[4][:, 2 + i])
    np.testing.assert_array_equal(out[6][:, 1, del_slot].numpy(), 0.0)
    np.testing.assert_array_equal(out[6][:, 0, 3].numpy(), 1.0)
    de = (out[4][:, :2] - moves[4][:, :2]).double()
    mag = (out[4][:, gibbs_op.N_STATS]
           - moves[4][:, gibbs_op.N_STATS]).double()

    # the float64 reference, on the state the moves left
    coords, com, quat, sfac = (x.double() for x in moves[:4])
    active = moves[6] > 0.5
    com_i, quat_i = com[:, 1, del_slot], quat[:, 1, del_slot]
    ra_old = coords[:, 1, :, 3 * del_slot:3 * del_slot + 3].transpose(1, 2)
    e_old, _ = ev.pair_energy(com_i[:, None], ra_old[:, None], coords[:, 1],
                              com[:, 1], box[:, 1],
                              ms64.atom_ok_of(active[:, 1]),
                              torch.full((C,), del_slot))
    u_exist = e_old[:, 0]
    ct, q_ins, _ = sweep_op.trial_pose(kx["ux"][:, 0].double(), box[:, 0],
                                       ev.body_t)
    ra_in = ev.pose_atoms(ct, q_ins)
    u_in, _ = ev.pair_energy(ct[:, None], ra_in[:, None], coords[:, 0],
                             com[:, 0], box[:, 0],
                             ms64.atom_ok_of(active[:, 0]), -1)
    u_in = u_in[:, 0]
    if coulomb == "ewald":
        cf = [ewald_t.cfac_coeffs(ms64.kv, ms64.kw, KL / box[:, b],
                                  box[:, b]) for b in range(2)]
        s_old = ev.pose_sfac(ra_old, box[:, 1])
        u_exist = u_exist + ewald_t.recip_energy_delta(
            sfac[:, 1] - s_old, s_old, cf[1])
        u_in = u_in + ewald_t.recip_energy_delta(
            sfac[:, 0], ev.pose_sfac(ra_in, box[:, 0]), cf[0])
    n_act = active.sum(2)
    du_s = -u_exist + ms64.exchange_const(box[:, 1], n_act[:, 1], -1.0)
    du_d = u_in + ms64.exchange_const(box[:, 0], n_act[:, 0], +1.0)
    assert ((de[:, 1] - du_s).abs() <= 2e-5 * mag).all(), (de[:, 1], du_s)
    assert ((de[:, 0] - du_d).abs() <= 2e-5 * mag).all(), (de[:, 0], du_d)
    # the per-box constants differ between the boxes
    assert (si2[:, 0] != si2[:, 1]).all()


def _charges(system, act):
    """(C, 2, A_pad) f32 charges of the active atoms."""
    q = np.zeros(act.shape[-1], np.float32)
    q[:system.n_atoms] = system.flat(system.charges)
    return torch.tensor(q) * act


def _cycle_inputs(sys_t, kw, n_act, n_x, seed=0):
    """Plain f32 arguments of one cycle on a fresh two-box lattice state."""
    params = RunParams(**kw)
    ms = make_mol_slots(sys_t, params, "cpu", F32)
    gen = torch.Generator().manual_seed(seed)
    com, quat, coords = (torch.stack(
        [ms.pose_lattice_init(gen, bl, C)[i] for bl in BOXES], 1)
        for i in range(3))
    active = torch.zeros((C, 2, ms.cap), dtype=torch.bool)
    for c, (n0, n1) in enumerate(n_act):
        active[c, 0, :n0] = True
        active[c, 1, :n1] = True
    act, actm = moves_t.activity_planes(
        sys_t, active.reshape(2 * C, ms.cap))
    (t,) = moves_t.sweep_tables(sys_t, params, ms.kvecs, ms.kweights, "cpu")
    ones = torch.ones(C)
    box = torch.tensor(BOXES, dtype=F32)[None].expand(C, 2).contiguous()
    u = torch.rand((C, 2 * ms.cap, 10), generator=gen)
    ux = torch.rand((C, n_x, 8), generator=gen)
    return [coords, com, quat,
            torch.zeros((C, 2, ms.K, 2)), box, kw["temperature"] * ones,
            kw["dr_max"] * ones, kw["dphi_max"] * ones, u, t,
            act.reshape(C, 2, -1), actm.reshape(C, 2, -1)], dict(
                n_exch=n_x, ux=ux, si2=torch.zeros((C, 2)),
                wc2=torch.zeros((C, 2)), seed=11)


def test_empty_source_and_full_destination_change_nothing():
    """Chain 0 holds every molecule in box 0 and box 1 is empty, chain 1
    has box 0 full, chain 3 holds no molecule: their transfers out of an
    empty box or into a full one are refused and write nothing; N is
    conserved on every chain."""
    kw = dict(WATER, coulomb="none")
    args, kx = _cycle_inputs(water_t.spce_system(CAP), kw,
                             ((CAP, 0), (CAP, 3), (4, 4), (0, 0)), 6)
    kx["ux"][:2, :, 0] = 0.9          # chains 0, 1: every attempt 1 -> 0
    kx["ux"][:, :, 7] = 0.0           # accept whatever may be accepted
    out = gibbs_op.sweep_gibbs_plain(*args, **kx)
    stats, act, actm = out[4], out[5], out[6]
    assert stats[[0, 1, 3], 6].tolist() == [0.0, 0.0, 0.0]
    assert stats[2, 6] > 0
    for c in (0, 1, 3):
        assert torch.equal(actm[c], args[11][c])
        assert torch.equal(act[c], args[10][c])
    assert torch.equal(actm.sum((1, 2)), args[11].sum((1, 2)))
    # chain 3 has nothing to move either: no attempt, no energy
    assert float(stats[3].abs().sum()) == 0.0


def test_sweep_gibbs_routes_the_cpu_to_the_plain_version():
    kw = dict(WATER, coulomb="wolf", kappa_L=2.0)
    args, kx = _cycle_inputs(water_t.spce_system(CAP), kw,
                             ((5, 3),) * C, 4)
    gibbs_op.sweep_gibbs.launches = 0
    got = gibbs_op.sweep_gibbs(*args, **kx)
    want = gibbs_op.sweep_gibbs_plain(*args, **kx)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert gibbs_op.sweep_gibbs.launches == 0          # no kernel launched
    meta = [x.to("meta") if torch.is_tensor(x) else x for x in args]
    t = args[9]
    meta[9] = dataclasses.replace(t, **{k: v.to("meta") for k, v in
                                        t.tensors().items()})
    with pytest.raises(ValueError, match="no sweep_gibbs for device"):
        gibbs_op.sweep_gibbs(*meta, **{k: (v.to("meta") if torch.is_tensor(v)
                                           else v) for k, v in kx.items()})


def test_deletion_pick_follows_the_philox_scores():
    """Without forced scores the twin deletes, on each chain, the source
    box's active slot with the largest Philox score of its plane id."""
    kw = dict(WATER, coulomb="none")
    args, kx = _cycle_inputs(water_t.spce_system(CAP), kw,
                             ((6, 2),) * C, 1)
    kx["ux"][:, 0, 0] = 0.1                        # box 0 -> 1
    kx["ux"][:, 0, 7] = 0.0                        # accept
    out = gibbs_op.sweep_gibbs_plain(*args, **kx)
    sc = sweep_op.philox_scores(kx["seed"], C, 0, 0, CAP, "cpu")[:, :6]
    want = sc.argmax(1)
    gone = (args[11][:, 0] - out[6][:, 0]).argmax(1)
    ok = out[4][:, 6] > 0
    assert ok.any()
    assert torch.equal(gone[ok], want[ok])
    # box 1 scores use the plane ids m_off + j
    sc1 = sweep_op.philox_scores(kx["seed"], C, 0, CAP, CAP, "cpu")
    assert not torch.equal(sc1, sweep_op.philox_scores(kx["seed"], C, 0, 0,
                                                       CAP, "cpu"))


def test_input_checks():
    kw = dict(WATER, coulomb="none")
    args, kx = _cycle_inputs(water_t.spce_system(CAP), kw, ((4, 4),) * C, 2)
    bad = list(args)
    bad[8] = args[8][:, :CAP]
    with pytest.raises(ValueError, match="u: shape"):
        gibbs_op.sweep_gibbs(*bad, **kx)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="coords: dtype"):
        gibbs_op.sweep_gibbs(*bad, **kx)
    with pytest.raises(ValueError, match="ux is required"):
        gibbs_op.sweep_gibbs(*args, **dict(kx, ux=None))
    t = args[9]
    bad = list(args)
    bad[9] = dataclasses.replace(t, m_start=CAP - 2)
    with pytest.raises(ValueError, match="block within"):
        gibbs_op.sweep_gibbs(*bad, **kx)


def test_gibbs_smem_bytes_counts_every_region_of_the_layout():
    """The kernel's shared-memory regions, added up; the flagship (cap 128
    SPC/E per box, A_pad 512, K 783, nk 7) leaves shared memory for three
    blocks per SM (the registers are capped for three), and a state over a
    block's limit takes the global layout."""
    m_off, P, A, K, T, nk = 128, 3, 512, 783, 2, 7
    W = 2 * nk + 1
    regions = (2 * 8 * 128               # warp queues: 8 x 128 (key, d^2)
               + 8 * 64                  # the warps' near rings
               + 2 * 2 * 4 * P           # two buffers of old/new site rows
               + 2 * 2 * P * 3 * W * 2   # their eik tables (complex rows)
               + 4 * 2 * A               # x, y, z, activity, both boxes
               + A                       # molecule (one box's row)
               + 2 * m_off               # slot activity, both boxes
               + 2 * 3 * K               # S re/im and cfac per box
               + 4 * K + K               # two dS re/im rows; k indices
               + 4 * P * T               # eps, sig2, lam1, lam2
               + 3 * P + 4 * P           # body; charge, 2 flags, cutoff
               + 2 * 2 * m_off           # two rows of Philox scores
               + 2 * 16 + 32 + 16 + 8)   # proposals, partials, stats, box
    assert gibbs_op.gibbs_smem_bytes(m_off, P, A, K, T, nk) == 4 * regions
    # three blocks and their 1 KB of reserved shared memory fit an SM's
    # 228 KB
    assert 3 * (4 * regions + 1024) <= 228 * 1024
    assert gibbs_op.choose_layout(m_off, P, A, K, T, nk) == "shared"
    assert gibbs_op.choose_layout(1024, 3, 3072, 2874, 2, 11) == "global"
