"""The port's semigrand flip op (ops/cuda/flip_kernel.py) on the CPU,
against the JAX package's Pallas kernel in the TPU interpreter.

* flip_plain against JAX flip_pallas(interpret=True) through the two
  make_mega_flip_fn wrappers: the interpreter's PRNG returns zeros, so the
  port is fed zero uniforms and all-equal pick scores (every attempt picks
  the lowest active slot, orients the new identity with the quaternion
  (0, 1, 0, 0) and has ln u = -69): equal decisions, coordinates, COMs,
  quaternions and activity, energies within 1e-5 of the attempts' term
  magnitudes, S(k) within 1e-5 of its norm (floored at 1 e).  Identical
  SPC/E blocks under Ewald, Wolf and reference Wolf; the ragged one-site LJ
  + bent-triatomic blocks with unequal eps and the LJ tail.
* One forced flip of the f32 twin against the float64 plain semigrand
  step of the port, in each direction.
* The refusals: an empty chain and a chain without a free target change
  nothing; the Philox pick; the wrapper's device and input checks; the
  shared-memory count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc.moves import make_mega_flip_fn as flips_j
from metropolismontecarlo_tpu.mc.semigrand import Semigrand as SemigrandJ
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc.gcmc_binary import make_binary_slots
from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand
from metropolismontecarlo_tpu_torch.models.polyatomic import lj_trimer_blocks
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    spce_system,
    spce_two_blocks,
)
from metropolismontecarlo_tpu_torch.ops.cuda import flip_kernel as flip_op
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from tests.test_semigrand import two_block_lj, water_two_blocks

F32, F64 = torch.float32, torch.float64
C, NF = 3, 10
WATER = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
             coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.3,
             dphi_max=0.3, use_lrc=False, strict_min_image=False)
LJ = dict(strict_min_image=False, temperature=2.0, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.5, dr_max=0.3,
          dphi_max=0.5, use_lrc=True)
# (JAX system, port system, params, box, (n_a, n_b), xi)
CASES = {
    "spce-ewald": (lambda: water_two_blocks(8, 8),
                   lambda: spce_two_blocks(8, 8), WATER, 10.0, (5, 3), 2.0),
    "spce-wolf": (lambda: water_two_blocks(8, 8),
                  lambda: spce_two_blocks(8, 8),
                  dict(WATER, coulomb="wolf", kappa_L=2.0), 10.0, (5, 3),
                  2.0),
    "spce-wolf_ref": (lambda: water_two_blocks(8, 8),
                      lambda: spce_two_blocks(8, 8),
                      dict(WATER, coulomb="wolf", wolf_style="ref",
                           kappa_L=2.0), 10.0, (5, 3), 2.0),
    "lj-trimer-lrc": (lambda: two_block_lj(8, 8, eps_a=1.0, eps_b=0.6),
                      lambda: lj_trimer_blocks(8, 8, eps_a=1.0, eps_b=0.6),
                      LJ, 5.0, (4, 3), 1.5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(kw):
    return make_kvectors(kw["nk"], kw["ksq_max"]) \
        if kw["coulomb"] == "ewald" else (None, None)


def _consts(seed, lrc):
    rng = np.random.default_rng(seed)
    si2 = rng.uniform(-60.0, -40.0, (C, 2)).astype(np.float32)
    lrc3 = rng.uniform(-0.05, 0.05, (C, 3)).astype(np.float32) \
        if lrc else None
    return si2, lrc3


@pytest.fixture(scope="module")
def jax_flips():
    """JAX's interpreted flip launch of every case, once per module:
    (state, outputs, si2, lrc3)."""
    out = {}
    for i, (name, (sys_j, _, kw, box, (n_a, n_b), xi)) in enumerate(
            CASES.items()):
        params = RunParamsJ(**kw)
        g = SemigrandJ(sys_j(), params, fugacity_ratio=xi,
                       dtype=jnp.float32)
        st = g.init(jax.random.PRNGKey(i), box=box, n_a=n_a, n_b=n_b,
                    n_chains=C)
        fn = flips_j(sys_j(), params, *_kv(kw), xi, interpret=True,
                     n_flip=NF)
        si2, lrc3 = _consts(i, kw["use_lrc"])
        res = fn(st.com, st.quat, st.coords, st.active, st.box, st.sfac,
                 jnp.zeros((C,), jnp.int32), jnp.zeros((), jnp.int32),
                 jnp.asarray(si2),
                 lrc3=None if lrc3 is None else jnp.asarray(lrc3))
        out[name] = (st, [np.asarray(x) for x in res], si2, lrc3)
    return out


def _plain_with_zero_scores(mags):
    """flip as the JAX interpreter runs it: the plain twin with all-equal
    pick scores (the lowest active slot), recording the magnitudes."""
    def op(*a, **k):
        k.pop("seed", None)
        n_c, m = a[1].shape[:2]
        out = flip_op.flip_plain(
            *a, magnitude=True,
            scores=torch.zeros((n_c, a[8].shape[1], m)), **k)
        mags.append(out[4][:, flip_op.N_STATS])
        return out[:4] + (out[4][:, :flip_op.N_STATS],) + out[5:]

    return op


def _zero_draws(monkeypatch, mags):
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))
    monkeypatch.setattr(moves_t.flip_op, "flip",
                        _plain_with_zero_scores(mags))


def _t(x, dtype=F32):
    return torch.tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("name", list(CASES))
def test_flip_plain_matches_jax_interpreted_kernel(name, jax_flips,
                                                   monkeypatch):
    _, sys_t, kw, _, _, xi = CASES[name]
    st, want, si2, lrc3 = jax_flips[name]
    mags = []
    _zero_draws(monkeypatch, mags)
    fn = moves_t.make_mega_flip_fn(sys_t(), RunParams(**kw), *_kv(kw), "cpu",
                                   xi, n_flip=NF)
    got = fn(_t(st.com), _t(st.quat), _t(st.coords),
             torch.tensor(np.array(st.active)), _t(st.box), _t(st.sfac),
             torch.Generator(), torch.tensor(si2),
             None if lrc3 is None else torch.tensor(lrc3))
    assert len(mags) == 1
    names = ("com", "quat", "coords", "active", "sfac", "d_e", "acc", "att")
    got = dict(zip(names, (x.numpy() for x in got)))
    want = dict(zip(names, want))
    for k in ("active", "acc", "att"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("com", "quat", "coords"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    norm = max(1.0, float(np.linalg.norm(want["sfac"].reshape(C, -1),
                                         axis=1).max()))
    np.testing.assert_allclose(got["sfac"], want["sfac"], atol=1e-5 * norm)
    mag = mags[0].numpy()
    assert (np.abs(got["d_e"] - want["d_e"]) <= 1e-5 * mag).all(), \
        (got["d_e"] - want["d_e"], mag)
    # both directions were taken, and the total N kept
    assert want["acc"][:, 0].sum() > 0 and want["acc"][:, 1].sum() > 0
    assert (got["active"].sum(1) == np.asarray(st.active).sum(1)).all()


def _flip_inputs(system, kw, box, n_a, n_b, seed=0):
    """The f64 port Semigrand and its init state, with the flip op's f32
    arguments of that state."""
    gen = torch.Generator().manual_seed(seed)
    g = Semigrand(system, RunParams(**kw), fugacity_ratio=1.0, n_orient=1,
                  device="cpu", generator=gen)
    st = g.init(box=box, n_a=n_a, n_b=n_b, n_chains=C)
    act, actm = moves_t.activity_planes(system, st.active)
    args = [x.to(F32).contiguous() for x in (st.coords, st.com, st.quat,
                                             st.sfac, st.box)] + [
        kw["temperature"] * torch.ones(C), act, actm]
    tables = moves_t.make_mega_flip_fn(system, RunParams(**kw), *_kv(kw),
                                       "cpu", 1.0).tables
    return g, st, args, tables


@pytest.mark.parametrize("name,slot", [("spce-ewald", 2),
                                       ("lj-trimer-lrc", 9)])
def test_one_forced_flip_matches_the_f64_semigrand_step(name, slot):
    """A forced flip of `slot` (species A -> B for slot 2, B -> A for slot
    9) at a given orientation: the f32 twin's accepted energy change and
    new pose against the port's float64 plain step on the same pick,
    orientation and acceptance draws."""
    _, sys_t, kw, box, (n_a, n_b), _ = CASES[name]
    system = sys_t()
    g, st, args, tables = _flip_inputs(system, kw, box, n_a, n_b)
    run = g.run_steps
    rng = np.random.default_rng(5)
    ux = torch.zeros((C, 1, 8))
    ux[:, 0, 4:7] = torch.tensor(rng.uniform(0.0, 1.0, (C, 3)),
                                 dtype=F32)
    scores = torch.zeros((C, 1, system.n_mol))
    scores[:, 0, slot] = 1.0
    slots = make_binary_slots(system, RunParams(**kw), "cpu", F64,
                              neutral=False)
    si2 = torch.stack([ev.self_intra(st.box) for ev in slots.evs], 1)
    lrc3 = None
    if kw["use_lrc"]:
        gm = slots.lrc_gmat(st.box)
        lrc3 = torch.stack([gm[:, 0, 0], gm[:, 0, 1], gm[:, 1, 1]], 1)
    out = flip_op.flip_plain(*args, ux, tables, si2.to(F32),
                             None if lrc3 is None else lrc3.to(F32),
                             scores=scores, magnitude=True)
    stats = out[4]
    is_a = slot < system.species_slices[0][2]
    assert stats[:, 1 if is_a else 2].tolist() == [1.0] * C

    # the float64 step on the same draws: a flip of the slot-th molecule
    on = st.active.to(torch.int64)
    rank = int(on[0, :slot + 1].sum())            # 1-based among actives
    n_tot = int(on[0].sum())
    q = torch.cat(sweep_op.shoemake(ux[:, 0].double()), 1)
    dr = run.draw(C)
    dr.u_move[:] = 0.99
    dr.u_sel[:] = (rank - 0.5) / n_tot
    dr.quats_new = q[:, None, :]
    dr.u_pick[:] = 0.5
    dr.u_acc[:] = 1e-300
    st2 = run.step(st, dr)
    assert st2.acc[:, 2 if is_a else 3].tolist() == [1] * C
    de = (st2.energy - st.energy).numpy()
    mag = stats[:, flip_op.N_STATS].double().numpy()
    assert (np.abs(stats[:, 0].double().numpy() - de) <= 2e-5 * mag).all(), \
        (stats[:, 0], de, mag)
    np.testing.assert_array_equal(out[6].numpy() > 0.5, st2.active.numpy())
    on2 = st2.active.numpy()
    np.testing.assert_allclose(out[1].double().numpy()[on2],
                               st2.com.numpy()[on2], atol=1e-5)
    np.testing.assert_allclose(out[0].double().numpy(), st2.coords.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out[3].double().numpy(), st2.sfac.numpy(),
                               atol=1e-5)


def test_empty_chain_and_no_free_target_change_nothing():
    """Chain 0 holds no molecule (each attempt counts as an A -> B attempt,
    as the TPU kernel's degenerate pick of slot 0 does, and is refused),
    chain 1 fills both blocks (no attempt has a free target), chain 2 is
    ordinary; zero uniforms make every admissible flip acceptable."""
    system = spce_two_blocks(8, 8)
    kw = WATER
    _, _, args, tables = _flip_inputs(system, kw, 10.0, 4, 4)
    active = torch.zeros((C, 16), dtype=torch.bool)
    active[1] = True
    active[2, [0, 1, 8]] = True
    args[6], args[7] = moves_t.activity_planes(system, active)
    ux = torch.zeros((C, 6, 8))
    si2 = torch.zeros((C, 2))
    out = flip_op.flip_plain(*args, ux, tables, si2)
    stats = out[4]
    assert stats[0].tolist() == [0.0, 0.0, 0.0, 6.0, 0.0, 0.0, 0.0, 0.0]
    assert float(stats[1, 1:3].sum()) == 0.0
    assert float(stats[1, 3:5].sum()) == 6.0
    assert float(stats[2, 1:3].sum()) > 0
    for c in (0, 1):
        for x, ref in zip(out[:4] + out[5:], args[:4] + args[6:]):
            assert torch.equal(x[c], ref[c])
    assert torch.equal(out[6].sum(1), args[7].sum(1))


def test_philox_pick_matches_philox_scores():
    """Without scores= the twin picks by the kernel's Philox words: the
    same results as passing philox_scores explicitly, and each attempt's
    accepted slot is the active slot with the largest score."""
    system = spce_two_blocks(8, 8)
    _, _, args, tables = _flip_inputs(system, WATER, 10.0, 5, 3)
    ux = torch.rand((C, 5, 8), generator=torch.Generator().manual_seed(1))
    ux[:, :, 7] = 0.0
    si2 = torch.zeros((C, 2))
    a = flip_op.flip_plain(*args, ux, tables, si2, seed=1234)
    sc = torch.stack([sweep_op.philox_scores(1234, C, i, 0, 16, "cpu")
                      for i in range(5)], 1).to(F32)
    b = flip_op.flip_plain(*args, ux, tables, si2, scores=sc)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the first attempt's pick: the largest score among the active slots
    on = args[7] > 0.5
    first = torch.where(on, sweep_op.philox_scores(1234, C, 0, 0, 16, "cpu"),
                        -1).argmax(1)
    one = flip_op.flip_plain(*args, ux[:, :1], tables, si2, seed=1234)
    assert (one[4][:, 1:3].sum(1) == 1).all()
    assert torch.equal(one[4][:, 5], (first + 1).to(F32))


def test_flip_routes_the_cpu_to_the_plain_version_and_checks_inputs():
    system = spce_two_blocks(8, 8)
    _, _, args, tables = _flip_inputs(system, WATER, 10.0, 5, 3)
    ux = torch.rand((C, 4, 8), generator=torch.Generator().manual_seed(2))
    si2 = torch.zeros((C, 2))
    flip_op.flip.launches = 0
    got = flip_op.flip(*args, ux, tables, si2, seed=5)
    want = flip_op.flip_plain(*args, ux, tables, si2, seed=5)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert flip_op.flip.launches == 0          # the CPU launches nothing
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(ValueError, match="dtype"):
        flip_op.flip(*bad, ux, tables, si2)
    with pytest.raises(ValueError, match="shape"):
        flip_op.flip(*args, ux, tables, torch.zeros((C, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        flip_op.flip(*args, ux, tables, torch.zeros((2, C)).T)
    meta = [x.to("meta") for x in args]
    t_meta = flip_op.FlipTables(
        a=_tables_to(tables.a, "meta"), b=_tables_to(tables.b, "meta"),
        ln_xi=0.0)
    with pytest.raises(ValueError, match="no flip for device"):
        flip_op.flip(*meta, ux.to("meta"), t_meta, si2.to("meta"))
    # the op runs unshifted LJ only
    with pytest.raises(ValueError, match="lj_shift"):
        moves_t.make_mega_flip_fn(system, RunParams(**dict(
            WATER, lj_shift="linear")), *_kv(WATER), "cpu", 1.0)
    with pytest.raises(ValueError, match="two internally uniform"):
        moves_t.make_mega_flip_fn(spce_system(16), RunParams(**WATER),
                                  *_kv(WATER), "cpu", 1.0)


def _tables_to(t, device):
    import dataclasses

    return dataclasses.replace(t, **{k: v.to(device)
                                     for k, v in t.tensors().items()})


def test_flip_smem_bytes_counts_every_region():
    """The warp queues (2048 words), the old and new poses' site rows and
    eik tables at max(P0, P1), two proposal buffers of both species'
    rotated templates and 8 scalars, 6 atom rows (x, y, z, the active-atom
    list, each column's place in it, molecule), the slot activity, 6 k
    rows, both species' (P, T) eps and sigma^2 tables, both species' 7
    P-wide site rows, two rows of Philox scores, 33 words of scratch."""
    M, P0, P1, A, K, T, nk = 128, 1, 3, 384, 337, 2, 5
    W = 2 * nk + 1
    words = (2 * 8 * 128 + 2 * 4 * 3 + 2 * 3 * 3 * W * 2
             + 2 * (3 * (P0 + P1) + 8) + 6 * A + M + 6 * K
             + 2 * P0 * T + 2 * P1 * T + 7 * P0 + 7 * P1 + 2 * M + 33)
    assert flip_op.flip_smem_bytes(M, P0, P1, A, K, T, nk) == 4 * words
    # bench.py's "semigrand" state fits with room for several blocks per
    # SM; 32x its slots take the global layout
    assert flip_op.flip_smem_bytes(128, 3, 3, 512, 337, 2, 5) < 40000
    assert flip_op.choose_layout(128, 3, 3, 512, 337, 2, 5) == "shared"
    assert flip_op.choose_layout(4096, 3, 3, 12288, 337, 2, 5) == "global"
