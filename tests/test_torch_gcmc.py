"""The port's monatomic muVT app (mc/gcmc.py), on the CPU, against the
JAX package.

* make_slot_lj (site energies, the dense full energy, the n-th active
  slot, the tail coefficient) in float64: 1e-10 relative.
* mega="full" against JAX make_gcmc(mega="interpret_full") on zero
  uniforms, as tests/test_torch_gcmc_mol.py does for molecules: equal
  activity and counters, energies within 2e-5 of the summed term
  magnitudes.
* The ideal gas's N is Poisson(z V); every route keeps the drift gate;
  n_counts and reweight_activity as in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gcmc as gcmc_j
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.mc import gcmc as gcmc_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op

F64, F32 = torch.float64, torch.float32
LJ = dict(strict_min_image=False, temperature=1.5, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.5, dr_max=0.4,
          use_lrc=False)
STYLES = {"none": {}, "linear": dict(lj_shift="linear"),
          "lrc": dict(use_lrc=True)}


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


@pytest.mark.parametrize("style", list(STYLES))
def test_slot_lj_matches_jax_f64(style):
    kw = dict(LJ, **STYLES[style])
    cap, C, box = 12, 3, 4.2
    fns_t = gcmc_t.make_slot_lj(lj_system(1), RunParams(**kw), cap, F64,
                                "cpu")
    fns_j = gcmc_j.make_slot_lj(mono_j.lj_system(1), RunParamsJ(**kw), cap,
                                jnp.float64)
    rng = np.random.default_rng(4)
    com = rng.uniform(0.0, box, (C, cap, 3))
    active = rng.random((C, cap)) < 0.6
    pos = rng.uniform(0.0, box, (C, 3))
    excl = np.array([0, 5, -1])
    boxes = np.full(C, box)
    t = [torch.tensor(x) for x in (com, active, boxes, pos, excl)]
    site = fns_t[0](*t)
    full = fns_t[1](*t[:3])
    n_idx = torch.tensor([0, 2, 4])
    nth = fns_t[2](t[1], n_idx)
    for c in range(C):
        s_j = fns_j[0](jnp.asarray(com[c]), jnp.asarray(active[c]), box,
                       jnp.asarray(pos[c]), int(excl[c]))
        assert float(site[c]) == pytest.approx(float(s_j), rel=1e-10,
                                               abs=1e-12)
        f_j = fns_j[1](jnp.asarray(com[c]), jnp.asarray(active[c]), box)
        assert float(full[c]) == pytest.approx(float(f_j), rel=1e-10)
        assert int(nth[c]) == int(fns_j[2](jnp.asarray(active[c]),
                                           int(n_idx[c])))
    if style == "lrc":
        assert float(fns_t[3](torch.tensor(box, dtype=F64))) == \
            pytest.approx(float(fns_j[3](box)), rel=1e-12)
    else:
        assert fns_t[3] is None and fns_j[3] is None


def test_capacity_system_and_refusals():
    sys_t = gcmc_t.capacity_system(lj_system(1), 40)
    sys_j = gcmc_j.capacity_system(mono_j.lj_system(1), 40)
    assert sys_t.n_mol == sys_j.n_mol == 40 and sys_t.species is None
    for f in ("body", "masses", "charges", "type_ids"):
        np.testing.assert_array_equal(getattr(sys_t, f),
                                      np.asarray(getattr(sys_j, f)))
    assert sys_t.n_atoms_padded == sys_j.n_atoms_padded
    with pytest.raises(ValueError, match="monatomic"):
        gcmc_t.make_gcmc(spce_system(4), RunParams(**LJ), 0.05, 8,
                         device="cpu")


def _zero_draws(monkeypatch, mags):
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))

    def twin(*a, **k):
        out = sweep_op.sweep_plain(*a, magnitude=True, **k)
        mags.append(out[4][:, sweep_op.N_STATS])
        return out[:4] + (out[4][:, :sweep_op.N_STATS],) + out[5:]

    monkeypatch.setattr(moves_t.sweep_op, "sweep", twin)


def test_mega_full_matches_jax_interpret_full(monkeypatch):
    """On zero uniforms every in-kernel attempt inserts at the origin (the
    molecular test's degenerate stream); the tail rides the wc lane."""
    kw = dict(LJ, use_lrc=True)
    cap, box, C = 16, 4.0, 4
    init_j, run_j, _ = gcmc_j.make_gcmc(
        mono_j.lj_system(1), RunParamsJ(**kw), 0.05, cap, jnp.float32,
        mega="interpret_full")
    st_j = init_j(jax.random.PRNGKey(0), box, 8, C)
    st_j2 = run_j(st_j, 64)
    mags = []
    _zero_draws(monkeypatch, mags)
    g = gcmc_t.GCMC(lj_system(1), RunParams(**kw), 0.05, cap, F32,
                    mega="full", device="cpu", generator=_gen())
    st = bridge.mono_gcmc_state_from_numpy(
        {f: np.asarray(getattr(st_j, f)) for f in st_j._fields
         if f != "key"}, "cpu")
    e0 = st.energy.numpy().copy()
    st2 = g.run_steps(st, 64)
    assert len(mags) == 2                        # 2 cycles of 16 + 16
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)), f)
    assert int(st2.acc[:, 1].sum()) > 0
    mag = torch.stack(mags).sum(0).numpy()
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    assert (np.abs(d_t - d_j) <= 2e-5 * mag).all(), (d_t - d_j, mag)
    on = np.asarray(st_j2.active)
    np.testing.assert_allclose(st2.com.numpy()[on],
                               np.asarray(st_j2.com)[on], atol=1e-5)
    _, stats = g.run_block(st2, 0)
    assert stats["drift_max_rel"] < 2e-3


@pytest.mark.parametrize("mega,dtype,tol", [(None, F64, 1e-9),
                                            (True, F32, 2e-3),
                                            ("full", F32, 2e-3)])
def test_routes_keep_the_drift_gate(mega, dtype, tol):
    g = gcmc_t.GCMC(lj_system(1), RunParams(**dict(LJ, use_lrc=True)),
                    activity=0.05, capacity=24, dtype=dtype, mega=mega,
                    device="cpu", generator=_gen(3))
    st = g.init(box=4.5, n_init=10, n_chains=6)
    for _ in range(2):
        st, stats = g.run_block(st, 48, drift_tol=tol)
    assert set(stats) == {"n_mean", "n_var", "full_frac", "energy_mean",
                          "acc_trans", "acc_insert", "acc_delete",
                          "drift_max_rel"}
    assert 0.0 < stats["acc_trans"] < 1.0
    assert int((st.acc[:, 1] + st.acc[:, 2]).sum()) > 0
    assert st.com.dtype == dtype and st.acc.dtype == torch.int32


def test_ideal_gas_n_is_poisson_on_the_host_path():
    """eps = 0: N ~ Poisson(z V = 10).  64 chains x 6 samples 100 steps
    apart; the samples are correlated, so the gate is +-0.6 on the mean
    (the standard error were they independent: 0.16)."""
    z, box = 0.08, 5.0
    g = gcmc_t.GCMC(lj_system(1, eps=0.0), RunParams(**LJ), activity=z,
                    capacity=48, device="cpu", generator=_gen(6))
    st = g.init(box=box, n_init=10, n_chains=64)
    st, _ = g.run_block(st, 200)
    means, hist = [], np.zeros(49, np.int64)
    for _ in range(6):
        st, stats = g.run_block(st, 100, drift_tol=1e-10)
        means.append(stats["n_mean"])
        hist += gcmc_t.n_counts(st, 48)
    assert abs(np.mean(means) - z * box ** 3) < 0.6, means
    # reweighting the histogram to z' = 1.2 z moves the mean by ~ 1.2
    rw = gcmc_t.reweight_activity(hist, z, 1.2 * z)
    assert rw["n_mean"] == pytest.approx(1.2 * z * box ** 3, abs=1.0)


def test_n_counts_and_reweight_activity_match_jax():
    rng = np.random.default_rng(1)
    active = rng.random((7, 20)) < 0.4
    st = gcmc_t.GCMCState(com=torch.zeros(7, 20, 3),
                          active=torch.tensor(active), box=torch.ones(7),
                          energy=torch.zeros(7),
                          acc=torch.zeros(7, 3, dtype=torch.int32),
                          att=torch.zeros(7, 3, dtype=torch.int32))
    st_j = gcmc_j.GCMCState(jnp.zeros((7, 20, 3)), jnp.asarray(active),
                            jnp.ones(7), jnp.zeros(7), jnp.zeros((7, 2)),
                            jnp.zeros((7, 3)), jnp.zeros((7, 3)))
    hist = gcmc_t.n_counts(st, 20)
    np.testing.assert_array_equal(hist, gcmc_j.n_counts(st_j, 20))
    for z_new in (0.04, 0.07):
        a = gcmc_t.reweight_activity(hist, 0.05, z_new)
        b = gcmc_j.reweight_activity(hist, 0.05, z_new)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12), k
    with pytest.raises(ValueError, match="empty"):
        gcmc_t.reweight_activity(np.zeros(5), 0.05, 0.06)
    with pytest.raises(ValueError, match="positive"):
        gcmc_t.reweight_activity(hist, -1.0, 0.06)


def test_activity_ladder_and_init_refusals():
    z = np.array([0.02, 0.05, 0.08])
    g = gcmc_t.GCMC(lj_system(1), RunParams(**LJ), activity=z, capacity=16,
                    dtype=F32, mega="full", device="cpu", generator=_gen())
    st = g.init(box=4.0, n_init=4, n_chains=3)
    st, _ = g.run_block(st, 32, drift_tol=2e-3)
    with pytest.raises(ValueError, match="ladder"):
        g.init(box=4.0, n_init=4, n_chains=4)
    with pytest.raises(ValueError, match="capacity"):
        g.init(box=4.0, n_init=17, n_chains=3)
    with pytest.raises(ValueError, match="scalar"):
        g.init(box=4.0, n_init=np.array([1, 2, 3]), n_chains=3)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mega="full"), ValueError, "float32"),
    (dict(mega="interpret", dtype=F32), ValueError, "mega must be"),
    (dict(mega=True, dtype=F32, p_translate=1.0), ValueError, "p_translate"),
    (dict(mega="full", dtype=F32, p_translate=0.0), ValueError,
     "p_translate"),
    (dict(activity=np.ones((2, 2))), ValueError, "ladder"),
    (dict(device="cuda"), RuntimeError, "device='cpu'"),
])
def test_make_gcmc_refusals(kw, exc, match):
    kw = dict(dict(activity=0.05, device="cpu"), **kw)
    if kw["device"] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = RunParams(**dict(LJ, p_translate=kw.pop("p_translate", 0.5)))
    with pytest.raises(exc, match=match):
        gcmc_t.make_gcmc(lj_system(1), params, capacity=16, **kw)


def test_bridge_roundtrips_the_monatomic_state():
    g = gcmc_t.GCMC(lj_system(1), RunParams(**LJ), activity=0.05,
                    capacity=8, device="cpu", generator=_gen())
    st = g.init(box=4.0, n_init=3, n_chains=2)
    arrays = bridge.mono_gcmc_state_to_numpy(st)
    assert arrays["active"].dtype == np.bool_
    back = bridge.mono_gcmc_state_from_numpy(arrays, "cpu")
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(back, f.name), getattr(st, f.name)), f.name
    with pytest.raises(KeyError, match="active"):
        bridge.mono_gcmc_state_from_numpy(
            {k: v for k, v in arrays.items() if k != "active"}, "cpu")
