"""The port's sorted-slab windows (mc/moves.py slab_config,
slab_window_starts, make_slab_resort_fn, the slab branch of
make_mega_sweep_fn and of sweep_plain; the driver's hooks), on the CPU:

* slab_config and slab_window_starts equal to the JAX package's on the
  cases of its tests/test_slabs.py test_slab_config_gates, on a two-block
  mixture and on the 6859-water cell with its lattice z-hint;
* the resort (permutation, COM/quaternion/atom columns, the coverage
  counter) equal to JAX make_slab_resort_fn on LJ-512 and a mixture;
* sweep_plain with slabs against sweep_plain dense on the resorted state
  and the same uniforms: the same decisions, energies within 2e-5 of the
  sweep's term magnitudes; the ghost halo equal to its head columns
  after the sweep and the lane pads zero after the whole-sweep route;
* one whole-sweep-route sweep of LJ-640 with forced slabs (W 512 < 640)
  against the JAX package's interpret-mode mega sweep on the same start
  (the interpreter's PRNG is all zeros, so the port's uniforms are
  patched to zeros): equal decisions, COMs and energies;
* the driver: retune_slabs keeps the drift and resets the counter,
  adjust caps dr_max at slab_skin, an undersized window raises at the
  block end (JAX tests/test_slabs.py:130-140, 163-183).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import moves as moves_j
from metropolismontecarlo_tpu.mc.driver import MonteCarlo as MonteCarloJ
from metropolismontecarlo_tpu.models import linear as linear_j
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import SimState as SimStateJ
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.linear import co2_n2_system
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_system
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op

LJ = dict(temperature=1.5, r_cut=3.0, cutoff_mode="site", coulomb="none",
          p_translate=1.0, use_lrc=False)
MIX = dict(temperature=240.0, r_cut=7.0, coulomb="ewald", nk=3, ksq_max=10,
           p_translate=0.5, dr_max=0.3, dphi_max=0.3, slab_mode="force",
           slab_skin=0.5)
WATER = dict(temperature=298.15, r_cut=4.5, coulomb="ewald", nk=3,
             ksq_max=10, p_translate=0.5, dr_max=0.3, dphi_max=0.3,
             slab_mode="force", slab_skin=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread per test process leaves the cores to the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stratified_com(n, box, side=26):
    """xy grid + scrambled stratified z (JAX tests/test_slabs.py): exactly
    uniform z-occupancy and no close pairs."""
    i = np.arange(n)
    return np.stack([(i % side + 0.5) * box / side,
                     (i // side + 0.5) * box / side,
                     ((i * 997) % n + 0.5) * box / n], axis=1)


def _sheared_lattice(n, box):
    """A simple cubic lattice whose (x, y) columns are shifted in z by
    up to one spacing: no close pairs, and no z-planes to clump the
    windows."""
    com = np.asarray(cubic_lattice(n, box), np.float64)
    side = int(np.ceil(n ** (1 / 3)))
    a = box / side
    ix, iy = np.floor(com[:, 0] / a), np.floor(com[:, 1] / a)
    com[:, 2] = (com[:, 2] + (ix + side * iy) / side ** 2 * a) % box
    return com


MIX_BOX = 37.0 * (320 / 750) ** (1 / 3)
MIX_BOX_512 = 37.0 * (512 / 750) ** (1 / 3)
WATER_BOX = 24.83
# name: (port system, JAX system, RunParams kwargs, box hint, z hint)
GATES = {
    "no box": (lj_system(512), mono_j.lj_system(512),
               dict(LJ, dr_max=0.4), None, None),
    "npt": (lj_system(512), mono_j.lj_system(512),
            dict(LJ, dr_max=0.4, pressure=1.0, p_volume=0.1), 25.0, None),
    "off": (lj_system(512), mono_j.lj_system(512),
            dict(LJ, dr_max=0.4, slab_mode="off"), 25.0, None),
    "tiny box": (lj_system(512), mono_j.lj_system(512),
                 dict(LJ, dr_max=0.4), 7.0, None),
    "force": (lj_system(512), mono_j.lj_system(512),
              dict(LJ, dr_max=0.4, slab_mode="force"), 25.0, None),
    "force lattice": (lj_system(512), mono_j.lj_system(512),
                      dict(LJ, dr_max=0.4, slab_mode="force"), 25.0,
                      np.asarray(cubic_lattice(512, 25.0))[:, 2]),
    "mixture": (co2_n2_system(32, 288), linear_j.co2_n2_system(32, 288),
                MIX, MIX_BOX, None),
    "water 6859 auto": (
        spce_system(6859), water_j.spce_system(6859),
        dict(temperature=298.15, r_cut=10.0, coulomb="ewald",
             kappa_L=11.711, nk=11, ksq_max=118, dr_max=0.3),
        59.056, np.asarray(cubic_lattice(6859, 59.056))[:, 2]),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_slab_config_and_window_starts_match_jax(case):
    sys_t, sys_j, kw, box, z = GATES[case]
    cfg_t = moves_t.slab_config(sys_t, RunParams(**kw), box, z)
    cfg_j = moves_j.slab_config(sys_j, RunParamsJ(**kw), box, z)
    assert cfg_t == cfg_j
    if cfg_t is not None:
        assert cfg_t["W"] % 128 == 0 and cfg_t["W"] <= cfg_t["A_blk"]
        np.testing.assert_array_equal(
            moves_t.slab_window_starts(sys_t, cfg_t),
            moves_j.slab_window_starts(sys_j, cfg_j))
    if case == "water 6859 auto":
        # the cell the card runs: slabs on by default, a window of 12800
        # of the 20577 atom columns
        assert (cfg_t["W"], cfg_t["A_store"]) == (12800, 33408)


def test_slab_config_refuses_unsafe_steps_and_empty_windows():
    with pytest.raises(ValueError, match="slab_skin"):
        moves_t.slab_config(lj_system(512), RunParams(
            dr_max=5.0, slab_mode="force", **LJ), 25.0)
    # a sorted block under 128 atoms leaves no window (the JAX function
    # returns W = 0 here)
    kw = dict(MIX, slab_skin=0.3)
    small = co2_n2_system(96, 32)
    box = 37.0 * (128 / 750) ** (1 / 3)
    assert moves_j.slab_config(linear_j.co2_n2_system(96, 32),
                               RunParamsJ(**kw), box)["W"] == 0
    assert moves_t.slab_config(small, RunParams(**kw), box) is None


def _random_state(system, box, C, seed):
    """numpy SimState fields: uniform random COMs (some outside the box,
    to exercise the wrap), quaternions and coordinates (the resort only
    permutes columns)."""
    rng = np.random.default_rng(seed)
    M, A_pad = system.n_mol, system.n_atoms_padded
    quat = rng.normal(size=(C, M, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    coords = np.zeros((C, 3, A_pad))
    coords[:, :, :system.n_atoms] = rng.uniform(0, box,
                                                (C, 3, system.n_atoms))
    f = dict(com=rng.uniform(-0.2 * box, 1.2 * box, (C, M, 3)), quat=quat,
             coords=coords, box=np.full(C, box), sfac=np.zeros((C, 1, 2)),
             energy=np.zeros(C), virial=np.zeros(C), temp=np.ones(C),
             step=np.zeros((), np.int32), dr_max=np.full(C, 0.4),
             dphi_max=np.full(C, 0.1), dv_max=np.full(C, 0.05),
             acc=np.zeros((C, 3), np.int32), att=np.zeros((C, 3), np.int32),
             nbr=np.zeros((C, 1, 1), np.int32),
             nbr_needed=np.zeros(C, np.int32))
    return f


@pytest.mark.parametrize("case", ["force", "mixture"])
def test_resort_matches_jax(case):
    sys_t, sys_j, kw, box, z = GATES[case]
    cfg = moves_t.slab_config(sys_t, RunParams(**kw), box, z)
    f = _random_state(sys_t, box, C=3, seed=len(case))
    st_j = SimStateJ(key=jnp.zeros((3, 2), jnp.uint32),
                     **{k: jnp.asarray(v) for k, v in f.items()})
    out_j = moves_j.make_slab_resort_fn(sys_j, RunParamsJ(**kw), cfg)(st_j)
    st_t = bridge.state_from_numpy(f, "cpu")
    out_t = moves_t.make_slab_resort_fn(sys_t, RunParams(**kw), cfg)(st_t)
    for name in ("com", "quat", "coords", "nbr_needed"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)),
                                      err_msg=name)
    assert int(out_t.nbr_needed.max()) > 0


# name: (system, box, RunParams kwargs, start COMs)
SWEEPS = {
    "lj640": (lj_system(640), 32.0,
              dict(LJ, dr_max=0.4, slab_mode="force", slab_skin=1.0),
              _stratified_com(640, 32.0)),
    "spce512": (spce_system(512), WATER_BOX, WATER,
                _sheared_lattice(512, WATER_BOX)),
    "co2/n2 48+464": (co2_n2_system(48, 464), MIX_BOX_512, MIX,
                      _sheared_lattice(512, MIX_BOX_512)),
}


def _slab_and_dense(case, C=3):
    system, box, kw, com = SWEEPS[case]
    gen = torch.Generator().manual_seed(7)
    mc = MonteCarlo(system, RunParams(**kw), device="cpu", generator=gen)
    state = mc.init_state(com, box=box, n_chains=C)
    cfg = mc._slab_cfg
    assert cfg is not None and cfg["W"] < cfg["A_blk"], cfg
    return mc, state, cfg


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_slab_sweep_plain_matches_dense(case):
    """The window sees every pair the dense scan counts: on the resorted
    state, with the same uniforms, the slab and dense twins take the same
    decisions and agree on energy, positions and S(k)."""
    mc, state, cfg = _slab_and_dense(case)
    system = mc.system
    state = moves_t.make_slab_resort_fn(system, mc.params, cfg)(state)
    assert int(state.nbr_needed.max()) <= cfg["W"]
    C, M = state.com.shape[:2]
    A, W, a0 = system.n_atoms, cfg["W"], cfg["a0"]
    u = moves_t.draw_uniforms(C, M, torch.Generator().manual_seed(3), "cpu")
    f32 = [x.float().contiguous() for x in (
        state.coords, state.com, state.quat, state.sfac, state.box,
        state.temp, state.dr_max, state.dphi_max)]
    halo = moves_t.with_halo(f32[0], system, cfg)
    plain = functools.partial(sweep_op.sweep_plain, magnitude=True)
    dense_tables = moves_t.sweep_tables(system, mc.params, mc.kvecs,
                                        mc.kweights, "cpu")
    d = moves_t.sweep_blocks(plain, *f32, u, dense_tables)
    s = moves_t.sweep_blocks(plain, halo, *f32[1:], u, mc.tables)
    assert mc.tables[-1].W == W
    np.testing.assert_array_equal(s[4][:, 1:sweep_op.N_STATS].numpy(),
                                  d[4][:, 1:sweep_op.N_STATS].numpy())
    assert float(d[4][:, 1:3].sum()) > 0.2 * C * M      # moves accepted
    scale = d[4][:, sweep_op.N_STATS].clamp_min(1.0)
    e_rel = float(((s[4][:, 0] - d[4][:, 0]).abs() / scale).max())
    assert e_rel < 2e-5, e_rel
    np.testing.assert_allclose(s[0][:, :, :A].numpy(), d[0][:, :, :A].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(s[1].numpy(), d[1].numpy(), atol=1e-4)
    np.testing.assert_allclose(s[3].numpy(), d[3].numpy(), atol=1e-4)
    # the ghost twins kept up with their head molecules
    np.testing.assert_array_equal(s[0][:, :, A:A + W].numpy(),
                                  s[0][:, :, a0:a0 + W].numpy())


def test_slab_sweep_matches_jax_interpret(monkeypatch):
    system, box, kw, com = SWEEPS["lj640"]
    mc_j = MonteCarloJ(mono_j.lj_system(640), RunParamsJ(**kw),
                       dtype=jnp.float32, pallas="mega_interpret",
                       recompute_chunk=2)
    s_j = mc_j.init_state(jax.random.PRNGKey(11), com, box=box, n_chains=2)
    mc_t = MonteCarlo(system, RunParams(**kw), device="cpu")
    s_t = bridge.state_from_numpy(
        {f: np.asarray(getattr(s_j, f)) for f in s_j._fields}, "cpu")
    s_t = mc_t.retune_slabs(s_t)        # sized from the same start
    assert mc_t._slab_cfg == mc_j._slab_cfg and mc_t._slab_cfg["W"] == 512
    monkeypatch.setattr(
        moves_t, "draw_uniforms",
        lambda C, M, gen, dev: torch.zeros((C, M, 10), device=dev))
    s_j = mc_j._sweep_full(s_j)
    s_t = mc_t.sweep(s_t)
    np.testing.assert_array_equal(s_t.acc.numpy(), np.asarray(s_j.acc))
    np.testing.assert_array_equal(s_t.att.numpy(), np.asarray(s_j.att))
    np.testing.assert_array_equal(s_t.nbr_needed.numpy(),
                                  np.asarray(s_j.nbr_needed))
    np.testing.assert_allclose(s_t.com.numpy(), np.asarray(s_j.com),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_t.coords.numpy(), np.asarray(s_j.coords),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_t.energy.numpy(), np.asarray(s_j.energy),
                               rtol=2e-5)


def test_whole_sweep_route_keeps_pads_zero():
    box = WATER_BOX * (500 / 512) ** (1 / 3)
    mc = MonteCarlo(spce_system(500), RunParams(**WATER), device="cpu",
                    generator=torch.Generator().manual_seed(8))
    state = mc.init_state(_sheared_lattice(500, box), box=box, n_chains=2)
    cfg = mc._slab_cfg
    A, A_pad = mc.system.n_atoms, mc.system.n_atoms_padded
    assert A_pad > A and cfg["A_store"] > A_pad
    state2 = mc.sweep(state)
    assert state2.coords.shape == state.coords.shape
    assert float(state2.coords[:, :, A:].abs().max()) == 0.0
    assert int(state2.step) == mc.system.n_mol
    # the carried energy stays exact
    e, _, _ = mc.full_energy(state2)
    np.testing.assert_allclose(e.numpy(), state2.energy.numpy(), rtol=1e-5)


def test_retune_slabs_mid_run_keeps_drift():
    mc, state, _ = _slab_and_dense("lj640", C=2)
    state, m = mc.run_block(state, 1)
    state = mc.retune_slabs(state)
    assert mc._slab_cfg is not None
    assert int(state.nbr_needed.max()) == 0
    state, m = mc.run_block(state, 2)
    assert m["drift_max_rel"] < 5e-5, m
    assert 0 < int(state.nbr_needed.max()) <= mc._slab_cfg["W"]


def test_adjust_caps_dr_max_at_slab_skin():
    """With slabs on, step-size adaptation stops at slab_skin (the
    windows' staleness bound) instead of box / 2."""
    system, box, kw, com = SWEEPS["lj640"]
    kw = dict(kw, dr_max=0.9, temperature=50.0)
    mc = MonteCarlo(system, RunParams(**kw), device="cpu",
                    generator=torch.Generator().manual_seed(2))
    state = mc.init_state(com, box=box, n_chains=2)
    assert mc._slab_cfg is not None
    state = mc.run_steps(state, 3, adjust=True)
    assert float(state.dr_max.max()) == pytest.approx(kw["slab_skin"])


def test_window_overflow_raises(monkeypatch):
    """An undersized forced window (a lattice start clumps molecules into
    z-planes) fails the coverage check at the block end."""
    monkeypatch.setenv("MMC_SLAB_W", "256")
    mc = MonteCarlo(lj_system(512),
                    RunParams(dr_max=0.4, slab_mode="force", **LJ),
                    device="cpu", generator=torch.Generator().manual_seed(1))
    state = mc.init_state(cubic_lattice(512, 25.0), box=25.0, n_chains=2)
    assert mc._slab_cfg["W"] == 256
    with pytest.raises(RuntimeError, match="window overflow"):
        mc.run_block(state, 1)


def test_activity_sweeps_refuse_slabs():
    kw = dict(LJ, dr_max=0.4, slab_mode="force")
    with pytest.raises(ValueError, match="sorted-slab"):
        moves_t.make_mega_sweep_fn(lj_system(512), RunParams(**kw), None,
                                   None, "cpu", box_hint=25.0,
                                   with_activity=True)
    # the dense activity route is unchanged
    fn = moves_t.make_mega_sweep_fn(lj_system(512), RunParams(**kw), None,
                                    None, "cpu", with_activity=True)
    assert fn.tables[0].W == 0


def test_layout_choice():
    """Shared memory when the chain state fits, the global layout for
    larger states (activity planes too) and for slabs, the k rows in
    global memory as well when they overflow it, a byte count when a
    forced layout does not fit."""
    cl = sweep_op.choose_layout
    assert cl(750, 3, 2304, 337, 2) == "shared"
    assert cl(750, 3, 2304, 337, 2, layout="global") == "global"
    assert cl(750, 3, 2304, 337, 2, slab=True) == "global"
    assert cl(6859, 3, 20736, 2874, 2) == "global"
    assert cl(6859, 3, 20736, 2874, 2, use_act=True,
              layout="global") == "global"
    assert cl(6859, 3, 20736, 2874, 2, use_act=True) == "global"
    assert cl(100, 3, 512, 8000, 2) == "global_k"
    with pytest.raises(ValueError, match="B of shared"):
        cl(100, 3, 512, 8000, 2, layout="global")
    with pytest.raises(ValueError, match="global layout only"):
        cl(750, 3, 2304, 337, 2, slab=True, layout="shared")
    # the 6859-water cell's shared words: k-vector rows and scratch, two
    # blocks per SM
    assert 2 * sweep_op.smem_bytes(6859, 3, 33408, 2874, 2,
                                   layout="global") <= 228 * 1024


def test_slab_tables_rows():
    mc, _, cfg = _slab_and_dense("co2/n2 48+464")
    t = mc.tables[-1]
    A, W, a0 = cfg["A"], cfg["W"], cfg["a0"]
    assert t.tid_row.shape == (cfg["A_store"],)
    np.testing.assert_array_equal(t.tid_row[A:A + W], t.tid_row[a0:a0 + W])
    np.testing.assert_array_equal(t.q_row[A:A + W], t.q_row[a0:a0 + W])
    assert int(t.molid_row[A:].max()) == -1
    assert t.segs.tolist() == [[0, 144]] and mc.tables[0].W == W
    assert mc.tables[0].a0_w == a0
