"""The port's readers, writers and checkpoints (io/configs.py, io/pdb.py,
io/checkpoint.py, models/water.py spce_from_nist) and the pressure helpers
(models/energy.py pressure, ops/tail.py impulsive_pressure), on the CPU,
against the JAX package, on files the tests write themselves.

* read_nist, read_cnf, write_cnf, spce_from_nist and the PDB round trip
  agree with JAX to 1e-12.
* A JAX checkpoint (save_state, save_ensemble_state) loads into the port
  with every shared field equal and no generator state; the port's own
  save, load and resume continue the exact trajectory, field for field.
* pressure and impulsive_pressure agree with JAX to 1e-12 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.io import checkpoint as ck_j
from metropolismontecarlo_tpu.io import configs as configs_j
from metropolismontecarlo_tpu.io import pdb as pdb_j
from metropolismontecarlo_tpu.mc import gcmc_mol as gcmc_j
from metropolismontecarlo_tpu.mc.driver import MonteCarlo as MonteCarloJ
from metropolismontecarlo_tpu.models import energy as energy_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops import tail as tail_j
from metropolismontecarlo_tpu_torch.io import checkpoint as ck_t
from metropolismontecarlo_tpu_torch.io import configs as configs_t
from metropolismontecarlo_tpu_torch.io import pdb as pdb_t
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC, MolGCMCState
from metropolismontecarlo_tpu_torch.mc.semigrand import SemigrandState
from metropolismontecarlo_tpu_torch.models import energy as energy_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams, SimState
from metropolismontecarlo_tpu_torch.ops import tail as tail_t

F64 = torch.float64
WATER = dict(temperature=300.0, r_cut=5.0, cutoff_mode="site",
             coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.3,
             dphi_max=0.4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nist_file(path, n_mol=8, box=12.0, seed=0):
    """A NIST-format SPC/E file: n_mol rigid waters at random poses, some
    split by the periodic boundary (atoms wrapped into the box)."""
    rng = np.random.default_rng(seed)
    body = water_t.water_body_frame(1.0, 109.47)
    lines = [f"{box} {box} {box}", f"{n_mol}"]
    i = 1
    for m in range(n_mol):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)]])
        com = rng.uniform(0.0, box, 3) if m else np.array([0.2, 0.1, 11.9])
        for sp, b in zip("OHH", body):
            r = (com + rot @ b) % box
            lines.append(f"{i} {r[0]:.10f} {r[1]:.10f} {r[2]:.10f} {sp}")
            i += 1
    path.write_text("\n".join(lines) + "\n")


def test_read_nist_and_spce_from_nist_match_jax(tmp_path):
    p = tmp_path / "nist.txt"
    _nist_file(p)
    c_t, s_t, b_t = configs_t.read_nist(p)
    c_j, s_j, b_j = configs_j.read_nist(p)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-12, atol=0)
    assert s_t == s_j and b_t == b_j
    sys_t, coords_t, com_t, box_t = water_t.spce_from_nist(p)
    sys_j, coords_j, com_j, box_j = water_j.spce_from_nist(p)
    np.testing.assert_allclose(com_t, com_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(coords_t, coords_j)
    assert box_t == box_j and sys_t.n_mol == sys_j.n_mol == 8
    np.testing.assert_allclose(sys_t.body, np.asarray(sys_j.body),
                               atol=1e-12)


def test_cnf_write_read_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    com = rng.uniform(-5, 5, (16, 3))
    quat = rng.normal(size=(16, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    p_t, p_j = tmp_path / "t.cnf", tmp_path / "j.cnf"
    configs_t.write_cnf(p_t, com, quat, 9.42953251)
    configs_j.write_cnf(p_j, com, quat, 9.42953251)
    assert p_t.read_text() == p_j.read_text()
    for a, b in zip(configs_t.read_cnf(p_t), configs_j.read_cnf(p_t)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    com2, quat2, box2 = configs_t.read_cnf(p_t)
    np.testing.assert_allclose(com2, com, atol=1e-9)
    np.testing.assert_allclose(quat2, quat, atol=1e-9)
    assert box2 == pytest.approx(9.42953251, rel=1e-12)


def test_pdb_round_trip_matches_jax(tmp_path):
    coords = np.random.default_rng(0).uniform(0, 10, (6, 3))
    args = (["OW", "HW", "HW"] * 2, ["WAT"] * 6, np.repeat([1, 2], 3))
    p_t, p_j = tmp_path / "t.pdb", tmp_path / "j.pdb"
    pdb_t.write_pdb(p_t, coords, *args, box=10.0)
    pdb_j.write_pdb(p_j, coords, *args, box=10.0)
    assert p_t.read_text() == p_j.read_text()
    d_t, d_j = pdb_t.read_pdb(p_t), pdb_j.read_pdb(p_t)
    np.testing.assert_allclose(d_t["coords"], d_j["coords"], rtol=1e-12)
    np.testing.assert_allclose(d_t["coords"], coords, atol=2e-3)
    for k in ("atom_names", "res_names", "elements"):
        assert d_t[k] == d_j[k]
    np.testing.assert_array_equal(d_t["res_ids"], d_j["res_ids"])
    np.testing.assert_allclose(d_t["box"], d_j["box"], rtol=1e-12)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    mc_j = MonteCarloJ(water_j.spce_system(8), RunParamsJ(**WATER),
                       dtype=jnp.float64, recompute_chunk=4)
    st_j = mc_j.init_state(jax.random.PRNGKey(0),
                           configs_j.cubic_lattice(8, 12.0), box=12.0,
                           n_chains=4)
    st_j = mc_j.run_steps(st_j, 2, False)
    path = tmp_path / "ck.npz"
    ck_j.save_state(path, st_j, metadata={"block": 3})
    st_t, meta, gen = ck_t.load_state(path, "cpu")
    assert gen is None and int(meta["block"]) == 3
    for f in dataclasses.fields(SimState):
        np.testing.assert_array_equal(getattr(st_t, f.name).numpy(),
                                      np.asarray(getattr(st_j, f.name)),
                                      err_msg=f.name)
    # and the JAX package reads the port's own checkpoint's shared fields
    ck_t.save_state(tmp_path / "t.npz", st_t, {"block": 4},
                    generator=torch.Generator().manual_seed(3))
    with np.load(tmp_path / "t.npz") as data:
        assert int(data["meta_block"]) == 4
        assert ck_t.GENERATOR_KEY in data.files
        for f in dataclasses.fields(SimState):
            np.testing.assert_array_equal(data[f.name],
                                          np.asarray(getattr(st_j, f.name)))


def test_checkpoint_resume_exact_trajectory(tmp_path):
    """10 + 10 sweeps against save at 10, load into a fresh driver and
    generator, 10 sweeps: every field equal."""
    def driver(seed):
        gen = torch.Generator().manual_seed(seed)
        return MonteCarlo(water_t.spce_system(8), RunParams(**WATER),
                          device="cpu", generator=gen, dtype=F64,
                          recompute_chunk=4), gen

    mc, gen = driver(0)
    st = mc.init_state(configs_t.cubic_lattice(8, 12.0), box=12.0,
                       n_chains=4)
    mid = mc.run_steps(st, 10, False)
    path = tmp_path / "ck.npz"
    ck_t.save_state(path, mid, metadata={"block": 1}, generator=gen)
    ref = mc.run_steps(mid, 10, False)

    mc2, gen2 = driver(99)
    loaded, meta, gen_state = ck_t.load_state(path, "cpu")
    gen2.set_state(gen_state)
    assert int(meta["block"]) == 1
    out = mc2.run_steps(loaded, 10, False)
    for f in dataclasses.fields(SimState):
        np.testing.assert_array_equal(getattr(out, f.name).numpy(),
                                      getattr(ref, f.name).numpy(),
                                      err_msg=f.name)


def test_ensemble_checkpoints(tmp_path):
    """A JAX MolGCMCState loads into the port's class; the port's own
    ensemble checkpoint resumes the exact trajectory; a checkpoint of
    another state class raises."""
    kw = dict(WATER, temperature=700.0, r_cut=4.5, use_lrc=False,
              strict_min_image=False)
    g_j = gcmc_j.MolGCMC(water_j.spce_system(8), RunParamsJ(**kw),
                         activity=2e-4, dtype=jnp.float64)
    st_j = g_j.init(jax.random.PRNGKey(0), box=10.0, n_init=5, n_chains=4)
    path = tmp_path / "j.npz"
    ck_j.save_ensemble_state(path, st_j, {"block": 2})
    st_t, meta, gen_state = ck_t.load_ensemble_state(path, MolGCMCState,
                                                     "cpu")
    assert gen_state is None and int(meta["block"]) == 2
    for f in dataclasses.fields(MolGCMCState):
        np.testing.assert_array_equal(getattr(st_t, f.name).numpy(),
                                      np.asarray(getattr(st_j, f.name)),
                                      err_msg=f.name)
    with pytest.raises(ValueError, match="MolGCMCState"):
        ck_t.load_ensemble_state(path, SemigrandState, "cpu")

    def app(seed):
        gen = torch.Generator().manual_seed(seed)
        return MolGCMC(water_t.spce_system(8), RunParams(**kw),
                       activity=2e-4, device="cpu", generator=gen), gen

    g, gen = app(0)
    mid = g.run_steps(st_t, 30)
    path = tmp_path / "t.npz"
    ck_t.save_ensemble_state(path, mid, {"block": 1}, generator=gen)
    ref = g.run_steps(mid, 30)
    g2, gen2 = app(7)
    loaded, _, gen_state = ck_t.load_ensemble_state(path, MolGCMCState,
                                                    "cpu")
    gen2.set_state(gen_state)
    out = g2.run_steps(loaded, 30)
    for f in dataclasses.fields(MolGCMCState):
        np.testing.assert_array_equal(getattr(out, f.name).numpy(),
                                      getattr(ref, f.name).numpy(),
                                      err_msg=f.name)


@pytest.mark.parametrize("n_types", [1, 2])
def test_pressure_helpers_match_jax(n_types):
    rng = np.random.default_rng(n_types)
    eps = rng.uniform(0.5, 2.0, (n_types, n_types))
    sig = rng.uniform(0.9, 1.2, (n_types, n_types))
    eps, sig = eps + eps.T, sig + sig.T
    counts = rng.integers(10, 200, n_types).astype(np.float64)
    r_cut, vol = 2.5, 1234.5
    p_t = tail_t.impulsive_pressure(counts, torch.tensor(eps),
                                    torch.tensor(sig), r_cut, vol)
    p_j = tail_j.impulsive_pressure(counts, jnp.asarray(eps),
                                    jnp.asarray(sig), r_cut, vol)
    assert float(p_t) < 0.0
    assert float(p_t) == pytest.approx(float(p_j), rel=1e-12)
    params = RunParams(temperature=1.7)
    pj = energy_j.pressure(RunParamsJ(temperature=1.7), 300, vol, -812.25)
    pt = energy_t.pressure(params, 300, vol, -812.25)
    assert pt == pytest.approx(float(pj), rel=1e-12)
