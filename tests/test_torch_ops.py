"""PyTorch port against the JAX package: geometry, builders, bridge, and
the port's import boundary (no JAX).  Inputs are made with numpy from a
seed and handed to both packages; everything compares in float64 to
1e-12."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.io import configs as configs_j
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models import polyatomic as poly_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.ops import pbc as pbc_j
from metropolismontecarlo_tpu.ops import quaternions as quat_j
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.io import configs as configs_t
from metropolismontecarlo_tpu_torch.models import monatomic as mono_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.ops import pbc as pbc_t
from metropolismontecarlo_tpu_torch.ops import quaternions as quat_t

TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=tol,
                               atol=tol)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_pbc_matches_jax():
    rng = np.random.default_rng(0)
    dr = rng.uniform(-30.0, 30.0, size=(64, 3))
    r = rng.uniform(-20.0, 40.0, size=(64, 3))
    box = 9.7
    t = torch.tensor
    _close(pbc_t.min_image(t(dr), box), pbc_j.min_image(jnp.asarray(dr), box))
    _close(pbc_t.wrap(t(r), box), pbc_j.wrap(jnp.asarray(r), box))
    _close(pbc_t.min_image_dist2(t(r[:32]), t(r[32:]), box),
           pbc_j.min_image_dist2(jnp.asarray(r[:32]), jnp.asarray(r[32:]),
                                 box))
    _close(pbc_t.pair_min_image(t(r[:5]), t(r[5:]), box),
           pbc_j.pair_min_image(jnp.asarray(r[:5]), jnp.asarray(r[5:]), box))


def test_quaternions_match_jax():
    rng = np.random.default_rng(1)
    q, p = _unit_quats(rng, 16), _unit_quats(rng, 16)
    v = rng.normal(size=(16, 3, 3))
    _close(quat_t.quat_to_rot(torch.tensor(q)),
           quat_j.quat_to_rot(jnp.asarray(q)))
    _close(quat_t.rotate_vectors(torch.tensor(q), torch.tensor(v)),
           quat_j.rotate_vectors(jnp.asarray(q), jnp.asarray(v)))
    _close(quat_t.quat_mul(torch.tensor(q), torch.tensor(p)),
           quat_j.quat_mul(jnp.asarray(q), jnp.asarray(p)))
    rot = np.asarray(quat_j.quat_to_rot(jnp.asarray(q)))
    for r in rot:
        _close(quat_t.rot_to_quat(r), quat_j.rot_to_quat(r))


def test_random_quaternion_is_unit_and_seeded():
    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return quat_t.random_quaternion(g, (4, 50), dtype=torch.float64)

    q = draw(3)
    assert q.shape == (4, 50, 4)
    _close(torch.linalg.vector_norm(q, dim=-1), np.ones((4, 50)))
    assert torch.equal(q, draw(3)) and not torch.equal(q, draw(4))


def test_kabsch_fit_matches_jax_and_recovers_rotation():
    rng = np.random.default_rng(2)
    body = np.asarray(water_j.spce_system(12).body)
    q_true = _unit_quats(rng, 12)
    rel = np.asarray(quat_j.rotate_vectors(jnp.asarray(q_true),
                                           jnp.asarray(body)))
    q_fit = quat_t.fit_quaternions(body, rel)
    _close(q_fit, quat_j.fit_quaternions(body, rel))
    back = quat_t.rotate_vectors(torch.tensor(q_fit), torch.tensor(body))
    _close(back, rel, tol=1e-10)


@pytest.mark.parametrize("n,box,jitter", [(27, 5.0, 0.0), (750, 28.24, 0.0),
                                          (64, 12.4, 0.3)])
def test_cubic_lattice_matches_jax(n, box, jitter):
    _close(configs_t.cubic_lattice(n, box, jitter),
           configs_j.cubic_lattice(n, box, jitter))


@pytest.mark.parametrize("build", ["spce", "tip3p", "lj", "triatomic"])
def test_builders_match_jax(build):
    pairs = {
        "spce": (water_t.spce_system(9), water_j.spce_system(9)),
        "tip3p": (water_t.tip3p_system(9), water_j.tip3p_system(9)),
        "lj": (mono_t.lj_system(27), mono_j.lj_system(27)),
        "triatomic": (poly_t.triatomic_system(27),
                      poly_j.triatomic_system(27)),
    }
    port, ref = pairs[build]
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            _close(a, b)
        else:
            assert a == b, f.name
    for prop in ("n_atoms", "n_atoms_padded", "species_uniform",
                 "is_uniform", "species_slices"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for prop in ("mol_of_atom_padded", "type_counts", "tid_row_padded",
                 "mol_p", "mol_a0"):
        np.testing.assert_array_equal(getattr(port, prop),
                                      getattr(ref, prop))
    np.testing.assert_array_equal(port.flat(np.asarray(port.charges)),
                                  ref.flat(np.asarray(ref.charges)))


def test_mossa_params_match_jax():
    port, ref = poly_t.mossa_params(dr_max=0.2), poly_j.mossa_params(
        dr_max=0.2)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_bridge_round_trip():
    ref = water_j.spce_system(5)
    sys_t = bridge.system_from_numpy(
        {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})
    np.testing.assert_array_equal(sys_t.body, ref.body)
    assert sys_t.n_atoms_padded == ref.n_atoms_padded
    rng = np.random.default_rng(4)
    arrays = {
        "com": rng.normal(size=(2, 5, 3)).astype(np.float32),
        "quat": rng.normal(size=(2, 5, 4)).astype(np.float32),
        "coords": rng.normal(size=(2, 3, 128)).astype(np.float32),
        "box": np.full(2, 9.0, np.float32),
        "sfac": rng.normal(size=(2, 7, 2)).astype(np.float32),
        "energy": rng.normal(size=2).astype(np.float32),
        "virial": rng.normal(size=2).astype(np.float32),
        "key": np.zeros((2, 2), np.uint32),
        "temp": np.full(2, 300.0, np.float32),
        "step": np.asarray(40, np.int32),
        "dr_max": np.full(2, 0.3, np.float32),
        "dphi_max": np.full(2, 0.2, np.float32),
        "dv_max": np.full(2, 0.05, np.float32),
        "acc": np.arange(6, dtype=np.int32).reshape(2, 3),
        "att": np.arange(6, dtype=np.int32).reshape(2, 3) + 6,
        "nbr": np.zeros((2, 1, 1), np.int32),
        "nbr_needed": np.zeros(2, np.int32),
    }
    back = bridge.state_to_numpy(bridge.state_from_numpy(arrays, "cpu"))
    assert set(back) == set(arrays) - {"key"}
    for k, v in back.items():
        assert v.dtype == arrays[k].dtype and v.shape == arrays[k].shape, k
        np.testing.assert_array_equal(v, arrays[k])


def test_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package
    made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['metropolismontecarlo_tpu'] = None\n"
        "import metropolismontecarlo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) > 20, names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
