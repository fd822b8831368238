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


def _sfac_inputs(nk, ksq, box, shape, seed):
    rng = np.random.default_rng(seed)
    from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

    kv, _ = make_kvectors(nk, ksq)
    coords = rng.uniform(0.0, box, size=shape + (3,))
    q = rng.normal(size=shape[-1:])
    return kv, coords, q


def test_structure_factor_recurrence_matches_direct_and_jax():
    """The eik recurrence against the direct sum and against JAX's
    recurrence in float64: within 1e-13 (JAX's own gate shape, (3, 120)
    atoms, nk 6, ksq 36)."""
    from metropolismontecarlo_tpu.ops import ewald as ewald_j
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t

    kv, coords, q = _sfac_inputs(6, 36, 17.0, (3, 120), 0)
    assert len(kv) >= 16
    t = torch.tensor
    b = t(17.0, dtype=torch.float64)
    got = ewald_t.structure_factor_recurrence(t(coords), t(q), t(kv), b)
    direct = ewald_t.structure_factor_direct(t(coords), t(q), t(kv), b)
    assert torch.equal(got, ewald_t.structure_factor_recurrence(
        t(coords), t(q), t(kv), b, ewald_t.k_bounds(kv)))
    want = ewald_j.structure_factor(jnp.asarray(coords), jnp.asarray(q),
                                    jnp.asarray(kv), jnp.float64(17.0))
    assert got.shape == direct.shape == (3, len(kv), 2)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-13)
    # per-chain boxes and per-chain charges broadcast as the direct sum's
    boxes = t([15.0, 17.0, 19.5], dtype=torch.float64)
    qc = t(np.stack([q, -q, 2.0 * q]))
    np.testing.assert_allclose(
        ewald_t.structure_factor_recurrence(t(coords), qc, t(kv),
                                            boxes).numpy(),
        ewald_t.structure_factor_direct(t(coords), qc, t(kv), boxes).numpy(),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("nk,ksq,box,n_atoms", [(8, 65, 33.0, 400),
                                                (12, 145, 33.0, 512)])
def test_structure_factor_recurrence_float32_error(nk, ksq, box, n_atoms):
    """float32 at the Gibbs volume-move shapes (nk 8 and nk 12): the
    recurrence's ~3 nk complex products cost about the accuracy of the
    direct sum's f32 phases.  Both are held to the float64 direct sum;
    the recurrence's error stays under twice the direct sum's and under
    1e-5 of the largest |S(k)| (the carried-S(k) gate is 1e-4).  In
    float64 the recurrence stays within 1e-12 of the direct sum here."""
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t

    kv, coords, q = _sfac_inputs(nk, ksq, box, (2, n_atoms), 1)
    t = torch.tensor
    b = t(box, dtype=torch.float64)
    ref = ewald_t.structure_factor_direct(t(coords), t(q), t(kv), b)
    f32 = [fn(t(coords).float(), t(q).float(), t(kv), b.float())
           for fn in (ewald_t.structure_factor_recurrence,
                      ewald_t.structure_factor_direct)]
    err_rec, err_dir = ((x.double() - ref).abs().max().item() for x in f32)
    norm = ref.abs().max().item()
    f64 = ewald_t.structure_factor_recurrence(t(coords), t(q), t(kv), b)
    assert (f64 - ref).abs().max().item() < 1e-12
    assert err_rec < 2.0 * err_dir and err_rec < 1e-5 * norm, \
        (err_rec, err_dir, norm)


def test_structure_factor_fallback_paths(monkeypatch):
    """Pose rows (A < 32) and k lists shorter than RECURRENCE_MIN_K (JAX's
    K < 16 among them) take the direct sum (the spy sees them) and give
    its answer; a full-size call with a long list takes the recurrence and
    agrees with the direct sum within 1e-12 in float64."""
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t

    calls = []
    real_direct = ewald_t.structure_factor_direct

    def spy(coords, charges, kvecs, box):
        calls.append((coords.shape[-2], kvecs.shape[0]))
        return real_direct(coords, charges, kvecs, box)

    monkeypatch.setattr(ewald_t, "structure_factor_direct", spy)
    kv, coords, q = _sfac_inputs(10, 101, 17.0, (2, 40), 2)
    assert len(kv) >= ewald_t.RECURRENCE_MIN_K
    t = torch.tensor
    b = t(17.0, dtype=torch.float64)
    full = ewald_t.structure_factor(t(coords), t(q), t(kv), b,
                                    ewald_t.k_bounds(kv))
    assert calls == []
    np.testing.assert_allclose(
        full.numpy(), real_direct(t(coords), t(q), t(kv), b).numpy(),
        rtol=0, atol=1e-12)
    pose = ewald_t.structure_factor(t(coords[:, :4]), t(q[:4]), t(kv), b)
    assert calls == [(4, len(kv))]
    assert torch.equal(pose, real_direct(t(coords[:, :4]), t(q[:4]), t(kv),
                                         b))
    for k in (12, 337, ewald_t.RECURRENCE_MIN_K - 1):
        short = ewald_t.structure_factor(t(coords), t(q), t(kv[:k]), b)
        assert calls[-1] == (40, k)
        assert torch.equal(short, real_direct(t(coords), t(q), t(kv[:k]), b))
    # delta_structure_factor's pose rows go the same way
    ewald_t.delta_structure_factor(t(coords[0, :3]), t(coords[0, 3:6]),
                                   t(q[:3]), t(kv), b)
    assert calls[-2:] == [(3, len(kv))] * 2


def _mask_case(name, rng):
    """(port result, JAX result) of one of the pair-mask helpers on seeded
    float64 inputs: 6 three-site molecules in a 7 A box."""
    from metropolismontecarlo_tpu.ops import ewald as ewald_j
    from metropolismontecarlo_tpu.ops import pairs as pairs_j
    from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
    from metropolismontecarlo_tpu_torch.ops import pairs as pairs_t

    n_mol, P, box, r_cut = 6, 3, 7.0, 3.1
    coords = rng.uniform(0.0, box, size=(n_mol * P, 3))
    com = coords.reshape(n_mol, P, 3).mean(1)
    t, j = torch.tensor, jnp.asarray
    if name == "overlap_any":
        d2 = rng.uniform(0.0, 2.0, size=(5, P, n_mol * P))
        qq = rng.normal(size=(5, P, n_mol * P))
        mask = rng.uniform(size=(5, P, n_mol * P)) < 0.7
        d2[0] = 1.0                                 # a row without overlap
        return (ewald_t.overlap_any(t(d2), t(qq), t(mask)),
                ewald_j.overlap_any(j(d2), j(qq), j(mask)))
    if name.startswith("molecule_key_points"):
        mode = name.split(":")[1]
        mpa = coords.reshape(n_mol, P, 3)
        return (pairs_t.molecule_key_points(t(mpa), t(com), mode),
                pairs_j.molecule_key_points(j(mpa), j(com), mode))
    if name.startswith("moved_pair_mask:"):
        mode = name.split(":")[1]
        key = com[2] if mode == "com" else coords[2 * P]
        keys = com if mode == "com" else coords.reshape(n_mol, P, 3)[:, 0]
        return (pairs_t.moved_pair_mask(t(key), t(coords), t(keys), 2, n_mol,
                                        box, r_cut, mode),
                pairs_j.moved_pair_mask(j(key), j(coords), j(keys), 2, n_mol,
                                        box, r_cut, mode))
    ra = coords[2 * P:3 * P] + rng.normal(0.0, 0.3, size=(P, 3))
    return (pairs_t.moved_pair_mask_site(t(ra), t(coords), 2, n_mol, box,
                                         r_cut),
            pairs_j.moved_pair_mask_site(j(ra), j(coords), 2, n_mol, box,
                                         r_cut))


@pytest.mark.parametrize("name", [
    "overlap_any", "molecule_key_points:com", "molecule_key_points:first",
    "moved_pair_mask:com", "moved_pair_mask:first", "moved_pair_mask_site",
    "molecule_key_points:site", "moved_pair_mask:site"])
def test_mask_helpers_match_jax(name):
    """ops/ewald.py overlap_any and ops/pairs.py molecule_key_points,
    moved_pair_mask, moved_pair_mask_site against JAX's on seeded float64
    inputs: masks equal exactly, key points to 1e-12; the refusals (no key
    point for "site", moved_pair_mask's NotImplementedError) raise the
    same errors."""
    rng = np.random.default_rng(7)
    if name.endswith(":site"):
        err = ValueError if name.startswith("molecule") else \
            NotImplementedError
        from metropolismontecarlo_tpu.ops import pairs as pairs_j
        from metropolismontecarlo_tpu_torch.ops import pairs as pairs_t
        for mod, arr in ((pairs_t, torch.zeros), (pairs_j, jnp.zeros)):
            with pytest.raises(err):
                if name.startswith("molecule"):
                    mod.molecule_key_points(arr((2, 3, 3)), arr((2, 3)),
                                            "site")
                else:
                    mod.moved_pair_mask(arr((3,)), arr((6, 3)), arr((2, 3)),
                                        0, 2, 7.0, 3.0, "site")
        return
    port, ref = _mask_case(name, rng)
    port, ref = port.numpy(), np.asarray(ref)
    assert port.shape == ref.shape
    if ref.dtype == bool:
        assert port.dtype == bool
        assert np.array_equal(port, ref)
        assert port.any() and not port.all()
    else:
        _close(port, ref)
