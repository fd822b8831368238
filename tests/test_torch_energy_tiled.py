"""The port's row-tiled full energy (models/energy.py
energy_breakdown_tiled, the route above DENSE_MAX_ATOMS atoms), in
float64:

* against the JAX package's energy_breakdown on 1400 SPC/E waters (4200
  atoms, so JAX takes its own tiled route) with the flagship's Ewald
  truncation: every component within 1e-9 relative (S(k) within 1e-9 of
  its largest entry: JAX builds it by the eik recurrence);
* called directly with B = 32 on 64 waters against the port's dense
  route, every Coulomb style, and on a linear-shift triatomic: within
  1e-10 (the JAX tiled route leaves the shift's force term out of the
  virial; the port's keeps it, as the dense route does);
* batched over chains, each row equal to its single-configuration call;
* the recompute chunk model counts the tiles and the (A, K) grids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.models import energy as energy_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import _auto_recompute_chunk
from metropolismontecarlo_tpu_torch.models import energy as energy_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams

COULOMB = {"ewald": dict(coulomb="ewald"), "wolf": dict(coulomb="wolf"),
           "wolf_ref": dict(coulomb="wolf", wolf_style="ref"),
           "bare": dict(coulomb="bare"), "none": dict(coulomb="none")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread per test process leaves the cores to the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice_config(system, box, seed, jitter=0.1):
    """A jittered cubic lattice with random orientations; atoms =
    com + R(q) body (numpy float64)."""
    rng = np.random.default_rng(seed)
    M = system.n_mol
    com = np.asarray(cubic_lattice(M, box), np.float64) \
        + rng.uniform(-jitter, jitter, (M, 3))
    q = rng.normal(size=(M, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    coords = com[:, None, :] + np.einsum("mij,mpj->mpi", rot,
                                         np.asarray(system.body))
    return coords.reshape(-1, 3), com


def _assert_close(out, ref, rtol):
    assert set(out) == set(ref)
    for key, r in ref.items():
        r, o = np.asarray(r), np.asarray(out[key])
        assert o.shape == r.shape, key
        if key == "sfac":
            np.testing.assert_allclose(o, r, rtol=0,
                                       atol=rtol * max(np.abs(r).max(), 1.0))
        else:
            np.testing.assert_allclose(o, r, rtol=rtol, atol=rtol,
                                       err_msg=key)


def test_tiled_matches_jax_on_1400_waters():
    n, box = 1400, 34.74
    params = dict(temperature=298.15, r_cut=10.0, coulomb="ewald")
    sys_j = water_j.spce_system(n)
    assert sys_j.n_atoms > energy_t.DENSE_MAX_ATOMS
    coords, com = _lattice_config(sys_j, box, seed=5)
    kv, kw = make_kvectors(5, 27)
    ref = energy_j.energy_breakdown(sys_j, RunParamsJ(**params),
                                    jnp.asarray(coords), jnp.asarray(com),
                                    box, kv, kw)
    out = energy_t.energy_breakdown(water_t.spce_system(n),
                                    RunParams(**params),
                                    torch.tensor(coords), torch.tensor(com),
                                    box, kv, kw)
    _assert_close(out, ref, 1e-9)
    assert float(out["coul_real"]) != 0.0 and float(out["disp"]) != 0.0


CASES = dict({f"spce64 {c}": (water_t.spce_system(64), 12.42,
                              dict(temperature=300.0, r_cut=6.0, **kw))
              for c, kw in COULOMB.items()},
             **{"tri64 linear": (poly_t.triatomic_system(64),
                                 (64 / 0.1) ** (1 / 3),
                                 dict(temperature=1.0, r_cut=2.3,
                                      lj_shift="linear", use_lrc=False,
                                      coulomb="none"))})


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_equals_dense(case):
    system, box, kw = CASES[case]
    params = RunParams(nk=3, ksq_max=10, strict_min_image=False, **kw)
    kv, kwt = make_kvectors(3, 10)
    coords, com = _lattice_config(system, box, seed=len(case))
    args = (system, params, torch.tensor(coords), torch.tensor(com), box,
            kv, kwt)
    dense = energy_t.energy_breakdown(*args)
    tiled = energy_t.energy_breakdown_tiled(*args, row_block=32)
    _assert_close({k: v.numpy() for k, v in tiled.items()},
                  {k: v.numpy() for k, v in dense.items()}, 1e-10)


def test_tiled_cutoff_modes():
    """Site cutoff only; above DENSE_MAX_ATOMS energy_breakdown routes
    every other mode to the tiled route, which refuses it."""
    system = water_t.spce_system(64)
    coords, com = _lattice_config(system, 12.42, seed=1)
    with pytest.raises(NotImplementedError, match="site cutoff"):
        energy_t.energy_breakdown_tiled(
            system, RunParams(cutoff_mode="com", r_cut=6.0),
            torch.tensor(coords), torch.tensor(com), 12.42)


def test_tiled_batched_equals_single():
    system = water_t.spce_system(27)
    params = RunParams(r_cut=4.5, nk=3, ksq_max=10, coulomb="ewald",
                       strict_min_image=False)
    kv, kwt = make_kvectors(3, 10)
    boxes = (9.3, 9.4, 9.2)
    confs = [_lattice_config(system, b, seed=s) for s, b in enumerate(boxes)]
    coords = torch.tensor(np.stack([c for c, _ in confs]))
    com = torch.tensor(np.stack([m for _, m in confs]))
    box_t = torch.tensor(boxes, dtype=torch.float64)
    batched = energy_t.energy_breakdown_tiled(system, params, coords, com,
                                              box_t, kv, kwt, row_block=16)
    for i in range(3):
        one = energy_t.energy_breakdown_tiled(system, params, coords[i],
                                              com[i], box_t[i], kv, kwt,
                                              row_block=16)
        for key in one:
            np.testing.assert_allclose(batched[key][i].numpy(),
                                       one[key].numpy(), rtol=1e-12,
                                       atol=1e-9, err_msg=key)


def test_recompute_chunk_model():
    """Dense sizes: ~48 (A, A) grids per chain; tiled sizes: 48 (B, A)
    tiles plus 8 (A, K) grids, so Ewald's K shrinks the chunk."""
    small = water_t.spce_system(750)
    assert _auto_recompute_chunk(small, torch.float32) == int(
        (8 << 30) // (48 * 2304 * 2304 * 4))
    big = water_t.spce_system(6859)
    A = big.n_atoms_padded
    no_k = _auto_recompute_chunk(big, torch.float32)
    with_k = _auto_recompute_chunk(big, torch.float32, n_k=2874)
    assert no_k == min(64, (8 << 30) // (4 * A * 48 * energy_t.ROW_BLOCK))
    assert with_k == max(1, (8 << 30) // (4 * A * (48 * energy_t.ROW_BLOCK
                                                   + 8 * 2874)))
    assert 1 <= with_k < no_k
    assert _auto_recompute_chunk(big, torch.float64, n_k=2874) <= with_k
