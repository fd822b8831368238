"""PyTorch port's energy_breakdown against the JAX package's, in float64:
every key within rtol 1e-9 (S(k) within 1e-9 of its largest entry: the
JAX package builds it by the eik recurrence, the port directly).  Random
rigid configurations from a numpy seed in small boxes, which sample the
truncated-nearest-image model (strict_min_image=False) as the JAX tests
do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.models import energy as energy_j
from metropolismontecarlo_tpu.models import monatomic as mono_j
from metropolismontecarlo_tpu.models import polyatomic as poly_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch.models import energy as energy_t
from metropolismontecarlo_tpu_torch.models import monatomic as mono_t
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams

# (port builder, JAX builder, n_mol, box, extra RunParams)
SYSTEMS = {
    "spce8": (water_t.spce_system, water_j.spce_system, 8, 9.0,
              dict(temperature=300.0, r_cut=4.0)),
    "spce64": (water_t.spce_system, water_j.spce_system, 64, 12.42,
               dict(temperature=300.0, r_cut=6.0)),
    "lj27": (mono_t.lj_system, mono_j.lj_system, 27, 4.2,
             dict(temperature=1.0, r_cut=2.0)),
    "tri27": (poly_t.triatomic_system, poly_j.triatomic_system, 27, 4.8,
              dict(temperature=1.0, r_cut=2.3, lj_shift="linear",
                   use_lrc=False)),
}
COULOMB = {"ewald": dict(coulomb="ewald"), "wolf": dict(coulomb="wolf"),
           "wolf_ref": dict(coulomb="wolf", wolf_style="ref"),
           "bare": dict(coulomb="bare"), "none": dict(coulomb="none")}


def _config(system, box, seed):
    """Random COMs and orientations; atoms = com + R(q) body (numpy)."""
    rng = np.random.default_rng(seed)
    M = system.n_mol
    com = rng.uniform(0.0, box, size=(M, 3))
    q = rng.normal(size=(M, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    coords = com[:, None, :] + np.einsum("mij,mpj->mpi", rot,
                                         np.asarray(system.body))
    return coords.reshape(-1, 3), com


@pytest.mark.parametrize("coul", sorted(COULOMB))
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_energy_breakdown_matches_jax(name, coul):
    build_t, build_j, n, box, extra = SYSTEMS[name]
    kw = dict(extra, nk=3, ksq_max=10, strict_min_image=False,
              **COULOMB[coul])
    sys_j = build_j(n)
    coords, com = _config(sys_j, box, seed=len(name) * 7 + len(coul))
    kv, kwt = make_kvectors(3, 10)
    ref = energy_j.energy_breakdown(sys_j, RunParamsJ(**kw),
                                    jnp.asarray(coords), jnp.asarray(com),
                                    box, kv, kwt)
    out = energy_t.energy_breakdown(build_t(n), RunParams(**kw),
                                    torch.tensor(coords), torch.tensor(com),
                                    box, kv, kwt)
    assert set(out) == set(ref)
    for key, r in ref.items():
        r = np.asarray(r)
        o = out[key].numpy()
        assert o.shape == r.shape and o.dtype == np.float64, key
        if key == "sfac":
            atol = 1e-9 * max(np.abs(r).max(), 1.0)
            np.testing.assert_allclose(o, r, rtol=0, atol=atol)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-9, atol=1e-9,
                                       err_msg=key)
    if coul != "none" and name.startswith("spce"):
        assert abs(float(out["coul_real"])) > 0.0


def test_energy_breakdown_batched_equals_single():
    """The port batches over a leading chain axis: each row equals the
    single-configuration call."""
    build_t, build_j, n, box, extra = SYSTEMS["spce8"]
    kw = dict(extra, nk=3, ksq_max=10, strict_min_image=False,
              coulomb="ewald")
    params = RunParams(**kw)
    kv, kwt = make_kvectors(3, 10)
    confs = [_config(build_j(n), box, seed=s) for s in range(3)]
    coords = torch.tensor(np.stack([c for c, _ in confs]))
    com = torch.tensor(np.stack([m for _, m in confs]))
    boxes = torch.tensor([box, box * 1.01, box * 0.99], dtype=torch.float64)
    batched = energy_t.energy_breakdown(build_t(n), params, coords, com,
                                        boxes, kv, kwt)
    for i in range(3):
        one = energy_t.energy_breakdown(build_t(n), params, coords[i],
                                        com[i], boxes[i], kv, kwt)
        for key in one:
            np.testing.assert_allclose(batched[key][i].numpy(),
                                       one[key].numpy(), rtol=1e-12,
                                       atol=1e-9)


def test_energy_breakdown_refuses_tiled_sizes():
    """Above DENSE_MAX_ATOMS energy_breakdown takes the row-tiled route
    (tests/test_torch_energy_tiled.py), which runs site cutoff only and
    refuses the molecular cutoff modes."""
    system = water_t.spce_system(1400)
    coords = torch.zeros((system.n_atoms, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="row-tiled"):
        energy_t.energy_breakdown(system, RunParams(cutoff_mode="com"),
                                  coords,
                                  torch.zeros((1400, 3),
                                              dtype=torch.float64), 40.0)
