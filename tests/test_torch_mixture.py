"""Species-blocked mixtures in the port against the JAX package: the
TraPPE CO2/N2 builders, energy_breakdown on a two-block and a ragged
mixture (float64, rtol 1e-9), and the species-block sweep (sweep_plain,
one call per block) against the JAX whole-sweep Pallas kernel run by the
TPU interpreter.

The ragged mixture is models.water.spce_methane_system: SPC/E waters (P = 3)
next to united-atom methane sites (P = 1, TraPPE CH4), so that a block's
first atom column a_start differs from m_start * P.

The interpreter's on-core PRNG returns zeros, so the JAX kernel takes
deterministic moves; the port is fed u = 0 to take the same ones (see
tests/test_torch_sweep.py).  float32: acc/att equal, energies within
rtol 2e-4, COM within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc.moves import make_mega_sweep_fn
from metropolismontecarlo_tpu.models import energy as energy_j
from metropolismontecarlo_tpu.models import linear as linear_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import SimState as SimStateJ
from metropolismontecarlo_tpu.models.system import System as SystemJ
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch.mc.moves import sweep_blocks, sweep_tables
from metropolismontecarlo_tpu_torch.models import energy as energy_t
from metropolismontecarlo_tpu_torch.models import linear as linear_t
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_methane_system
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op


def _pair(name):
    """(port System, JAX System) of a test mixture."""
    if name == "co2_n2":
        return linear_t.co2_n2_system(6, 4), linear_j.co2_n2_system(6, 4)
    sys_t = spce_methane_system(6, 6)
    return sys_t, SystemJ(**{f.name: getattr(sys_t, f.name)
                             for f in dataclasses.fields(sys_t)})


def _atoms(system, com, q):
    """Flat (..., A, 3) atoms of rigid molecules com (..., M, 3) with
    orientations q (..., M, 4) (numpy)."""
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    per_mol = com[..., :, None, :] + np.einsum(
        "...mij,mpj->...mpi", rot, np.asarray(system.body))
    mol, slot = system.atom_mol_slot
    return per_mol[..., mol, slot, :]


@pytest.mark.parametrize("name", ["co2", "n2", "co2_n2"])
def test_linear_builders_match_jax(name):
    port, ref = {
        "co2": (linear_t.co2_system(5), linear_j.co2_system(5)),
        "n2": (linear_t.n2_system(5), linear_j.n2_system(5)),
        "co2_n2": (linear_t.co2_n2_system(4, 3),
                   linear_j.co2_n2_system(4, 3)),
    }[name]
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for prop in ("n_atoms", "n_atoms_padded", "species_uniform",
                 "is_uniform", "species_slices", "uniform_width"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for prop in ("mol_of_atom_padded", "type_counts", "mol_p", "mol_a0"):
        np.testing.assert_array_equal(getattr(port, prop),
                                      getattr(ref, prop))


@pytest.mark.parametrize("name", ["co2_n2", "ragged"])
def test_energy_breakdown_matches_jax_on_mixtures(name):
    sys_t, sys_j = _pair(name)
    box = 9.0
    kw = dict(temperature=240.0, r_cut=4.0, coulomb="ewald", nk=3,
              ksq_max=10, strict_min_image=False)
    rng = np.random.default_rng(31)
    com = rng.uniform(0.0, box, (sys_t.n_mol, 3))
    q = rng.normal(size=(sys_t.n_mol, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    coords = _atoms(sys_t, com, q)
    kv, kwt = make_kvectors(3, 10)
    ref = energy_j.energy_breakdown(sys_j, RunParamsJ(**kw),
                                    jnp.asarray(coords), jnp.asarray(com),
                                    box, kv, kwt)
    out = energy_t.energy_breakdown(sys_t, RunParams(**kw),
                                    torch.tensor(coords), torch.tensor(com),
                                    box, kv, kwt)
    assert set(out) == set(ref)
    for key, r in ref.items():
        r, o = np.asarray(r), out[key].numpy()
        assert o.shape == r.shape and o.dtype == np.float64, key
        if key == "sfac":
            atol = 1e-9 * max(np.abs(r).max(), 1.0)
            np.testing.assert_allclose(o, r, rtol=0, atol=atol)
        else:
            np.testing.assert_allclose(o, r, rtol=1e-9, atol=1e-9,
                                       err_msg=key)
    assert abs(float(out["coul_real"])) > 0.0


C = 4
N_SWEEPS = 2


def _start(sys_t, box, params, kv, kw):
    """float32 numpy state: jittered lattice, random orientations, f64
    energy and S(k) cast to f32."""
    rng = np.random.default_rng(12)
    M, A_pad = sys_t.n_mol, sys_t.n_atoms_padded
    n_side = int(np.ceil(M ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:M]
    com = (grid + 0.5) * box / n_side + rng.uniform(-0.05, 0.05, (C, M, 3))
    q = rng.normal(size=(C, M, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    atoms = _atoms(sys_t, com, q)                                  # (C, A, 3)
    coords = np.zeros((C, 3, A_pad))
    coords[:, :, :sys_t.n_atoms] = atoms.transpose(0, 2, 1)
    ref = energy_t.energy_breakdown(sys_t, params, torch.tensor(atoms),
                                    torch.tensor(com),
                                    torch.full((C,), box,
                                               dtype=torch.float64), kv, kw)
    f32 = np.float32
    return dict(com=com.astype(f32), quat=q.astype(f32),
                coords=coords.astype(f32), box=np.full(C, box, f32),
                sfac=ref["sfac"].numpy().astype(f32),
                energy=ref["total"].numpy().astype(f32),
                virial=np.zeros(C, f32),
                temp=np.full(C, params.temperature, f32),
                step=np.asarray(0, np.int32),
                dr_max=np.full(C, params.dr_max, f32),
                dphi_max=np.full(C, params.dphi_max, f32),
                dv_max=np.full(C, params.dv_max, f32),
                acc=np.zeros((C, 3), np.int32), att=np.zeros((C, 3), np.int32),
                nbr=np.zeros((C, 1, 1), np.int32),
                nbr_needed=np.zeros(C, np.int32))


@pytest.mark.parametrize("p_translate", [0.5, 0.0])
@pytest.mark.parametrize("name", ["co2_n2", "ragged"])
def test_species_block_sweep_matches_jax_interpret_kernel(name, p_translate):
    sys_t, sys_j = _pair(name)
    # roomy enough that no move's beta * dE lands where exp(-beta dE)
    # underflows (u = 0 accepts exactly the moves with exp > 0, and the
    # two packages flush denormals differently)
    box = 13.0
    kw = dict(temperature=300.0, r_cut=5.0, coulomb="ewald", nk=3,
              ksq_max=9, p_translate=p_translate, dr_max=0.25, dphi_max=0.3)
    params_t = RunParams(**kw)
    kv, kwt = make_kvectors(3, 9)
    s = _start(sys_t, box, params_t, kv, kwt)

    sweep_j = make_mega_sweep_fn(sys_j, RunParamsJ(**kw), kv, kwt,
                                 interpret=True)
    st = SimStateJ(key=jnp.zeros((C, 2), jnp.uint32),
                   **{k: jnp.asarray(v) for k, v in s.items()})
    for _ in range(N_SWEEPS):
        st = sweep_j(st)

    tables = sweep_tables(sys_t, params_t, kv, kwt, "cpu")
    assert [(t.m_start, t.a_start, t.P) for t in tables] == \
        [(m0, a0, p) for _, m0, _, p, a0 in sys_t.species_slices]
    t = {k: torch.tensor(v) for k, v in s.items()}
    coords, com, quat, sfac = t["coords"], t["com"], t["quat"], t["sfac"]
    energy, acc, att = t["energy"], t["acc"], t["att"]
    for _ in range(N_SWEEPS):
        coords, com, quat, sfac, stats = sweep_blocks(
            sweep_op.sweep_plain, coords, com, quat, sfac, t["box"],
            t["temp"], t["dr_max"], t["dphi_max"],
            torch.zeros((C, sys_t.n_mol, sweep_op.N_UNIFORMS)), tables)
        energy = energy + stats[:, 0]
        acc[:, :2] += stats[:, 1:3].int()
        att[:, :2] += stats[:, 3:5].int()

    np.testing.assert_array_equal(acc.numpy(), np.asarray(st.acc))
    np.testing.assert_array_equal(att.numpy(), np.asarray(st.att))
    assert int(att.sum()) == N_SWEEPS * C * sys_t.n_mol
    assert int(acc.sum()) > 0
    np.testing.assert_allclose(energy.numpy(), np.asarray(st.energy),
                               rtol=2e-4)
    np.testing.assert_allclose(com.numpy(), np.asarray(st.com), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(coords.numpy(), np.asarray(st.coords),
                               rtol=0, atol=1e-4)
    scale = np.abs(np.asarray(st.sfac)).max()
    np.testing.assert_allclose(sfac.numpy(), np.asarray(st.sfac), rtol=0,
                               atol=1e-4 * scale)
