"""The port's sweep op on the CPU (sweep_plain) against the JAX
whole-sweep Pallas kernel run by the TPU interpreter.

The interpreter's on-core PRNG returns zeros, so the JAX kernel takes
deterministic moves: with p_translate=0.5 every move translates by
-dr_max/2 per axis, with p_translate=0.0 every move rotates by -dphi_max
about one fixed axis, and u_acc = 0 accepts every move the overlap veto
lets through.  Feeding the port u = 0 makes it take the same moves.
Both run in float32: acc/att must be equal, energies within rtol 2e-4,
COM within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc.moves import make_mega_sweep_fn
from metropolismontecarlo_tpu.models import polyatomic as poly_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import SimState as SimStateJ
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
from metropolismontecarlo_tpu_torch.models import polyatomic as poly_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

C = 4
N_SWEEPS = 2

# (port builder, JAX builder, n_mol, box, RunParams kwargs)
CASES = {
    "spce8": (water_t.spce_system, water_j.spce_system, 8, 12.0,
              dict(temperature=300.0, r_cut=5.0, nk=3, ksq_max=9,
                   dr_max=0.25, dphi_max=0.3)),
    "tri27": (poly_t.triatomic_system, poly_j.triatomic_system, 27,
              (27 / 0.25) ** (1 / 3),
              dict(temperature=1.0, r_cut=2.612, lj_shift="linear",
                   use_lrc=False, coulomb="none", dr_max=2e-3,
                   dphi_max=2e-3, strict_min_image=False)),
}


def _start(system, box, params_t, kv, kw):
    """float32 numpy state: jittered lattice, random orientations, f64
    energy and S(k) cast to f32."""
    rng = np.random.default_rng(11)
    M, A, A_pad = system.n_mol, system.n_atoms, system.n_atoms_padded
    n_side = int(np.ceil(M ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:M]
    com = (grid + 0.5) * box / n_side + rng.uniform(-0.05, 0.05, (C, M, 3))
    q = rng.normal(size=(C, M, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    atoms = com[:, :, None, :] + np.einsum("cmij,mpj->cmpi", rot,
                                           np.asarray(system.body))
    coords = np.zeros((C, 3, A_pad))
    coords[:, :, :A] = atoms.reshape(C, A, 3).transpose(0, 2, 1)
    ref = energy_breakdown(system, params_t,
                           torch.tensor(atoms.reshape(C, A, 3)),
                           torch.tensor(com), torch.full((C,), box,
                                                         dtype=torch.float64),
                           kv, kw)
    f32 = np.float32
    return dict(com=com.astype(f32), quat=q.astype(f32),
                coords=coords.astype(f32), box=np.full(C, box, f32),
                sfac=ref["sfac"].numpy().astype(f32),
                energy=ref["total"].numpy().astype(f32),
                virial=np.zeros(C, f32), temp=np.full(C, params_t.temperature,
                                                      f32),
                step=np.asarray(0, np.int32),
                dr_max=np.full(C, params_t.dr_max, f32),
                dphi_max=np.full(C, params_t.dphi_max, f32),
                dv_max=np.full(C, params_t.dv_max, f32),
                acc=np.zeros((C, 3), np.int32), att=np.zeros((C, 3), np.int32),
                nbr=np.zeros((C, 1, 1), np.int32),
                nbr_needed=np.zeros(C, np.int32))


def _run_jax(system, params, kv, kw, s):
    sweep = make_mega_sweep_fn(system, params, kv, kw, interpret=True)
    st = SimStateJ(key=jnp.zeros((C, 2), jnp.uint32),
                   **{k: jnp.asarray(v) for k, v in s.items()})
    for _ in range(N_SWEEPS):
        st = sweep(st)
    return {k: np.asarray(getattr(st, k)) for k in ("com", "quat", "coords",
                                                     "sfac", "energy", "acc",
                                                     "att")}


def _run_port(tables, s):
    t = {k: torch.tensor(v) for k, v in s.items()}
    coords, com, quat, sfac = t["coords"], t["com"], t["quat"], t["sfac"]
    energy, acc, att = t["energy"], t["acc"], t["att"]
    M = tables.M
    for _ in range(N_SWEEPS):
        coords, com, quat, sfac, stats = sweep_op.sweep_plain(
            coords, com, quat, sfac, t["box"], t["temp"], t["dr_max"],
            t["dphi_max"], torch.zeros((C, M, sweep_op.N_UNIFORMS)), tables)
        energy = energy + stats[:, 0]
        acc = acc + torch.stack([stats[:, 1], stats[:, 2], 0 * stats[:, 1]],
                                1).int()
        att = att + torch.stack([stats[:, 3], stats[:, 4], 0 * stats[:, 1]],
                                1).int()
    return dict(com=com.numpy(), quat=quat.numpy(), coords=coords.numpy(),
                sfac=sfac.numpy(), energy=energy.numpy(), acc=acc.numpy(),
                att=att.numpy())


@pytest.mark.parametrize("p_translate", [0.5, 0.0])
@pytest.mark.parametrize("case,coulomb", [("spce8", "ewald"),
                                          ("spce8", "wolf"),
                                          ("spce8", "none"),
                                          ("tri27", "none")])
def test_sweep_plain_matches_jax_interpret_kernel(case, coulomb,
                                                  p_translate):
    build_t, build_j, n, box, kw = CASES[case]
    kw = dict(kw, coulomb=coulomb, p_translate=p_translate)
    params_t, params_j = RunParams(**kw), RunParamsJ(**kw)
    kv = kwt = None
    if coulomb == "ewald":
        kv, kwt = make_kvectors(params_t.nk, params_t.ksq_max)
    s = _start(build_t(n), box, params_t, kv, kwt)
    ref = _run_jax(build_j(n), params_j, kv, kwt, s)
    (tables,) = sweep_tables(build_t(n), params_t, kv, kwt, "cpu")
    out = _run_port(tables, s)

    np.testing.assert_array_equal(out["acc"], ref["acc"])
    np.testing.assert_array_equal(out["att"], ref["att"])
    moves = N_SWEEPS * n
    col = 0 if p_translate > 0 else 1
    assert (out["att"][:, col] == moves).all()
    assert out["acc"].sum() > 0
    np.testing.assert_allclose(out["energy"], ref["energy"], rtol=2e-4)
    np.testing.assert_allclose(out["com"], ref["com"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["coords"], ref["coords"], rtol=0,
                               atol=1e-4)
    if coulomb == "ewald":
        scale = np.abs(ref["sfac"]).max()
        np.testing.assert_allclose(out["sfac"], ref["sfac"], rtol=0,
                                   atol=1e-4 * scale)


def _small_inputs():
    system = water_t.spce_system(8)
    params = RunParams(temperature=300.0, r_cut=5.0, coulomb="wolf",
                       strict_min_image=False)
    (tables,) = sweep_tables(system, params, None, None, "cpu")
    s = _start(system, 12.0, params, None, None)
    t = {k: torch.tensor(v) for k, v in s.items()}
    args = [t["coords"], t["com"], t["quat"], t["sfac"], t["box"], t["temp"],
            t["dr_max"], t["dphi_max"],
            torch.rand((C, 8, sweep_op.N_UNIFORMS),
                       generator=torch.Generator().manual_seed(0))]
    return args, tables


def test_sweep_wrapper_runs_plain_on_cpu_without_counting():
    args, tables = _small_inputs()
    before = sweep_op.sweep.launches
    got = sweep_op.sweep(*args, tables)
    want = sweep_op.sweep_plain(*args, tables)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sweep_op.sweep.launches == before


def test_sweep_plain_magnitude_column():
    """magnitude=True leaves the N_STATS stats columns and the state as they
    were and adds the accepted moves' term magnitudes, which bound the
    summed energy delta."""
    args, tables = _small_inputs()
    plain = sweep_op.sweep_plain(*args, tables)
    mag = sweep_op.sweep_plain(*args, tables, magnitude=True)
    for g, w in zip(mag[:4], plain[:4]):
        assert torch.equal(g, w)
    assert mag[4].shape == (C, sweep_op.N_STATS + 1)
    assert torch.equal(mag[4][:, :sweep_op.N_STATS], plain[4])
    assert bool((mag[4][:, sweep_op.N_STATS] >= plain[4][:, 0].abs()).all())
    assert bool((mag[4][:, sweep_op.N_STATS] > 0.0).all())


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_sweep_wrapper_rejects_bad_inputs(bad):
    args, tables = _small_inputs()
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[8] = args[8][:, :5]
    elif bad == "contiguity":
        args[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    else:
        args = [a.to("meta") for a in args]
        tables = dataclasses.replace(
            tables, **{k: v.to("meta") for k, v in tables.tensors().items()})
    with pytest.raises(ValueError):
        sweep_op.sweep(*args, tables)


def test_smem_layout_fits_the_flagship():
    """750 SPC/E waters with the reference's Ewald table keep one chain's
    atom planes in a block's shared memory with room for three blocks per
    SM (228 KB, 1 KB of it reserved per block)."""
    system = water_t.spce_system(750)
    kv, _ = make_kvectors(5, 27)
    nbytes = sweep_op.smem_bytes(750, 3, system.n_atoms_padded, len(kv), 2)
    assert system.n_atoms_padded == 2304 and len(kv) == 337
    assert 3 * (nbytes + 1024) <= 228 * 1024
    assert sweep_op.choose_layout(750, 3, 2304, 337, 2) == "shared"


def test_choose_layout_takes_shared_for_activity_states_that_now_fit():
    """Capacity-2048 SPC/E with its activity planes: 150 KB without the
    COM and quaternion rows and the per-atom charge and type rows (which
    stay in global memory), so the shared layout takes it; with those
    7 M + 2 A_pad words it would not fit.  Twice that capacity takes the
    global layout, activity planes and all."""
    shape = (2048, 3, 6144, 337, 2)
    nbytes = sweep_op.smem_bytes(*shape, use_act=True)
    assert nbytes <= sweep_op.MAX_SMEM_BYTES
    assert nbytes + 4 * (7 * 2048 + 2 * 6144) > sweep_op.MAX_SMEM_BYTES
    assert sweep_op.choose_layout(*shape, use_act=True) == "shared"
    assert sweep_op.choose_layout(*shape, use_act=True, tmmc=True) \
        == "shared"
    assert sweep_op.choose_layout(4096, 3, 12288, 337, 2, use_act=True) \
        == "global"
