"""The TIP4P family (four sites, a massless charged M site without LJ) in
the port, against the JAX package on the CPU.

* tip4p2005_system, tip4pew_system and tip4pice_system: bodies, masses,
  charges, types and tables equal JAX's bit for bit; the geometry of
  tests/test_tip4p.py (r_OH, the HOH angle, M on the bisector at r_OM,
  the centre of mass at the origin, neutral molecules, a massless M).
* energy_breakdown at P = 4 in float64 equals JAX's within 1e-10
  relative: 8 molecules with Ewald (S(k) within 1e-10 of its largest
  entry), Wolf and bare Coulomb, and the bare-Coulomb dimer against an
  explicit numpy sum over its 16 site pairs.
* The proposal seam: JAX propose_full's proposals (float64, 8 chains) go
  into the port's pair_energy_rows and finalize: d_e within 1e-10
  relative, the decisions equal, the new state within 1e-10.  The kernel
  branch (delta_energy's plain version at R = 8 rows, float32) fed the
  JAX interpreted per-move route's proposals gives that route's state
  within 1e-4.
* The whole-sweep twin: sweep_plain on zero uniforms takes the decisions
  of JAX mega="interpret" (whose interpreter PRNG returns zeros), and its
  carried energy matches the dense recompute within 2e-4 (JAX
  test_tip4p.py's bookkeeping gate), for translations and rotations.
* A float64 NVT run of each variant on the plain route drifts under
  1e-10 with rotations accepted; the float32 whole-sweep route under
  2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc.moves import make_mega_sweep_fn
from metropolismontecarlo_tpu.mc.moves import make_sweep_fn as make_sweep_j
from metropolismontecarlo_tpu.models import energy as energy_j
from metropolismontecarlo_tpu.models import water as water_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import SimState as SimStateJ
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.moves import make_sweep_fn
from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
from metropolismontecarlo_tpu_torch.models import energy as energy_t
from metropolismontecarlo_tpu_torch.models import water as water_t
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.cuda import sweep_kernel as sweep_op
from metropolismontecarlo_tpu_torch.utils.constants import COULOMB_FACTOR

VARIANTS = {
    "tip4p2005": (water_t.tip4p2005_system, water_j.tip4p2005_system,
                  water_t.TIP4P2005_Q_H, water_t.TIP4P2005_R_OM),
    "tip4pew": (water_t.tip4pew_system, water_j.tip4pew_system, 0.52422,
                0.125),
    "tip4pice": (water_t.tip4pice_system, water_j.tip4pice_system, 0.5897,
                 0.1577),
}
SEAM_PARAMS = dict(temperature=300.0, r_cut=5.0, coulomb="ewald", nk=3,
                   ksq_max=9, p_translate=0.5, dr_max=0.6, dphi_max=0.8,
                   strict_min_image=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free(fn, name):
    """A closure variable of fn (the JAX move builders keep propose_full,
    pair_energy_rows and finalize as closures)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _chains(system, C, box, seed, dtype=np.float64):
    """C rigid configurations on a jittered lattice with random
    orientations (numpy): com (C, M, 3), quat (C, M, 4), coords
    (C, 3, A_pad), atoms (C, A, 3)."""
    rng = np.random.default_rng(seed)
    M, A = system.n_mol, system.n_atoms
    com = cubic_lattice(M, box) + rng.uniform(-0.3, 0.3, (C, M, 3))
    q = rng.normal(size=(C, M, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    atoms = (com[:, :, None, :] + np.einsum(
        "cmij,mpj->cmpi", rot, np.asarray(system.body))).reshape(C, A, 3)
    coords = np.zeros((C, 3, system.n_atoms_padded))
    coords[:, :, :A] = atoms.transpose(0, 2, 1)
    return (com.astype(dtype), q.astype(dtype), coords.astype(dtype),
            atoms)


# ---------------- builders ---------------------------------------------


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_builders_equal_jax_bit_for_bit(name):
    build_t, build_j, q_h, r_om = VARIANTS[name]
    s_t, s_j = build_t(5), build_j(5)
    for f in ("body", "masses", "charges", "type_ids", "eps_table",
              "sig_table"):
        a, b = getattr(s_t, f), np.asarray(getattr(s_j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (s_t.n_mol, s_t.atoms_per_mol, s_t.name, s_t.species) == \
        (s_j.n_mol, s_j.atoms_per_mol, s_j.name, s_j.species)
    assert s_t.n_atoms_padded == 128 and s_t.is_uniform

    o, h1, h2, m = s_t.body[0]
    r_oh = water_t.TIP4P2005_R_OH
    assert np.linalg.norm(h1 - o) == pytest.approx(r_oh, abs=1e-12)
    assert np.linalg.norm(h2 - o) == pytest.approx(r_oh, abs=1e-12)
    cosang = np.dot(h1 - o, h2 - o) / r_oh ** 2
    assert np.degrees(np.arccos(cosang)) == pytest.approx(
        water_t.TIP4P2005_THETA, abs=1e-9)
    assert np.linalg.norm(m - o) == pytest.approx(r_om, abs=1e-12)
    bis = (h1 - o) + (h2 - o)
    assert np.dot(m - o, bis) == pytest.approx(
        np.linalg.norm(m - o) * np.linalg.norm(bis), rel=1e-12)
    w = s_t.masses[0]
    np.testing.assert_allclose((s_t.body[0] * w[:, None]).sum(0) / w.sum(),
                               0.0, atol=1e-12)
    q = s_t.charges[0]
    assert q.sum() == pytest.approx(0.0, abs=1e-12)
    assert q[0] == 0.0 and q[1] == q_h and q[3] == -2.0 * q_h
    assert w[3] == 0.0 and list(s_t.type_ids[0]) == [0, 1, 1, 1]


# ---------------- energies ---------------------------------------------


@pytest.mark.parametrize("coul", ["ewald", "wolf", "bare"])
def test_energy_breakdown_at_p4_matches_jax(coul):
    kw = dict(temperature=300.0, r_cut=4.5, nk=3, ksq_max=10,
              strict_min_image=False, coulomb=coul)
    s_t, s_j = water_t.tip4p2005_system(8), water_j.tip4p2005_system(8)
    box = 9.5
    com, _, _, atoms = _chains(s_t, 1, box, seed=len(coul))
    kv, kwt = make_kvectors(3, 10)
    ref = energy_j.energy_breakdown(s_j, RunParamsJ(**kw),
                                    jnp.asarray(atoms[0]),
                                    jnp.asarray(com[0]), box, kv, kwt)
    out = energy_t.energy_breakdown(s_t, RunParams(**kw),
                                    torch.tensor(atoms[0]),
                                    torch.tensor(com[0]), box, kv, kwt)
    assert set(out) == set(ref)
    for key, r in ref.items():
        r, o = np.asarray(r), out[key].numpy()
        if key == "sfac":
            np.testing.assert_allclose(o, r, rtol=0,
                                       atol=1e-10 * np.abs(r).max())
        else:
            np.testing.assert_allclose(o, r, rtol=1e-10, atol=1e-9,
                                       err_msg=key)
    assert abs(float(out["coul_real"])) > 0.0


def test_bare_dimer_equals_the_explicit_site_sum():
    """Two molecules 3.2 A apart: energy_breakdown (port and JAX) equals
    a numpy sum over the 16 site pairs (O-O LJ, Coulomb on H and M)."""
    s_t, s_j = water_t.tip4p2005_system(2), water_j.tip4p2005_system(2)
    kw = dict(strict_min_image=False, temperature=300.0, r_cut=12.0,
              cutoff_mode="com", coulomb="bare", use_lrc=False)
    com = np.array([[10.0, 10.0, 10.0], [13.2, 10.0, 10.0]])
    quat = np.array([[1.0, 0.0, 0.0, 0.0], [0.937, 0.23, -0.21, 0.15]])
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(quat)))
    r = com[:, None, :] + np.einsum("mij,pj->mpi", rot, s_t.body[0])
    out = energy_t.energy_breakdown(s_t, RunParams(**kw),
                                    torch.tensor(r.reshape(8, 3)),
                                    torch.tensor(com), 40.0)
    ref = energy_j.energy_breakdown(s_j, RunParamsJ(**kw),
                                    jnp.asarray(r.reshape(8, 3)),
                                    jnp.asarray(com), 40.0)
    q = s_t.charges
    e_ref = 0.0
    for a in range(4):
        for b in range(4):
            d = np.linalg.norm(r[0, a] - r[1, b])
            if a == 0 and b == 0:
                s6 = (water_t.TIP4P2005_SIGMA_OO / d) ** 6
                e_ref += 4.0 * water_t.TIP4P2005_EPS_OO * (s6 * s6 - s6)
            e_ref += COULOMB_FACTOR * q[0, a] * q[1, b] / d
    assert float(out["total"]) == pytest.approx(e_ref, rel=1e-10)
    assert float(out["total"]) == pytest.approx(float(ref["total"]),
                                                rel=1e-10)


# ---------------- moves ------------------------------------------------


def test_finalize_matches_jax_jnp_route_on_jax_proposals():
    C, box = 8, 9.5
    s_t, s_j = water_t.tip4p2005_system(8), water_j.tip4p2005_system(8)
    params_t = RunParams(**SEAM_PARAMS)
    kv, kwt = make_kvectors(3, 9)
    com, quat, coords, atoms = _chains(s_t, C, box, seed=4)
    sfac = energy_t.energy_breakdown(
        s_t, params_t, torch.tensor(atoms), torch.tensor(com),
        torch.full((C,), box, dtype=torch.float64), kv, kwt)["sfac"].numpy()
    boxes, energy = np.full(C, box), np.full(C, -500.0)
    temp = np.full(C, params_t.temperature)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    (sl,) = s_t.species_slices
    body_j = make_sweep_j(s_j, RunParamsJ(**SEAM_PARAMS), kv, kwt,
                          dtype=jnp.float64, species=sl)
    move_j = _free(body_j, "vmove").__wrapped__
    propose = jax.vmap(_free(move_j, "propose_full"),
                       in_axes=(0,) * 7 + (None, None))
    pair_rows = jax.vmap(_free(move_j, "pair_energy_rows"),
                         in_axes=(0, 0, 0, 0, 0, None, 0, 0))
    finalize = jax.vmap(_free(move_j, "finalize"),
                        in_axes=(0,) * 10 + (None,))
    body_t = make_sweep_fn(s_t, params_t, kv, kwt, "cpu", torch.float64,
                           species=sl)
    decisions, kinds = set(), set()
    for m, step in ((0, 3), (5, 4), (7, 9)):
        j = [jnp.asarray(x) for x in (com, quat, coords, boxes)]
        pr = propose(*j, keys, jnp.full(C, 0.6), jnp.full(C, 0.8), m, step)
        ra2p = jnp.concatenate([pr["ra_old"], pr["ra_new"]], axis=1)
        de_j, ovr_j = pair_rows(ra2p, pr["com_m"], pr["com_new"], j[0],
                                j[2], m, j[3], params_t.kappa_L / j[3])
        ref = finalize(*j, jnp.asarray(sfac), jnp.asarray(energy),
                       jnp.asarray(temp), pr, de_j, ovr_j, m)
        pr_t = {k: torch.tensor(np.asarray(v)) for k, v in pr.items()
                if k != "k_acc"}
        pr_t["u_acc"] = torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, dtype=jnp.float64))(
                pr["k_acc"])))
        t = [torch.tensor(x) for x in (com, quat, coords, boxes)]
        de_t, ovr_t = body_t.pair_energy_rows(
            torch.cat([pr_t["ra_old"], pr_t["ra_new"]], 1), pr_t["com_m"],
            pr_t["com_new"], t[0], t[2], m, t[3], params_t.kappa_L / t[3])
        np.testing.assert_allclose(de_t.numpy(), np.asarray(de_j),
                                   rtol=1e-10, atol=1e-9)
        np.testing.assert_array_equal(ovr_t.numpy(), np.asarray(ovr_j))
        out = body_t.finalize(*t, torch.tensor(sfac), torch.tensor(energy),
                              torch.tensor(temp), pr_t, de_t, ovr_t, m)
        for name, o, r in zip(("com", "quat", "coords", "sfac", "energy",
                               "is_trans", "accept"), out, ref):
            if o.dtype == torch.bool:
                np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                              err_msg=name)
            else:
                np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                           rtol=1e-10, atol=1e-10,
                                           err_msg=name)
        decisions |= set(out[6].tolist())
        kinds |= set(out[5].tolist())
    assert decisions == {True, False} and kinds == {True, False}


def test_kernel_branch_at_r8_matches_jax_interpret_route():
    """The JAX per-move Pallas route (interpreted) and the port's kernel
    branch (delta_energy's plain version: 2P = 8 rows, no padding rows)
    take the same proposals to the same state, float32."""
    C, box = 8, 9.5
    s_t, s_j = water_t.tip4p2005_system(8), water_j.tip4p2005_system(8)
    params_t = RunParams(**SEAM_PARAMS)
    kv, kwt = make_kvectors(3, 9)
    com, quat, coords, atoms = _chains(s_t, C, box, seed=6,
                                       dtype=np.float32)
    sfac = energy_t.energy_breakdown(
        s_t, params_t, torch.tensor(atoms), torch.tensor(com).double(),
        torch.full((C,), box, dtype=torch.float64), kv,
        kwt)["sfac"].float().numpy()
    f32 = np.float32
    st = SimStateJ(
        com=jnp.asarray(com), quat=jnp.asarray(quat),
        coords=jnp.asarray(coords), box=jnp.full(C, box, f32),
        sfac=jnp.asarray(sfac), energy=jnp.zeros(C, f32),
        virial=jnp.zeros(C, f32),
        key=jax.random.split(jax.random.PRNGKey(4), C),
        temp=jnp.full(C, 300.0, f32), step=jnp.asarray(0, jnp.int32),
        dr_max=jnp.full(C, 0.6, f32), dphi_max=jnp.full(C, 0.8, f32),
        dv_max=jnp.full(C, 0.05, f32), acc=jnp.zeros((C, 3), jnp.int32),
        att=jnp.zeros((C, 3), jnp.int32),
        nbr=jnp.zeros((C, 1, 1), jnp.int32),
        nbr_needed=jnp.zeros(C, jnp.int32))
    (sl,) = s_t.species_slices
    body_j = make_sweep_j(s_j, RunParamsJ(**SEAM_PARAMS), kv, kwt,
                          dtype=jnp.float32, pallas_mode="interpret",
                          species=sl)
    vprop = _free(body_j, "vprop")
    body_t = make_sweep_fn(s_t, params_t, kv, kwt, "cpu", torch.float32,
                           use_kernel=True, species=sl)
    assert body_t.n_rows == 8
    accepts = set()
    for m in (0, 7):
        pr = vprop(st.com, st.quat, st.coords, st.box, st.key, st.dr_max,
                   st.dphi_max, m, st.step)
        pr_t = {k: torch.tensor(np.asarray(v)) for k, v in pr.items()
                if k != "k_acc"}
        pr_t["u_acc"] = torch.tensor(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, dtype=jnp.float32))(
                pr["k_acc"])))
        t = {k: torch.tensor(np.asarray(getattr(st, k)))
             for k in ("com", "quat", "coords", "box", "sfac", "energy",
                       "temp")}
        d_e, ovr = body_t.kernel_delta(pr_t, t["coords"], t["box"], m)
        out = body_t.finalize(t["com"], t["quat"], t["coords"], t["box"],
                              t["sfac"], t["energy"], t["temp"], pr_t, d_e,
                              ovr, m)
        st, _ = body_j(st, m)
        for name, o in zip(("com", "quat", "coords", "sfac", "energy"), out):
            r = np.asarray(getattr(st, name))
            np.testing.assert_allclose(
                o.numpy(), r, rtol=1e-4,
                atol=1e-4 * max(1.0, float(np.abs(r).max())),
                err_msg=f"{name} m={m}")
        accepts |= set(out[6].tolist())
    assert True in accepts


# ---------------- the whole-sweep twin ---------------------------------


@pytest.mark.parametrize("p_translate", [0.5, 0.0])
def test_sweep_plain_at_p4_takes_jax_interpret_decisions(p_translate):
    C, n, box, sweeps = 4, 8, 12.0, 2
    kw = dict(temperature=300.0, r_cut=5.0, coulomb="ewald", nk=3,
              ksq_max=9, p_translate=p_translate, dr_max=0.3, dphi_max=0.4)
    s_t, s_j = water_t.tip4p2005_system(n), water_j.tip4p2005_system(n)
    params = RunParams(**kw)
    kv, kwt = make_kvectors(3, 9)
    com, quat, coords, atoms = _chains(s_t, C, box, seed=11,
                                       dtype=np.float32)
    ref0 = energy_t.energy_breakdown(
        s_t, params, torch.tensor(atoms), torch.tensor(com).double(),
        torch.full((C,), box, dtype=torch.float64), kv, kwt)
    f32 = np.float32
    s = dict(com=com, quat=quat, coords=coords, box=np.full(C, box, f32),
             sfac=ref0["sfac"].numpy().astype(f32),
             energy=ref0["total"].numpy().astype(f32),
             virial=np.zeros(C, f32), temp=np.full(C, 300.0, f32),
             step=np.asarray(0, np.int32), dr_max=np.full(C, 0.3, f32),
             dphi_max=np.full(C, 0.4, f32), dv_max=np.full(C, 0.05, f32),
             acc=np.zeros((C, 3), np.int32), att=np.zeros((C, 3), np.int32),
             nbr=np.zeros((C, 1, 1), np.int32),
             nbr_needed=np.zeros(C, np.int32))
    sweep_j = make_mega_sweep_fn(s_j, RunParamsJ(**kw), kv, kwt,
                                 interpret=True)
    st = SimStateJ(key=jnp.zeros((C, 2), jnp.uint32),
                   **{k: jnp.asarray(v) for k, v in s.items()})
    for _ in range(sweeps):
        st = sweep_j(st)

    (tables,) = sweep_tables(s_t, params, kv, kwt, "cpu")
    assert tables.P == 4
    t = {k: torch.tensor(v) for k, v in s.items()}
    x, c, q, sf, e = (t["coords"], t["com"], t["quat"], t["sfac"],
                      t["energy"])
    acc = torch.zeros((C, 2), dtype=torch.int64)
    att = torch.zeros_like(acc)
    for _ in range(sweeps):
        x, c, q, sf, stats = sweep_op.sweep_plain(
            x, c, q, sf, t["box"], t["temp"], t["dr_max"], t["dphi_max"],
            torch.zeros((C, n, sweep_op.N_UNIFORMS)), tables)
        e = e + stats[:, 0]
        acc += stats[:, 1:3].long()
        att += stats[:, 3:5].long()
    np.testing.assert_array_equal(acc.numpy(), np.asarray(st.acc)[:, :2])
    np.testing.assert_array_equal(att.numpy(), np.asarray(st.att)[:, :2])
    assert int(att[:, 0 if p_translate > 0 else 1].sum()) == C * n * sweeps
    assert int(acc.sum()) > 0
    np.testing.assert_allclose(c.numpy(), np.asarray(st.com), atol=1e-5)
    np.testing.assert_allclose(e.numpy(), np.asarray(st.energy), rtol=2e-4)
    dense = energy_t.energy_breakdown(
        s_t, params, x[:, :, :s_t.n_atoms].transpose(1, 2).double(),
        c.double(), t["box"].double(), kv, kwt)["total"].numpy()
    rel = np.abs(dense - e.numpy()) / np.maximum(np.abs(dense), 1.0)
    assert rel.max() < 2e-4, rel


# ---------------- drift --------------------------------------------------


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_nvt_drift_with_rotations(name):
    """float64 on the plain route: carried energy against the recompute
    through translations and rotations (a rotation moves the charged M
    site); the float32 whole-sweep route within the kernels' 2e-3."""
    build_t = VARIANTS[name][0]
    n = 27 if name == "tip4p2005" else 8
    box = 14.0 if n == 27 else 13.0
    params = RunParams(strict_min_image=False, temperature=300.0,
                       r_cut=6.0, coulomb="ewald", p_translate=0.5,
                       dr_max=0.3, dphi_max=0.4)
    mc = MonteCarlo(build_t(n), params, device="cpu", dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    assert mc.route == "plain"
    state = mc.init_state(cubic_lattice(n, box), box=box, n_chains=4)
    state, stats = mc.run_block(state, 8)
    assert stats["drift_max_rel"] < 1e-10, stats
    assert stats["acc_rot"] > 0.0 and stats["acc_trans"] > 0.0
    mc = MonteCarlo(build_t(n), params, device="cpu",
                    generator=torch.Generator().manual_seed(2))
    assert mc.route == "sweep"
    state = mc.init_state(cubic_lattice(n, box), box=box, n_chains=4)
    state, stats = mc.run_block(state, 3)
    assert stats["drift_max_rel"] < 2e-3, stats
    assert stats["acc_rot"] > 0.0
