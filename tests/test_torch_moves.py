"""The port's per-move route against the JAX package's.

* delta_energy_plain against delta_energy_pallas run by the TPU
  interpreter, for every Coulomb style, at C = 8 chains and A_pad = 256
  lanes: e_lj within rtol 1e-5 per row, ovr equal, and e_coul, whose
  row sums cancel between charge signs, against a float64 evaluation
  relative to the sum of the row's term magnitudes: the port within
  1e-6, the Pallas kernel (a rational erfc fit evaluated in f32) within
  3e-5.
* The proposal seam: the JAX propose_full's proposals go into the
  port's pair_energy_rows and finalize (the plain branch), in float64,
  for site/com/first cutoffs x none/linear LJ shift x ewald/wolf/bare,
  and for the Ewald surface term: d_e within rtol 1e-9, accept equal,
  the new state within 1e-9.
* The kernel branch (the delta-energy op, here its plain version) fed
  the JAX interpreted-Pallas route's proposals gives that route's state.
* On the CPU the per-move and whole-sweep routes follow one trajectory
  on one set of uniforms.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc.moves import make_sweep_fn as make_sweep_j
from metropolismontecarlo_tpu.models import linear as linear_j
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.models.system import SimState as SimStateJ
from metropolismontecarlo_tpu.ops.ewald import make_kvectors
from metropolismontecarlo_tpu.ops.pallas.delta_energy import (
    delta_energy_pallas,
)
from metropolismontecarlo_tpu.ops.quaternions import quat_to_rot
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo, choose_route
from metropolismontecarlo_tpu_torch.mc.moves import (
    check_mega_supported,
    make_sweep_fn,
    mega_supported,
)
from metropolismontecarlo_tpu_torch.models import linear as linear_t
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import spce_methane_system
from metropolismontecarlo_tpu_torch.ops.cuda import delta_energy as delta_op

COULOMB = {"ewald": dict(coulomb="ewald"), "wolf": dict(coulomb="wolf"),
           "wolf_ref": dict(coulomb="wolf", wolf_style="ref"),
           "bare": dict(coulomb="bare"), "none": dict(coulomb="none")}


def _free(fn, name):
    """A closure variable of fn (the JAX move builders keep propose_full,
    pair_energy_rows and finalize as closures)."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


# ---------------- delta_energy ----------------------------------------


def _delta_inputs(coul):
    """C = 8 chains of the 80-molecule CO2/N2 mixture (A_pad 256), random
    atom planes, molecule m = 45 (an N2) moved; chain 0's first new row
    sits 0.3 A from an oppositely charged atom (an overlap)."""
    system = linear_t.co2_n2_system(40, 40)
    C, A, A_pad, box, m, P, R = 8, system.n_atoms, 256, 14.0, 45, 3, 8
    assert system.n_atoms_padded == A_pad
    rng = np.random.default_rng(9)
    coords = np.zeros((C, 3, A_pad), np.float32)
    coords[:, :, :A] = rng.uniform(0.0, box, (C, 3, A))
    rows = rng.uniform(0.0, box, (C, R, 3)).astype(np.float32)
    q_flat = system.flat(system.charges)
    j = int(np.flatnonzero(q_flat * system.charges[m, 0] < 0.0)[0])
    rows[0, P] = coords[0, :, j] + np.array([0.3, 0.0, 0.0], np.float32)
    tids, qs = system.type_ids[m], system.charges[m]
    et = np.asarray(system.eps_table, np.float32)
    st2 = np.asarray(system.sig_table, np.float32) ** 2
    T = et.shape[0]
    eps = np.zeros((R, 8), np.float32)   # JAX pads the type axis to 8
    sig2 = np.zeros((R, 8), np.float32)
    q8 = np.zeros(R, np.float32)
    for half in (0, P):
        eps[half:half + P, :T] = et[tids]
        sig2[half:half + P, :T] = st2[tids]
        q8[half:half + P] = qs
    has_lj = [bool(np.any(et[t] != 0.0)) for t in tids] * 2 + [False] * 2
    has_q = [bool(q != 0.0) for q in qs] * 2 + [False] * 2
    tid_row = np.full(A_pad, -1, np.int32)
    tid_row[:A] = system.flat(system.type_ids)
    q_row = np.zeros(A_pad, np.float32)
    q_row[:A] = q_flat
    params = RunParams(r_cut=5.0, qq_r_cut=6.0, kappa_L=5.6, **COULOMB[coul])
    return dict(coords=coords, rows=rows, box=np.full(C, box, np.float32),
                m=m, eps=eps, sig2=sig2, T=T, q8=q8, has_lj=has_lj,
                has_q=has_q, tid_row=tid_row,
                molid_row=system.mol_of_atom_padded.astype(np.int32),
                q_row=q_row, params=params)


def _kernel_coulomb(p):
    return "wolf_ref" if p.coulomb == "wolf" and p.wolf_style != "pairwise" \
        else p.coulomb


def _delta_port(d, fn):
    coords = torch.tensor(d["coords"])
    rows = torch.tensor(d["rows"])
    p, T = d["params"], d["T"]
    dp = delta_op.DeltaParams(
        coulomb=_kernel_coulomb(p), rc2=p.r_cut ** 2, qrc2=p.qq_cut ** 2,
        kappa_l=p.kappa_L, d2_overlap=p.d2_overlap, wolf_rc=p.qq_cut)
    return fn(coords[:, 0], coords[:, 1], coords[:, 2],
              *(rows[..., k].contiguous() for k in range(3)),
              torch.tensor(d["box"]), d["m"],
              torch.tensor(d["eps"][:, :T]).contiguous(),
              torch.tensor(d["sig2"][:, :T]).contiguous(),
              torch.tensor(d["q8"]),
              torch.tensor(d["has_lj"], dtype=torch.int32),
              torch.tensor(d["has_q"], dtype=torch.int32),
              torch.tensor(d["tid_row"]), torch.tensor(d["molid_row"]),
              torch.tensor(d["q_row"]), dp)


@pytest.mark.parametrize("coul", sorted(COULOMB))
def test_delta_energy_plain_matches_jax_interpret(coul):
    d = _delta_inputs(coul)
    p = d["params"]
    c = d["coords"]
    ref = delta_energy_pallas(
        jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]), jnp.asarray(c[:, 2]),
        *(jnp.asarray(d["rows"][..., k]) for k in range(3)),
        jnp.asarray(d["box"]), jnp.asarray(d["m"], jnp.int32),
        jnp.asarray(d["eps"]), jnp.asarray(d["sig2"]), jnp.asarray(d["q8"]),
        jnp.asarray(d["tid_row"], jnp.float32),
        jnp.asarray(d["molid_row"], jnp.float32), jnp.asarray(d["q_row"]),
        coulomb=_kernel_coulomb(p), n_types=d["T"], n_used=6,
        row_has_lj=tuple(d["has_lj"]), row_has_q=tuple(d["has_q"]),
        d2_overlap=p.d2_overlap, kappa_l=p.kappa_L, rc2=p.r_cut ** 2,
        qrc2=p.qq_cut ** 2, wolf_rc=p.qq_cut, interpret=True)
    out = _delta_port(d, delta_op.delta_energy_plain)
    e_lj, e_coul, ovr = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(out[0].numpy(), e_lj, rtol=1e-5)
    # a row's Coulomb sum cancels between charge signs, so errors are
    # held against the sum of its terms' magnitudes (the rows with |q|),
    # and against a float64 evaluation: the Pallas kernel's rational erfc
    # is 1.7e-5 of that off it here, the port's f32 plain 1.8e-7
    d64 = {k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32
           else v for k, v in d.items()}
    e64 = _delta_port(d64, delta_op.delta_energy_plain)[1].numpy()
    scale = _delta_port(dict(d64, q8=np.abs(d64["q8"]),
                             q_row=np.abs(d64["q_row"])),
                        delta_op.delta_energy_plain)[1].numpy()
    assert np.all(np.abs(out[1].numpy() - e64) <= 1e-6 * scale)
    assert np.all(np.abs(e_coul - e64) <= 3e-5 * scale)
    np.testing.assert_array_equal(out[2].numpy(), ovr)
    assert np.abs(e_lj[:, np.flatnonzero(d["has_lj"])]).min() > 0.0
    if coul != "none":
        assert ovr[0, 3] >= 1.0
        assert np.abs(e_coul[:, np.flatnonzero(d["has_q"])]).min() > 0.0


def test_delta_energy_wrapper_runs_plain_on_cpu_without_counting():
    d = _delta_inputs("ewald")
    before = delta_op.delta_energy.launches
    got = _delta_port(d, delta_op.delta_energy)
    want = _delta_port(d, delta_op.delta_energy_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert delta_op.delta_energy.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rows", "stride", "device"])
def test_delta_energy_wrapper_rejects_bad_inputs(bad):
    d = _delta_inputs("wolf")
    if bad == "dtype":
        d["q_row"] = d["q_row"].astype(np.float64)
    elif bad == "rows":
        d["rows"] = d["rows"][:, :6]
    elif bad == "stride":
        d["coords"] = np.ascontiguousarray(d["coords"][:, :, ::2])
    fn = delta_op.delta_energy
    if bad == "device":
        def fn(*args):
            return delta_op.delta_energy(
                *(a.to("meta") if isinstance(a, torch.Tensor) else a
                  for a in args))
    with pytest.raises(ValueError):
        _delta_port(d, fn)


# ---------------- the proposal seam -----------------------------------

SEAM_CASES = [(cut, shift, coul) for cut in ("site", "com", "first")
              for shift in ("none", "linear")
              for coul in ("ewald", "wolf", "bare")] \
    + [("site", "none", "ewald_surface")]


def _chain_state(system, C, box, seed, dtype):
    """C rigid configurations (numpy) on a jittered lattice with random
    orientations: com, quat, coords (C, 3, A_pad)."""
    rng = np.random.default_rng(seed)
    M = system.n_mol
    com = cubic_lattice(M, box) + rng.uniform(-0.4, 0.4, (C, M, 3))
    q = rng.normal(size=(C, M, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.asarray(quat_to_rot(jnp.asarray(q)))
    per_mol = com[:, :, None, :] + np.einsum("cmij,mpj->cmpi", rot,
                                             np.asarray(system.body))
    mol, slot = system.atom_mol_slot
    coords = np.zeros((C, 3, system.n_atoms_padded))
    coords[:, :, :system.n_atoms] = per_mol[:, mol, slot].transpose(0, 2, 1)
    return com.astype(dtype), q.astype(dtype), coords.astype(dtype)


@pytest.mark.parametrize("cut,shift,coul", SEAM_CASES)
def test_finalize_matches_jax_jnp_route_on_jax_proposals(cut, shift, coul):
    C, box = 6, 10.0
    kw = dict(temperature=100.0, r_cut=4.5, cutoff_mode=cut,
              lj_shift=shift, coulomb="ewald" if coul == "ewald_surface"
              else coul, ewald_surface=coul == "ewald_surface", nk=3,
              ksq_max=10, p_translate=0.5, dr_max=1.0, dphi_max=0.8,
              strict_min_image=False)
    sys_t, sys_j = linear_t.co2_n2_system(4, 4), linear_j.co2_n2_system(4, 4)
    params_t = RunParams(**kw)
    kv, kwt = make_kvectors(3, 10)
    com, quat, coords = _chain_state(sys_t, C, box, seed=len(cut + coul),
                                     dtype=np.float64)
    sfac = energy_breakdown(
        sys_t, params_t,
        torch.tensor(coords[:, :, :sys_t.n_atoms]).transpose(1, 2),
        torch.tensor(com), torch.full((C,), box, dtype=torch.float64), kv,
        kwt)["sfac"].numpy()
    boxes = np.full(C, box)
    energy = np.full(C, -100.0)
    temp = np.full(C, params_t.temperature)
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    decisions = set()
    for sl in sys_t.species_slices:
        body_j = make_sweep_j(sys_j, RunParamsJ(**kw), kv, kwt,
                              dtype=jnp.float64, species=sl)
        move_j = _free(body_j, "vmove").__wrapped__
        propose = jax.vmap(_free(move_j, "propose_full"),
                           in_axes=(0,) * 7 + (None, None))
        pair_rows = jax.vmap(_free(move_j, "pair_energy_rows"),
                             in_axes=(0, 0, 0, 0, 0, None, 0, 0))
        finalize = jax.vmap(_free(move_j, "finalize"),
                            in_axes=(0,) * 10 + (None,))
        body_t = make_sweep_fn(sys_t, params_t, kv, kwt, "cpu",
                               torch.float64, species=sl)
        for m in (sl[1], sl[2] - 1):
            j = [jnp.asarray(x) for x in (com, quat, coords, boxes)]
            pr = propose(*j, keys, jnp.full(C, 1.0), jnp.full(C, 0.8), m, 3)
            first = cut == "first"
            key_old = pr["ra_old"][:, 0] if first else pr["com_m"]
            key_new = pr["ra_new"][:, 0] if first else pr["com_new"]
            ra2p = jnp.concatenate([pr["ra_old"], pr["ra_new"]], axis=1)
            kappa = params_t.kappa_L / j[3]
            de_j, ovr_j = pair_rows(ra2p, key_old, key_new, j[0], j[2], m,
                                    j[3], kappa)
            ref = finalize(*j, jnp.asarray(sfac), jnp.asarray(energy),
                           jnp.asarray(temp), pr, de_j, ovr_j, m)

            pr_t = {k: torch.tensor(np.asarray(v)) for k, v in pr.items()
                    if k != "k_acc"}
            pr_t["u_acc"] = torch.tensor(np.asarray(jax.vmap(
                lambda k: jax.random.uniform(k, dtype=jnp.float64))(
                    pr["k_acc"])))
            t = [torch.tensor(x) for x in (com, quat, coords, boxes)]
            de_t, ovr_t = body_t.pair_energy_rows(
                torch.cat([pr_t["ra_old"], pr_t["ra_new"]], 1),
                torch.tensor(np.asarray(key_old)),
                torch.tensor(np.asarray(key_new)), t[0], t[2], m, t[3],
                params_t.kappa_L / t[3])
            np.testing.assert_allclose(de_t.numpy(), np.asarray(de_j),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_array_equal(ovr_t.numpy(), np.asarray(ovr_j))
            out = body_t.finalize(*t[:4], torch.tensor(sfac),
                                  torch.tensor(energy), torch.tensor(temp),
                                  pr_t, de_t, ovr_t, m)
            for name, o, r in zip(("com", "quat", "coords", "sfac",
                                   "energy", "is_trans", "accept"), out,
                                  ref):
                if o.dtype == torch.bool:
                    np.testing.assert_array_equal(o.numpy(), np.asarray(r),
                                                  err_msg=name)
                else:
                    np.testing.assert_allclose(o.numpy(), np.asarray(r),
                                               rtol=1e-9, atol=1e-9,
                                               err_msg=name)
            decisions |= set(out[6].tolist())
    assert decisions == {True, False}


def test_kernel_branch_matches_jax_interpret_route():
    """The JAX per-move Pallas route (interpreted) and the port's kernel
    branch (the delta-energy op's plain version on the CPU) take the same
    proposals to the same state, f32."""
    C, box = 8, 10.0
    kw = dict(temperature=100.0, r_cut=4.5, coulomb="ewald", nk=3,
              ksq_max=10, p_translate=0.5, dr_max=1.0, dphi_max=0.8,
              strict_min_image=False)
    sys_t, sys_j = linear_t.co2_n2_system(4, 4), linear_j.co2_n2_system(4, 4)
    params_t = RunParams(**kw)
    kv, kwt = make_kvectors(3, 10)
    com, quat, coords = _chain_state(sys_t, C, box, seed=3,
                                     dtype=np.float32)
    sfac = energy_breakdown(
        sys_t, params_t,
        torch.tensor(coords[:, :, :sys_t.n_atoms]).transpose(1, 2).double(),
        torch.tensor(com).double(), torch.full((C,), box,
                                               dtype=torch.float64), kv,
        kwt)["sfac"].float().numpy()
    f32 = np.float32
    st = SimStateJ(
        com=jnp.asarray(com), quat=jnp.asarray(quat),
        coords=jnp.asarray(coords), box=jnp.full(C, box, f32),
        sfac=jnp.asarray(sfac), energy=jnp.zeros(C, f32),
        virial=jnp.zeros(C, f32), key=jax.random.split(
            jax.random.PRNGKey(4), C),
        temp=jnp.full(C, 100.0, f32), step=jnp.asarray(0, jnp.int32),
        dr_max=jnp.full(C, 1.0, f32), dphi_max=jnp.full(C, 0.8, f32),
        dv_max=jnp.full(C, 0.05, f32), acc=jnp.zeros((C, 3), jnp.int32),
        att=jnp.zeros((C, 3), jnp.int32), nbr=jnp.zeros((C, 1, 1),
                                                        jnp.int32),
        nbr_needed=jnp.zeros(C, jnp.int32))
    accepts = set()
    for sl in sys_t.species_slices:
        body_j = make_sweep_j(sys_j, RunParamsJ(**kw), kv, kwt,
                              dtype=jnp.float32, pallas_mode="interpret",
                              species=sl)
        vprop = _free(body_j, "vprop")
        body_t = make_sweep_fn(sys_t, params_t, kv, kwt, "cpu",
                               torch.float32, use_kernel=True, species=sl)
        for m in (sl[1], sl[2] - 1):
            pr = vprop(st.com, st.quat, st.coords, st.box, st.key,
                       st.dr_max, st.dphi_max, m, st.step)
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
                                  t["sfac"], t["energy"], t["temp"], pr_t,
                                  d_e, ovr, m)
            st, _ = body_j(st, m)
            for name, o in zip(("com", "quat", "coords", "sfac", "energy"),
                               out):
                r = np.asarray(getattr(st, name))
                np.testing.assert_allclose(
                    o.numpy(), r, rtol=1e-4,
                    atol=1e-4 * max(1.0, float(np.abs(r).max())),
                    err_msg=f"{name} m={m}")
            accepts |= set(out[6].tolist())
    assert accepts == {True, False}


# ---------------- routes ----------------------------------------------


@pytest.mark.parametrize("name", ["co2_n2", "ragged"])
def test_move_and_sweep_routes_share_a_trajectory(name):
    """Same generator seed, same start: the per-move route (delta-energy
    op) and the whole-sweep route (one call per species block) take the
    same decisions, f32 on the CPU."""
    system = linear_t.co2_n2_system(16, 16) if name == "co2_n2" \
        else spce_methane_system(16, 16)
    params = RunParams(temperature=240.0, r_cut=5.0, coulomb="ewald", nk=3,
                       ksq_max=9, dr_max=0.3, dphi_max=0.3)
    runs = {}
    for route in ("sweep", "move"):
        mc = MonteCarlo(system, params, device="cpu", kernel=route,
                        generator=torch.Generator().manual_seed(3))
        assert mc.route == route
        state = mc.init_state(cubic_lattice(32, 13.0), box=13.0, n_chains=4)
        runs[route] = mc.run_block(state, 3)
    (s_s, m_s), (s_m, m_m) = runs["sweep"], runs["move"]
    np.testing.assert_array_equal(s_m.acc.numpy(), s_s.acc.numpy())
    assert int(s_m.step) == int(s_s.step) == 3 * 32
    np.testing.assert_allclose(s_m.com.numpy(), s_s.com.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(s_m.energy.numpy(), s_s.energy.numpy(),
                               rtol=1e-5)
    assert m_m["drift_max_rel"] < 1e-4 and m_s["drift_max_rel"] < 1e-4
    assert 0.05 < m_m["acc_trans"] < 0.95


def test_route_choice():
    mix = linear_t.co2_n2_system(4, 4)
    one_block = dataclasses.replace(mix, species=None)
    f32, f64 = torch.float32, torch.float64
    site = RunParams(coulomb="ewald")
    assert choose_route(mix, site, f32, "auto") == "sweep"
    assert choose_route(one_block, site, f32, "auto") == "move"
    assert choose_route(one_block, RunParams(lj_shift="linear"), f32,
                        "auto") == "plain"
    assert choose_route(mix, RunParams(cutoff_mode="com"), f32,
                        "auto") == "plain"
    assert choose_route(mix, RunParams(ewald_surface=True), f32,
                        "auto") == "plain"
    assert choose_route(mix, site, f64, "auto") == "plain"
    assert choose_route(mix, site, f32, "move") == "move"
    assert choose_route(mix, site, f32, "plain") == "plain"
    for system, params, dtype, kernel in (
            (one_block, site, f32, "sweep"), (mix, site, f64, "sweep"),
            (mix, RunParams(cutoff_mode="first"), f32, "move"),
            (mix, site, f64, "move"), (mix, site, f32, "tpu")):
        with pytest.raises(ValueError):
            choose_route(system, params, dtype, kernel)


@pytest.mark.parametrize("case", ["mixture", "one_block", "com", "first",
                                  "linear", "surface"])
def test_sweep_route_choice_and_refusal_agree(case):
    """choose_route's "sweep" and the whole-sweep route's own check accept
    and refuse the same configurations."""
    mix = linear_t.co2_n2_system(4, 4)
    system = dataclasses.replace(mix, species=None) if case == "one_block" \
        else mix
    params = RunParams(**{"com": dict(cutoff_mode="com"),
                          "first": dict(cutoff_mode="first"),
                          "linear": dict(lj_shift="linear"),
                          "surface": dict(ewald_surface=True)}.get(case, {}))
    ok = mega_supported(system, params, torch.float32)
    assert ok == (case in ("mixture", "linear"))
    if ok:
        assert choose_route(system, params, torch.float32, "sweep") == "sweep"
        check_mega_supported(system, params)
    else:
        with pytest.raises(ValueError):
            choose_route(system, params, torch.float32, "sweep")
        with pytest.raises(ValueError):
            check_mega_supported(system, params)


def test_plain_route_runs_float64():
    system = linear_t.co2_n2_system(8, 8)
    params = RunParams(temperature=240.0, r_cut=4.5, cutoff_mode="com",
                       coulomb="ewald", nk=3, ksq_max=9)
    mc = MonteCarlo(system, params, device="cpu", dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    assert mc.route == "plain"
    state = mc.init_state(cubic_lattice(16, 10.0), box=10.0, n_chains=2)
    state, m = mc.run_block(state, 2)
    assert state.com.dtype == torch.float64
    assert int(state.att.sum()) == 2 * 2 * 16
    assert m["drift_max_rel"] < 1e-10


def test_monte_carlo_defaults_to_the_card():
    """No device argument means the GPU: without one it raises, never
    falling back to the CPU."""
    system = linear_t.co2_n2_system(4, 4)
    if torch.cuda.is_available():
        assert MonteCarlo(system, RunParams()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MonteCarlo(system, RunParams())
