"""The port's osmotic ensemble (mc/gcmc_osmotic.py) on the CPU, against the
JAX package.

* The plain route in float64 through its draw seam: the port's step fed
  the draws that the JAX step takes from its keys (reproduced with
  jax.random), against the JAX step itself (reached through the closures
  of its run_steps): decisions equal, state and energies to 1e-9 (charged
  SPC/E solvent and solute with Ewald and Rosenbluth exchanges; the ragged
  one-site LJ solvent + triatomic solute with the tail).
* mega="full" against JAX mega="interpret_full" and mega=True's sweep
  against JAX mega="interpret": the interpreter's PRNG returns zeros, so
  the port gets zero uniforms (every exchange an insertion at the origin).
* Ports of the JAX gates (tests/test_gcmc_osmotic.py): the recompute is
  the model energy; an ideal solute in an interacting solvent is Poisson;
  Henry's law against Widom insertions of the solute on an NVT run; the
  Ewald drift through solvent moves and solute exchanges; the masked RDF
  (equal to the plain RDF with every slot on; a finite solute-solvent
  g(r) near 1 at its largest r); every route's drift gate; the guards;
  the CLI end to end; the bridge and atom_mask.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu.mc import gcmc_osmotic as osm_j
from metropolismontecarlo_tpu.mc.gcmc_mol import (
    make_trial_quats as trial_quats_j,
)
from metropolismontecarlo_tpu.models.system import RunParams as RunParamsJ
from metropolismontecarlo_tpu.ops.quaternions import random_unit_vector
from metropolismontecarlo_tpu_torch import bridge
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc import gcmc_osmotic as osm_t
from metropolismontecarlo_tpu_torch.mc import moves as moves_t
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
from metropolismontecarlo_tpu_torch.models.energy import energy_breakdown
from metropolismontecarlo_tpu_torch.models.polyatomic import lj_trimer_blocks
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.models.water import (
    spce_system,
    spce_two_blocks,
)
from metropolismontecarlo_tpu_torch.observables import (
    MaskedRDFAccumulator,
    RDFAccumulator,
)
from metropolismontecarlo_tpu_torch.ops import ewald as ewald_t
from tests.test_gcmc_osmotic import lj_plus_trimer, water_plus_water

F32, F64 = torch.float32, torch.float64
C = 3
WATER = dict(strict_min_image=False, temperature=1000.0, r_cut=4.5,
             cutoff_mode="site", coulomb="ewald", use_lrc=False,
             p_translate=0.5, dr_max=1.0, dphi_max=0.7)
LJ = dict(strict_min_image=False, temperature=2.0, r_cut=2.5,
          cutoff_mode="site", coulomb="none", p_translate=0.5, dr_max=0.4,
          dphi_max=1.0, use_lrc=False)
KERNEL = dict(temperature=700.0, r_cut=4.5, cutoff_mode="site",
              coulomb="ewald", nk=3, ksq_max=9, p_translate=0.5, dr_max=0.25,
              dphi_max=0.3, use_lrc=False, strict_min_image=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free(fn, name):
    """The value a (jitted) function's closure binds to `name`."""
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _port(sys_j):
    """The port's System with the JAX System's fields."""
    return bridge.system_from_numpy(
        {f: getattr(sys_j, f) for f in sys_j.__dataclass_fields__})


def _to_port(st_j):
    return bridge.osmotic_state_from_numpy(
        {f: np.array(getattr(st_j, f)) for f in st_j._fields if f != "key"},
        "cpu")


def _assert_states_close(st_t, st_j, rtol=1e-9, atol=1e-9):
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)),
                                      err_msg=f)
    for f in ("com", "quat", "coords", "box", "sfac", "energy"):
        np.testing.assert_allclose(getattr(st_t, f).numpy(),
                                   np.asarray(getattr(st_j, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


def _jax_draws(keys, p_solute, n_or):
    """The draws of JAX's step from each chain's key, as the port's draw
    lays them out (torch, float64)."""
    f64 = jnp.float64
    tq = trial_quats_j(p_solute, f64)

    def one(key):
        _, k = jax.random.split(key)
        (k_move, k_sel, k_pos, k_rot, k_insq, k_delq, k_pick,
         k_acc) = jax.random.split(k, 8)
        kax, kang = jax.random.split(k_rot)
        u = lambda kk, shape=(): jax.random.uniform(kk, shape, f64)  # noqa
        return dict(
            u_move=u(k_move), u_sel=u(k_sel), u_pos=u(k_pos, (3,)),
            axis=random_unit_vector(kax, (), dtype=f64), u_rot=u(kang),
            quats_ins=tq(k_insq, n_or), quats_del=tq(k_delq, n_or - 1),
            u_pick=u(k_pick), u_acc=u(k_acc))

    return SimpleNamespace(**{k: torch.tensor(np.array(v)) for k, v in
                              jax.vmap(one)(keys).items()})


# (JAX system, params, box, n_init, activity, p_exchange, n_orient)
SEAM_CASES = {
    "spce-ewald-orient3": (lambda: water_plus_water(8, 6), WATER, 12.0, 3,
                           2e-3, 0.5, 3),
    "lj-trimer-lrc": (lambda: lj_plus_trimer(16, 10),
                      dict(LJ, use_lrc=True), 6.0, 4, 0.08, 0.5, 1),
}


@pytest.mark.parametrize("name", list(SEAM_CASES))
def test_plain_steps_and_full_energy_match_jax_f64(name):
    sys_j, kw, box, n_init, z, px, n_or = SEAM_CASES[name]
    g_j = osm_j.OsmoticGCMC(sys_j(), RunParamsJ(**kw), activity=z,
                            p_exchange=px, n_orient=n_or)
    st_j = g_j.init(jax.random.PRNGKey(5), box=box, n_init=n_init,
                    n_chains=C)
    run_chain = _free(g_j.run_steps, "_run_chain")
    step_j = jax.jit(jax.vmap(lambda *c: _free(run_chain, "_one_step")(
        c, None)[0]))
    g = osm_t.OsmoticGCMC(_port(sys_j()), RunParams(**kw), activity=z,
                          p_exchange=px, n_orient=n_or, device="cpu")
    st = _to_port(st_j)
    _assert_states_close(st, st_j)          # full_energy: the same model
    carry = tuple(st_j)
    p_solute = sys_j().species_slices[1][3]
    for _ in range(30):
        dr = _jax_draws(carry[7], p_solute, n_or)
        carry = step_j(*carry)
        st = g.run_steps.step(st, dr)
    st_j = osm_j.OsmoticState(*carry)
    _assert_states_close(st, st_j, rtol=1e-9, atol=1e-8)
    acc = st.acc.sum(0).tolist()
    assert acc[0] + acc[1] > 0 and acc[2] + acc[3] > 0, acc
    e_j, sf_j = g_j.full_energy(st_j)
    e, sf = g.full_energy(st)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_j), rtol=1e-10)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sf_j), rtol=1e-10,
                               atol=1e-10)


def test_full_energy_is_the_model_energy():
    """Every solute slot active: the recompute equals
    models/energy.energy_breakdown of the two-block system (Ewald), before
    and after a block of solvent and solute moves."""
    system = spce_two_blocks(6, 4)
    params = RunParams(temperature=400.0, r_cut=5.0, cutoff_mode="site",
                       coulomb="ewald", use_lrc=False, p_translate=0.5,
                       dr_max=0.5, dphi_max=0.5)
    g = osm_t.OsmoticGCMC(system, params, activity=1e-4, p_exchange=0.0,
                          device="cpu")
    st = g.init(box=12.0, n_init=4, n_chains=2)
    kv, kw = ewald_t.make_kvectors(params.nk, params.ksq_max)
    A = system.n_atoms

    def model(st):
        return energy_breakdown(system, params,
                                st.coords[:, :, :A].transpose(1, 2), st.com,
                                st.box, kv, kw)["total"]

    np.testing.assert_allclose(st.energy.numpy(), model(st).numpy(),
                               rtol=1e-9)
    st, stats = g.run_block(st, 100, drift_tol=1e-9)
    assert stats["acc_trans"] > 0.0 and stats["acc_rot"] > 0.0
    np.testing.assert_allclose(st.energy.numpy(), model(st).numpy(),
                               rtol=1e-9)


# ---------------- the kernel routes against the TPU interpreter ---------


def _zero_draws(monkeypatch):
    monkeypatch.setattr(moves_t, "draw_uniforms",
                        lambda c, m, gen, dev: torch.zeros((c, m, 10)))
    monkeypatch.setattr(moves_t, "draw_exchange_uniforms",
                        lambda c, n, gen, dev: torch.zeros((c, n, 8)))


def test_mega_full_matches_jax_interpret_full(monkeypatch):
    """The solute exchanges ride the solute block's launch only (n_exch =
    (0, x_per)), the solvent block a pure displacement sweep."""
    g_j = osm_j.OsmoticGCMC(water_plus_water(6, 6), RunParamsJ(**KERNEL),
                            activity=2e-4, p_exchange=0.4, dtype=jnp.float32,
                            mega="interpret_full")
    st_j = g_j.init(jax.random.PRNGKey(0), box=10.0, n_init=3, n_chains=2)
    _zero_draws(monkeypatch)
    g = osm_t.OsmoticGCMC(spce_two_blocks(6, 6), RunParams(**KERNEL),
                          activity=2e-4, p_exchange=0.4, dtype=F32,
                          mega="full", device="cpu")
    st = _to_port(st_j)
    e0 = st.energy.numpy().copy()
    st_j2 = g_j.run_steps(st_j, 40)
    st2 = g.run_steps(st, 40)
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(st2, f).numpy(),
                                      np.asarray(getattr(st_j2, f)),
                                      err_msg=f)
    att = st2.att.numpy()
    assert att[:, 0].sum() > 0 and att[:, 2:].sum() > 0
    assert st2.acc.numpy()[:, 2].sum() > 0           # an insertion landed
    d_t, d_j = st2.energy.numpy() - e0, np.asarray(st_j2.energy) - e0
    np.testing.assert_allclose(d_t, d_j, atol=2e-5 * np.abs(e0).max())
    ref = np.asarray(st_j2.sfac)
    np.testing.assert_allclose(st2.sfac.numpy(), ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(st2.coords.numpy(), np.asarray(st_j2.coords),
                               atol=1e-4)
    _, stats = g.run_block(st2, 0)
    assert stats["drift_max_rel"] < 2e-3 and stats["sfac_err_max"] < 1e-4


def test_mega_true_sweep_matches_jax_interpret(monkeypatch):
    """mega=True's kernel sweep (the solvent's activity all ones) against
    JAX's _sweep_state; the exchange steps after it are the plain route."""
    w = spce_system(12)
    from metropolismontecarlo_tpu.models.system import System as SystemJ
    sys_j = SystemJ(n_mol=12, atoms_per_mol=3, body=w.body, masses=w.masses,
                    charges=w.charges, type_ids=w.type_ids,
                    eps_table=w.eps_table, sig_table=w.sig_table,
                    name="osm-spce", species=(("solv", 8, 3),
                                              ("solu", 4, 3)))
    g_j = osm_j.OsmoticGCMC(sys_j, RunParamsJ(**KERNEL), activity=2e-4,
                            p_exchange=0.3, dtype=jnp.float32,
                            mega="interpret")
    st_j = g_j.init(jax.random.PRNGKey(0), box=10.0, n_init=2, n_chains=2)
    _zero_draws(monkeypatch)
    g = osm_t.OsmoticGCMC(_port(sys_j), RunParams(**KERNEL), activity=2e-4,
                          p_exchange=0.3, dtype=F32, mega=True, device="cpu")
    want = _free(g_j.run_steps, "_sweep_state")(st_j)
    got = g.run_steps.sweep(_to_port(st_j))
    for f in ("active", "acc", "att"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.acc[:, :2].sum()) > 0
    for f in ("com", "quat", "coords"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=2e-5, atol=1e-2)
    ref = np.asarray(want.sfac)
    np.testing.assert_allclose(got.sfac.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("system,kw,mega,dtype,tol", [
    (lambda: spce_two_blocks(6, 6), KERNEL, None, F64, 1e-9),
    (lambda: spce_two_blocks(6, 6), KERNEL, True, F32, 2e-3),
    (lambda: spce_two_blocks(6, 6), KERNEL, "full", F32, 2e-3),
    (lambda: lj_trimer_blocks(10, 6), dict(LJ, p_translate=0.7, dr_max=0.3,
                                           dphi_max=0.5), "full", F32, 2e-3),
])
def test_routes_keep_the_drift_and_sfac_gates(system, kw, mega, dtype, tol):
    """Every route (and the ragged widths in-kernel): carried energy and
    S(k) against the recompute; the solvent count never changes."""
    g = osm_t.OsmoticGCMC(system(), RunParams(**kw), activity=0.05
                          if kw["coulomb"] == "none" else 2e-4,
                          p_exchange=0.4, dtype=dtype, mega=mega,
                          device="cpu")
    st = g.init(box=10.0 if kw["coulomb"] != "none" else 7.0, n_init=3,
                n_chains=C)
    for _ in range(2):
        st, stats = g.run_block(st, 40, drift_tol=tol)
        assert stats["sfac_err_max"] < (1e-9 if dtype == F64 else 1e-4)
    assert int(st.att[:, 0].sum()) > 0 and int(st.att[:, 2:].sum()) > 0
    a0_solute = g._system.species_slices[1][4]
    assert bool(g.atom_mask(st)[:, :a0_solute].all())


# ---------------- physics gates -----------------------------------------


def test_ideal_solute_is_poisson():
    """A non-interacting solute in an interacting LJ solvent is Poisson(z
    V = 6.86): 128 chains, three blocks after 100 steps; the pooled mean's
    standard error is ~2% (gate 8%), the pooled variance's ~6% (gate
    25%)."""
    z, box = 0.02, 7.0
    system = _port(lj_plus_trimer(20, 24, eps_solute=0.0, eps_cross=0.0))
    g = osm_t.OsmoticGCMC(system, RunParams(**dict(LJ, temperature=1.5)),
                          activity=z, p_exchange=0.8, device="cpu")
    st = g.init(box=box, n_init=7, n_chains=128)
    st, _ = g.run_block(st, 100)
    means, varis = [], []
    for _ in range(3):
        st, stats = g.run_block(st, 80, drift_tol=1e-10)
        means.append(stats["n_mean"])
        varis.append(stats["n_var"])
        assert stats["full_frac"] == 0.0
    zv = z * box ** 3
    assert np.mean(means) == pytest.approx(zv, rel=0.08), means
    assert np.mean(varis) == pytest.approx(zv, rel=0.25), varis


def test_henry_law_matches_widom():
    """An interacting solute in an LJ solvent: beta mu_ex = ln(z / <rho_u>)
    from the osmotic run agrees with Widom insertions of the solute on a
    fixed-composition NVT run of the main driver (independent sampler and
    state layout) within 0.15, as JAX's gate."""
    z, box, t, ns = 0.08, 6.0, 3.0, 40
    params = RunParams(**dict(LJ, temperature=t))
    g = osm_t.OsmoticGCMC(_port(lj_plus_trimer(ns, 32)), params, activity=z,
                          p_exchange=0.4, n_orient=4, device="cpu")
    st = g.init(box=box, n_init=12, n_chains=24)
    st, _ = g.run_block(st, 300)
    n_means = []
    for _ in range(3):
        st, stats = g.run_block(st, 100, drift_tol=1e-10)
        n_means.append(stats["n_mean"])
        assert stats["full_frac"] == 0.0
    n_mean = float(np.mean(n_means))
    bmu_gcmc = np.log(z / (n_mean / box ** 3))

    n_u = int(round(n_mean))
    mc = MonteCarlo(_port(lj_plus_trimer(ns, n_u)), params, device="cpu",
                    generator=torch.Generator().manual_seed(3), dtype=F64,
                    kernel="plain", recompute_chunk=16)
    state = mc.init_state(cubic_lattice(ns + n_u, box), box=box, n_chains=24)
    state = mc.run_steps(state, 6)
    bsum = 0.0
    for _ in range(4):
        state = mc.run_steps(state, 2)
        w = mc.widom(state, n_insertions=128, species=1)
        bsum += float(w["boltzmann_mean"].mean()) / 4
    bmu_widom = -np.log(bsum)
    assert bmu_gcmc == pytest.approx(bmu_widom, abs=0.15), \
        (bmu_gcmc, bmu_widom, n_mean)


def test_water_ewald_drift_through_biased_exchanges():
    """Charged SPC/E solvent and solute: carried energy and S(k) exact
    through solvent moves and solute exchanges with orientational bias."""
    g = osm_t.OsmoticGCMC(spce_two_blocks(12, 15), RunParams(**dict(
        WATER, r_cut=8.0)), activity=2e-3, p_exchange=0.5, n_orient=4,
        device="cpu")
    st = g.init(box=20.0, n_init=6, n_chains=4)
    ins = dels = 0.0
    for _ in range(2):
        st, stats = g.run_block(st, 120, drift_tol=1e-9)
        assert stats["sfac_err_max"] < 1e-8, stats
        ins += stats["acc_insert"]
        dels += stats["acc_delete"]
    assert ins > 0.0 and dels > 0.0, (ins, dels)


def test_masked_rdf_equals_rdf_when_all_active():
    """MaskedRDFAccumulator with a full mask equals RDFAccumulator on an
    all-active molecular muVT state (same histogram, same
    normalization)."""
    system = spce_system(12)
    params = RunParams(strict_min_image=False, temperature=400.0, r_cut=5.0,
                       cutoff_mode="site", coulomb="ewald", use_lrc=False,
                       p_translate=0.5, dr_max=0.5, dphi_max=0.5)
    g = MolGCMC(system, params, activity=1e-4, p_exchange=0.0, device="cpu")
    st = g.init(box=12.0, n_init=12, n_chains=4)
    st, _ = g.run_block(st, 60)
    rdf = RDFAccumulator(system, 0, 0, r_max=5.0, n_bins=50)
    rdf.update(st)
    mrdf = MaskedRDFAccumulator(system, 0, 0, r_max=5.0, n_bins=50)
    mrdf.update(st.coords, st.box, g.atom_mask(st))
    np.testing.assert_allclose(mrdf.result()[1], rdf.result()[1],
                               rtol=1e-12)


def test_masked_rdf_solute_solvent():
    """Solute-solvent g(r) from an osmotic run: finite, non-negative, and
    near 1 (within (0.5, 2)) at its largest sampled r."""
    g = osm_t.OsmoticGCMC(_port(lj_plus_trimer(40, 48)), RunParams(**dict(
        LJ, temperature=3.0)), activity=0.08, p_exchange=0.4, device="cpu")
    st = g.init(box=6.0, n_init=8, n_chains=16)
    st, _ = g.run_block(st, 300)
    rdf = MaskedRDFAccumulator(g._system, 0, 1, r_max=2.8, n_bins=40)
    for _ in range(3):
        st, _ = g.run_block(st, 100, drift_tol=1e-10)
        rdf.update(st.coords, st.box, g.atom_mask(st))
    r, gr = rdf.result()
    assert np.isfinite(gr).all() and (gr >= 0.0).all()
    assert 0.5 < gr[r > 2.4].mean() < 2.0, gr


# ---------------- refusals, bookkeeping, the CLI ------------------------


def _charged_solute():
    s = spce_two_blocks(4, 4)
    q = np.array(s.charges)
    q[4:, 0] = -0.5
    return bridge.system_from_numpy(dict(
        n_mol=8, atoms_per_mol=3, body=s.body, masses=s.masses, charges=q,
        type_ids=s.type_ids, eps_table=s.eps_table, sig_table=s.sig_table,
        name="charged", species=s.species))


@pytest.mark.parametrize("system,kw,match", [
    (lambda: spce_system(8), {}, "two species"),
    (_charged_solute, {}, "charge-neutral"),
    (lambda: spce_two_blocks(4, 4), dict(mega=True, dtype=F64), "float32"),
    (lambda: spce_two_blocks(4, 4), dict(mega="interpret", dtype=F32),
     "mega must be"),
    (lambda: spce_two_blocks(4, 4), dict(mega="full", dtype=F32,
                                         n_orient=3), "unbiased"),
    (lambda: spce_two_blocks(4, 4), dict(mega="full", dtype=F32,
                                         p_exchange=0.0), "p_exchange"),
    (lambda: spce_two_blocks(4, 4), dict(mega=True, dtype=F32,
                                         p_exchange=1.0), "p_exchange"),
    (lambda: spce_two_blocks(4, 4), dict(n_orient=0), "n_orient"),
])
def test_make_gcmc_osmotic_guards(system, kw, match):
    with pytest.raises(ValueError, match=match):
        osm_t.make_gcmc_osmotic(system(), RunParams(**KERNEL), 1e-4,
                                device="cpu", **kw)


def test_init_guards_bridge_atom_mask_and_device():
    # the LJ tail is supported: building succeeds, in-kernel too
    osm_t.OsmoticGCMC(lj_trimer_blocks(8, 4), RunParams(**dict(
        LJ, use_lrc=True)), 0.05, dtype=F32, mega="full", device="cpu")
    system = spce_two_blocks(5, 3)
    g = osm_t.OsmoticGCMC(system, RunParams(**KERNEL), 1e-4, device="cpu")
    with pytest.raises(ValueError, match="exceeds solute capacity"):
        g.init(box=10.0, n_init=4, n_chains=2)
    g_strict = osm_t.OsmoticGCMC(system, RunParams(**dict(
        KERNEL, strict_min_image=True)), 1e-4, device="cpu")
    with pytest.raises(ValueError, match="minimum-image"):
        g_strict.init(box=8.0, n_init=1, n_chains=2)
    st = g.init(box=10.0, n_init=2, n_chains=2)
    mask = g.atom_mask(st)
    assert mask.shape == (2, system.n_atoms_padded)
    assert int(mask.sum()) == 2 * (5 + 2) * 3
    mol = np.array(system.mol_of_atom_padded)
    np.testing.assert_array_equal(mask[0].numpy(), (mol >= 0) & (mol < 7))
    arrays = bridge.osmotic_state_to_numpy(st)
    back = bridge.osmotic_state_from_numpy(arrays, "cpu")
    for f in arrays:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            osm_t.OsmoticGCMC(system, RunParams(**KERNEL), 1e-4)


def test_cli_osmotic_end_to_end(tmp_path, monkeypatch):
    """The port's CLI on `"kind": "osmotic"` with a two-block LJ + trimer
    model (the builder patched) writes, for every block, the keys the JAX
    CLI writes (JAX run_block's statistics, "density_mean", "block",
    "phase" and the logger's time "t"); "bias" is refused as JAX's CLI
    refuses it."""
    import metropolismontecarlo_tpu_torch.run as run_t
    import metropolismontecarlo_tpu_torch.utils.config as cfg_t

    params = dict(LJ, temperature=3.0)
    g_j = osm_j.OsmoticGCMC(lj_plus_trimer(20, 12), RunParamsJ(**params),
                            activity=0.08, p_exchange=0.4)
    _, stats_j = g_j.run_block(g_j.init(jax.random.PRNGKey(1), box=6.0,
                                        n_init=4, n_chains=2), 2)
    want = sorted(list(stats_j) + ["density_mean", "block", "phase", "t"])
    monkeypatch.setattr(cfg_t, "build_system",
                        lambda cfg, base_dir=".": _port(
                            lj_plus_trimer(20, 12)))
    ens = {"kind": "osmotic", "activity": 0.08, "box": 6.0, "n_init": 4,
           "p_exchange": 0.4}
    cfg = {"model": {"kind": "lj", "n_mol": 1}, "params": params,
           "run": {"n_chains": 4, "n_blocks": 2, "n_steps": 60, "seed": 1,
                   "dtype": "float64", "ensemble": ens,
                   "output": {"dir": str(tmp_path / "out")}}}
    path = tmp_path / "osm.json"
    path.write_text(json.dumps(cfg))
    run_t.main([str(path), "--quiet"], device="cpu")
    lines = [json.loads(ln) for ln in (tmp_path / "out" / "metrics.jsonl")
             .read_text().splitlines()]
    assert len(lines) == 2 and all(sorted(m) == want for m in lines)
    assert all(np.isfinite(m["density_mean"]) for m in lines)
    path.write_text(json.dumps(dict(cfg, run=dict(
        cfg["run"], ensemble=dict(ens, bias="cavity")))))
    with pytest.raises(ValueError, match="bias"):
        run_t.main([str(path), "--quiet"], device="cpu")
