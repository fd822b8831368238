"""The plain reference against the port's own recomputes, in float64 on
the CPU at small sizes (tests may import the port; the reference may
not)."""

import copy

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference import rigid_ewald as ref

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.mc.gibbs_mol import MolGibbsEnsemble
from metropolismontecarlo_tpu_torch.models import water
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

F64 = ref.Precision("float64")


def _fixed_state(config_name, n_mol=64, box=12.42, r_cut=5.5, chains=3):
    cfg = copy.deepcopy(spec.config(config_name))
    p = cfg["params"]
    p["r_cut"] = r_cut
    params = RunParams(temperature=cfg["temperature"], r_cut=r_cut,
                       coulomb=p["coulomb"], kappa_L=p["kappa_L"],
                       nk=p["nk"], ksq_max=p["ksq_max"],
                       use_lrc=p["use_lrc"], dr_max=0.3, dphi_max=0.3)
    system = getattr(water, cfg["model"]["builder"])(n_mol)
    mc = MonteCarlo(system, params, device="cpu", dtype=torch.float64,
                    kernel="plain",
                    generator=torch.Generator().manual_seed(5))
    st = mc.init_state(cubic_lattice(n_mol, box), box=box, n_chains=chains)
    return cfg, mc, mc.run_steps(st, 2)


@pytest.mark.parametrize("config_name", ["spce750_ewald", "tip4p2005_750"])
def test_reference_matches_port_recompute(config_name):
    cfg, mc, st = _fixed_state(config_name)
    e, _, s = mc.full_energy(st)
    out = ref.evaluate(st.com, st.quat, st.box, None, cfg["model"],
                       cfg["params"], F64)
    A = mc.system.n_atoms
    sites = out["sites"].reshape(st.com.shape[0], A, 3)
    assert torch.allclose(sites, st.coords[:, :, :A].transpose(1, 2),
                          atol=1e-12)
    assert torch.allclose(out["energy"], e, rtol=1e-11, atol=1e-8)
    assert torch.allclose(out["sfac"], s, atol=1e-10)


def test_reference_matches_port_gibbs_boxes():
    cfg = copy.deepcopy(spec.config("gibbs_spce128"))
    p = cfg["params"]
    params = RunParams(temperature=cfg["temperature"], r_cut=4.4,
                       coulomb="ewald", kappa_L=p["kappa_L"], nk=p["nk"],
                       ksq_max=p["ksq_max"], use_lrc=False,
                       strict_min_image=False, p_volume=0.02)
    cfg["params"]["r_cut"] = 4.4
    g = MolGibbsEnsemble(water.spce_system(24), params, dv_max=0.03,
                         p_transfer=0.3, dtype=torch.float64, device="cpu",
                         generator=torch.Generator().manual_seed(2))
    st = g.init(boxes=(9.0, 11.0), n_init=(16, 4), n_chains=3)
    st = g.run_steps(st, 200)
    e, s = g.full_energy(st)
    out = ref.evaluate(st.com.reshape(6, 24, 3), st.quat.reshape(6, 24, 4),
                       st.box.reshape(6), st.active.reshape(6, 24),
                       cfg["model"], cfg["params"], F64)
    assert torch.allclose(out["energy"], e.reshape(6), rtol=1e-11,
                          atol=1e-8)
    assert torch.allclose(out["sfac"], s.reshape(6, -1, 2), atol=1e-10)


@pytest.mark.parametrize("config_name",
                         ["spce750_ewald", "tip4p2005_750", "gibbs_spce128"])
def test_config_states_the_port_model(config_name):
    """The constants a configuration file states are those of the port's
    builder, and its body frame is the port's."""
    cfg = spec.config(config_name)
    system = getattr(water, cfg["model"]["builder"])(4)
    sites = cfg["model"]["sites"]
    np.testing.assert_allclose(system.charges[0],
                               [s["charge"] for s in sites])
    np.testing.assert_allclose(system.masses[0], [s["mass"] for s in sites])
    np.testing.assert_allclose(system.body[0], ref.body_frame(cfg["model"]),
                               atol=1e-12)
    lj = [s for s in sites if s.get("epsilon", 0.0) > 0.0]
    assert len(lj) == 1
    assert system.eps_table[0, 0] == lj[0]["epsilon"]
    assert system.sig_table[0, 0] == lj[0]["sigma"]


@pytest.mark.parametrize("nk,ksq", [(5, 27), (8, 65)])
def test_kvector_order(nk, ksq):
    kv, kw = make_kvectors(nk, ksq)
    rv, rw = ref.kvectors(nk, ksq)
    np.testing.assert_array_equal(kv, rv)
    np.testing.assert_array_equal(kw, rw)


def test_tf32_control_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, 3.0])
    y = ref.Precision("tf32").r(x)
    assert y.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 3.0]
