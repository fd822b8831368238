"""The frozen roofline copy against chip_smoke.py's arithmetic on the
same shapes: the operations agree; the bytes differ only by the padded
width, which the copy does not count (chip_smoke's own width arguments
set to the real atoms make them equal)."""

import copy
import sys
from pathlib import Path

import pytest
import torch

from benchmark import roofline, spec

from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models import water
from metropolismontecarlo_tpu_torch.models.system import RunParams
from metropolismontecarlo_tpu_torch.mc.moves import sweep_tables
from metropolismontecarlo_tpu_torch.ops.ewald import make_kvectors

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("config_name", ["spce750_ewald", "tip4p2005_750"])
def test_sweep_bound_matches_chip_smoke(config_name):
    cfg = copy.deepcopy(spec.config(config_name))
    p = cfg["params"]
    n_mol, box, r_cut = 64, 12.42, 5.5
    params = RunParams(temperature=cfg["temperature"], r_cut=r_cut,
                       coulomb="ewald", kappa_L=p["kappa_L"], nk=p["nk"],
                       ksq_max=p["ksq_max"], dr_max=0.3, dphi_max=0.3)
    system = getattr(water, cfg["model"]["builder"])(n_mol)
    mc = MonteCarlo(system, params, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    st = mc.init_state(cubic_lattice(n_mol, box), box=box, n_chains=4)
    frac, near = 0.3, 0.6
    want, by = chip_smoke.sweep_bound(system, mc.tables, st, frac, [near],
                                      A_plane=system.n_atoms)
    blk = roofline.block_of(cfg["model"], n_mol, {"coulomb": "ewald",
                                                  "nk": p["nk"]})
    got, by2 = roofline.sweep_bound([blk], 4, st.sfac.shape[1], frac,
                                    [near])
    assert got == pytest.approx(want, rel=1e-12) and by == by2
    padded, _ = chip_smoke.sweep_bound(system, mc.tables, st, frac, [near])
    assert padded >= got


def test_gibbs_bound_matches_chip_smoke():
    cfg = spec.config("gibbs_spce128")
    p = cfg["params"]
    params = RunParams(temperature=450.0, r_cut=7.0, coulomb="ewald",
                       kappa_L=p["kappa_L"], nk=p["nk"],
                       ksq_max=p["ksq_max"], use_lrc=False)
    system = water.spce_system(128)
    kv, kw = make_kvectors(p["nk"], p["ksq_max"])
    (t,) = sweep_tables(system, params, kv, kw, "cpu")
    n_box = torch.tensor([[85, 21], [80, 26], [90, 16]])
    args = (3, len(kv), n_box, [0.2, 0.05], [0.5, 0.3], 110)
    want, by = chip_smoke.gibbs_bound(t, args[0], 128 * 3, 128, *args[1:])
    blk = roofline.block_of(cfg["model"], 128, p)
    got, by2 = roofline.gibbs_bound(blk, *args)
    assert got == pytest.approx(want, rel=1e-12) and by == by2


def test_fractions_match_chip_smoke():
    cfg = spec.config("spce750_ewald")
    params = RunParams(temperature=298.15, r_cut=5.5, coulomb="ewald",
                       dr_max=0.3, dphi_max=0.3)
    system = water.spce_system(64)
    mc = MonteCarlo(system, params, device="cpu",
                    generator=torch.Generator().manual_seed(3))
    st = mc.init_state(cubic_lattice(64, 12.42), box=12.42, n_chains=5)
    st = mc.run_steps(st, 1)
    sites = st.coords[:, :, :192].transpose(1, 2).reshape(5, 64, 3, 3)
    f = roofline.cutoff_fraction(sites.double(), st.box.double(), 5.5)
    assert f == pytest.approx(chip_smoke._cutoff_fraction(system, st, 5.5),
                              rel=1e-6)
    r = roofline.reach_fraction(sites.double(), st.com.double(),
                                st.box.double(), 5.5)
    want = chip_smoke._reach_fraction(st.coords, st.com,
                                      system.atom_mol_slot[0], st.box, 5.5)
    assert r == pytest.approx(want[0], rel=1e-6)
    assert cfg["params"]["coulomb"] == "ewald"


def test_recompute_bound_counts_pairs_and_k_space():
    """Two boxes of two three-site molecules: each unordered site pair of
    different molecules a distance and, inside the cutoff, its terms;
    each molecule's S(k) row; each box's reciprocal sum."""
    blk = roofline.Block(P=3, M=2, n_lj=1, n_q=3, coulomb="ewald", nk=5)
    K, frac = 10, 0.5
    got = roofline.recompute_bound(blk, [(torch.tensor([2, 2]), frac)], K)
    pair = roofline.OPS_GEOMETRY + frac * (roofline.OPS_LJ / 9.0
                                           + roofline.OPS_COULOMB)
    ops = 2 * (9 * pair + 2 * roofline.k_pose_ops(K, 5, 3)
               + K * roofline.OPS_K_MOVE)
    assert got == roofline.bound(2 * 4 * (3 * 6 + 1 + 2 * K), ops)
