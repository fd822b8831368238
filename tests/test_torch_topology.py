"""The port's topology front end (io/topology.py, models/from_topology.py,
the `topology` config kind, bench's mixture) against the JAX package's,
on files the tests write themselves (the reference's topol.top, mea.pdb
and tip3p.pdb are not in the repo): chip_smoke.write_topology_files, the
stand-in the card run reads too (TIP3P in an #include'd .itp with an
#ifdef FLEXIBLE ... #else [ settles ] #endif branch, TraPPE-UA CH4 as a
one-site MEA_DUMMY, comb-rule 2 and 3), and a second topology with the
other sections and directives.

* read_top: the port's FFTopology equals JAX's as plain data (every
  section, #include, #ifdef/#ifndef/#else/#endif with and without a
  define, #define, the two [atomtypes] layouts, [atoms] lines without
  charge and mass).
* system_from_topology / templates_from_pdbs: every System field equal
  to JAX's, float64 (tables, bodies, species, the ragged mol_p and
  mol_a0, the __pad__ type).
* Against the port's hand builders: the TIP3P block's charges, masses and
  O-O parameters equal tip3p_system's and the CH4 block's those of
  spce_methane_system within 1e-12 relative (the kJ/mol and nm round
  trip); bodies within the PDB's 1e-3 A.
* The `topology` CLI kind: a short float64 NVT run of the port and of the
  JAX CLI on the test-written files writes the same files and the same
  metrics keys; the two-species model runs the semigrand, osmotic and
  gibbs_binary ensembles through the port's CLI.
* bench's mixture reads the three files from bench.REF and builds
  MEA_DUMMY 100 + SOL 1900 on the whole-sweep route; a missing file
  exits naming it.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from metropolismontecarlo_tpu import run as run_j
from metropolismontecarlo_tpu.io.topology import read_top as read_top_j
from metropolismontecarlo_tpu.models import from_topology as from_top_j
from metropolismontecarlo_tpu.ops import quaternions as quat_j
from metropolismontecarlo_tpu.utils import config as config_j
from metropolismontecarlo_tpu_torch import bench
from metropolismontecarlo_tpu_torch import run as run_t
from metropolismontecarlo_tpu_torch.io.topology import (
    lorentz_berthelot,
    read_top,
)
from metropolismontecarlo_tpu_torch.models import from_topology as from_top
from metropolismontecarlo_tpu_torch.models import water
from metropolismontecarlo_tpu_torch.ops import quaternions as quat_t
from metropolismontecarlo_tpu_torch.utils import config as config_t

MOLS = [("MEA_DUMMY", 3), ("SOL", 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _other_topology(directory):
    """A topology with the sections and directives the stand-in lacks:
    [pairs], [angles], [dihedrals], [bonds] with parameters, #ifndef,
    #define, a nested #include, the [atomtypes] layout with a bonded type
    and [atoms] lines that take charge and mass from their atom type."""
    (directory / "inner.itp").write_text("""
[ moleculetype ]
TRI 3
[ atoms ]
1 CT 1 TRI C1 1
2 CT 1 TRI C2 1 -0.2
3 OT 1 TRI O3 1 0.2 15.5
[ bonds ]
1 2 1 0.153 224262.4
2 3 1 0.141 267776.0
[ pairs ]
1 3
[ angles ]
1 2 3 1 109.5 418.4
[ dihedrals ]
1 2 3 1 9 0.0 1.2 3
""")
    (directory / "outer.itp").write_text("""
#define HAVE_TRI
#include "inner.itp"
""")
    path = directory / "other.top"
    path.write_text("""; a topology with every section
[ defaults ]
1 3 no 1.0 1.0
[ atomtypes ]
; name btype mass charge ptype sigma epsilon
CT CT 12.011 0.05 A 0.35 0.276144
OT OT 15.999 -0.4 A 0.312 0.71128
#ifndef NO_TRI
#include "outer.itp"
#endif
#ifdef HAVE_TRI
[ system ]
three-site test
#else
[ system ]
never read
#endif
[ molecules ]
TRI 4
""")
    return str(path)


def _asdict(top):
    return json.loads(json.dumps(dataclasses.asdict(top)))


@pytest.mark.parametrize("comb_rule", [2, 3])
@pytest.mark.parametrize("defines", [(), ("FLEXIBLE",)])
def test_read_top_equals_jax(tmp_path, comb_rule, defines):
    paths = chip_smoke.write_topology_files(tmp_path, comb_rule)
    top = read_top(paths["top"], defines=defines)
    assert _asdict(top) == _asdict(read_top_j(paths["top"],
                                              defines=defines))
    assert top.defaults["comb_rule"] == comb_rule
    assert top.defaults["fudge_qq"] == 0.8333
    sol = top.mol_types["SOL"]
    assert [a[0] for a in sol.atoms] == ["OW", "HW", "HW"]
    if defines:
        assert sol.bonds and sol.angles and not sol.settles
    else:
        assert sol.settles and sol.exclusions and not sol.bonds
    assert top.molecules == [("MEA_DUMMY", 1), ("SOL", 1000)]


def test_read_top_every_section_equals_jax(tmp_path):
    path = _other_topology(tmp_path)
    for defines in ((), ("NO_TRI",)):
        got = read_top(path, defines=defines)
        assert _asdict(got) == _asdict(read_top_j(path, defines=defines))
    top = read_top(path)
    tri = top.mol_types["TRI"]
    assert tri.atoms == [("CT", 0.05, 12.011, "C1"),
                         ("CT", -0.2, 12.011, "C2"),
                         ("OT", 0.2, 15.5, "O3")]
    assert tri.pairs == [(1, 3)] and len(tri.dihedrals) == 1
    assert tri.bonds[1] == (2, 3, 1, [0.141, 267776.0])
    assert top.system_name == "three-site test"
    assert "TRI" not in read_top(path, defines=("NO_TRI",)).mol_types
    for rule in (2, 3):
        assert lorentz_berthelot(3.0, 100.0, 4.0, 25.0, rule) == \
            from_top_j.lorentz_berthelot(3.0, 100.0, 4.0, 25.0, rule)


def _systems(paths, molecules, **kw):
    top_t, top_j = read_top(paths["top"], **kw), read_top_j(paths["top"],
                                                            **kw)
    pdbs = {"MEA_DUMMY": paths["mea"], "SOL": paths["tip3p"]}
    s_t = from_top.system_from_topology(
        top_t, from_top.templates_from_pdbs(top_t, pdbs),
        molecules=molecules)
    s_j = from_top_j.system_from_topology(
        top_j, from_top_j.templates_from_pdbs(top_j, pdbs),
        molecules=molecules)
    return s_t, s_j


def _assert_same_system(s_t, s_j):
    for f in dataclasses.fields(s_t):
        a, b = getattr(s_t, f.name), getattr(s_j, f.name)
        if isinstance(a, np.ndarray):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    for prop in ("mol_p", "mol_a0", "species_slices", "n_atoms",
                 "n_atoms_padded", "species_uniform"):
        np.testing.assert_array_equal(np.asarray(getattr(s_t, prop)),
                                      np.asarray(getattr(s_j, prop)),
                                      err_msg=prop)


@pytest.mark.parametrize("comb_rule", [2, 3])
@pytest.mark.parametrize("order", ["mea_first", "sol_first"])
def test_system_from_topology_equals_jax(tmp_path, comb_rule, order):
    paths = chip_smoke.write_topology_files(tmp_path, comb_rule)
    mols = MOLS if order == "mea_first" else MOLS[::-1]
    s_t, s_j = _systems(paths, mols)
    _assert_same_system(s_t, s_j)
    assert s_t.atoms_per_mol == 3 and s_t.species_uniform
    pad = s_t.eps_table.shape[0] - 1
    assert np.all(s_t.eps_table[pad] == 0.0)
    assert np.all(s_t.eps_table[:, pad] == 0.0)
    mea = [i for i, (n, _, _) in enumerate(s_t.species) if n == "MEA_DUMMY"]
    m0 = s_t.species_slices[mea[0]][1]
    assert list(s_t.type_ids[m0]) == [0 if order == "mea_first" else 2,
                                      pad, pad]
    assert s_t.mol_p[m0] == 1 and np.all(s_t.masses[m0, 1:] == 0.0)
    # the file's own [molecules] section
    s_t, s_j = _systems(paths, None)
    _assert_same_system(s_t, s_j)
    assert s_t.n_mol == 1001


def test_quaternion_helpers_equal_jax():
    rng = np.random.default_rng(5)
    coords, masses = rng.normal(size=(4, 3)), rng.uniform(1.0, 16.0, 4)
    np.testing.assert_array_equal(
        quat_t.body_frame_from_template(coords, masses),
        from_top_j.body_frame_from_template(coords, masses))
    np.testing.assert_allclose(
        quat_t.body_frame_from_template(coords, masses),
        np.asarray(quat_j.body_frame_from_template(coords, masses)),
        rtol=0, atol=1e-12)
    batch = rng.normal(size=(2, 5, 4, 3))
    np.testing.assert_allclose(
        quat_t.center_of_mass(torch.tensor(batch), torch.tensor(masses))
        .numpy(), np.asarray(quat_j.center_of_mass(batch, masses)),
        rtol=1e-13)
    g = torch.Generator().manual_seed(3)
    u = quat_t.random_unit_vector(g, (1000,), torch.float64)
    assert u.shape == (1000, 3)
    np.testing.assert_allclose(u.norm(dim=-1).numpy(), 1.0, rtol=1e-12)
    assert float(u.mean(0).abs().max()) < 0.1


def test_topology_matches_the_hand_builders(tmp_path):
    """The stand-in is written from the port's TIP3P and CH4 constants,
    in kJ/mol and nm: the System built from it holds them again within
    1e-12 relative, and the TIP3P body within the PDB's 1e-3 A."""
    paths = chip_smoke.write_topology_files(tmp_path)
    s, _ = _systems(paths, [("SOL", 4), ("MEA_DUMMY", 2)])
    tip3p = water.tip3p_system(4)
    ref = water.spce_methane_system(4, 2)
    ow, ch4 = s.type_ids[0, 0], s.type_ids[4, 0]
    np.testing.assert_allclose(s.eps_table[ow, ow], tip3p.eps_table[0, 0],
                               rtol=1e-12)
    np.testing.assert_allclose(s.sig_table[ow, ow], tip3p.sig_table[0, 0],
                               rtol=1e-12)
    np.testing.assert_allclose(s.eps_table[ch4, ch4], ref.eps_table[2, 2],
                               rtol=1e-12)
    np.testing.assert_allclose(s.sig_table[ch4, ch4], ref.sig_table[2, 2],
                               rtol=1e-12)
    np.testing.assert_array_equal(s.charges[:4], tip3p.charges)
    np.testing.assert_array_equal(s.masses[:4], tip3p.masses)
    np.testing.assert_array_equal(s.charges[4:], ref.charges[4:])
    np.testing.assert_array_equal(s.masses[4:], ref.masses[4:])
    np.testing.assert_allclose(s.body[:4], tip3p.body, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(s.body[4:], 0.0)
    assert s.species == (("SOL", 4, 3), ("MEA_DUMMY", 2, 1))


def _lines(out):
    with open(out / "metrics.jsonl") as f:
        return [json.loads(ln) for ln in f]


def _topology_cfg(paths, molecules, run):
    return {"model": {"kind": "topology", "top": "topol.top",
                      "templates": {"MEA_DUMMY": "mea.pdb",
                                    "SOL": "tip3p.pdb"},
                      "molecules": molecules},
            "params": {"temperature": 300.0, "r_cut": 4.5,
                       "cutoff_mode": "site", "coulomb": "ewald", "nk": 3,
                       "ksq_max": 9, "p_translate": 0.5, "dr_max": 0.3,
                       "dphi_max": 0.3, "use_lrc": False,
                       "strict_min_image": False},
            "run": run}


def test_topology_cli_kind_matches_the_jax_cli(tmp_path):
    paths = chip_smoke.write_topology_files(tmp_path)
    cfg = _topology_cfg(paths, [["MEA_DUMMY", 2], ["SOL", 6]], {
        "n_chains": 2, "n_blocks": 2, "n_steps": 2, "equil_blocks": 1,
        "seed": 1, "dtype": "float64",
        "start": {"kind": "lattice", "box": 9.0}})
    assert config_t.build_system(cfg, str(tmp_path)).species == \
        config_j.build_system(cfg, str(tmp_path)).species
    outs = {}
    for pkg, main in (("j", run_j.main),
                      ("t", lambda a: run_t.main(a, device="cpu"))):
        c = json.loads(json.dumps(cfg))
        c["run"]["output"] = {"dir": str(tmp_path / f"out_{pkg}")}
        p = tmp_path / f"cfg_{pkg}.json"
        p.write_text(json.dumps(c))
        outs[pkg] = (tmp_path / f"out_{pkg}", main([str(p), "--quiet"]))
    (out_j, _), (out_t, state) = outs["j"], outs["t"]
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    lines_t, lines_j = _lines(out_t), _lines(out_j)
    assert len(lines_t) == len(lines_j) == 2
    for a, b in zip(lines_t, lines_j):
        assert sorted(a) == sorted(b)
    assert all(ln["drift_max_rel"] < 1e-9 for ln in lines_t)
    assert state.com.shape == (2, 8, 3)


@pytest.mark.parametrize("ensemble", [
    {"kind": "semigrand", "fugacity_ratio": 2.0, "box": 10.0, "n_a": 3,
     "n_b": 2, "p_flip": 0.4},
    {"kind": "osmotic", "activity": 1e-3, "box": 10.0, "n_init": 1},
    {"kind": "gibbs_binary", "boxes": [10.0, 11.0],
     "n_init": [[2, 2], [1, 1]]}], ids=lambda e: e["kind"])
def test_two_species_topology_runs_the_ensembles(tmp_path, ensemble):
    """SOL then MEA_DUMMY (CH4): the blocks the two-species ensembles
    take, run by the port's CLI in float64 on the plain steps."""
    paths = chip_smoke.write_topology_files(tmp_path)
    cfg = _topology_cfg(paths, [["SOL", 6], ["MEA_DUMMY", 6]], {
        "n_chains": 2, "n_blocks": 2, "n_steps": 6, "equil_blocks": 1,
        "seed": 2, "dtype": "float64", "ensemble": ensemble,
        "output": {"dir": str(tmp_path / "out")}})
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    run_t.main([str(p), "--quiet"], device="cpu")
    lines = _lines(tmp_path / "out")
    assert len(lines) == 2
    assert all(ln["drift_max_rel"] < 1e-9 for ln in lines), lines


def test_bench_mixture_reads_ref(tmp_path, monkeypatch):
    """bench's mixture on the stand-in files: the System of bench.py's
    recipe on the whole-sweep route, one species-block launch each; a
    missing file exits naming it and prints no number."""
    paths = chip_smoke.write_topology_files(tmp_path)
    monkeypatch.setattr(bench, "REF", str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    mc, state, label, melt = bench._setup_nvt("mixture", 1,
                                              torch.device("cpu"), gen)
    assert mc.system.species == (("MEA_DUMMY", 100, 1), ("SOL", 1900, 3))
    assert mc.system.n_atoms == 5800 and mc.route == "sweep"
    assert len(mc.tables) == 2 and melt and label.startswith("MEA+TIP3P")
    assert state.box[0] == pytest.approx((2000 / 0.004) ** (1 / 3))
    assert bool(torch.isfinite(state.energy).all())
    os.remove(paths["tip3p"])
    with pytest.raises(SystemExit, match="tip3p.pdb"):
        bench._setup_nvt("mixture", 1, torch.device("cpu"), gen)
