"""The port's run surface on the CPU: utils/config.py, run.py (the CLI),
bench.py, parallel/remc.py, utils/validate.py and utils/profiling.py,
against the JAX package; and the import check (no module of the port
imports jax or the JAX package).

* build_system / build_params of every configs/*.json give the JAX
  package's System arrays and RunParams; a topology config whose files
  are absent raises FileNotFoundError in both packages.
* _start_box and the ewald_tol-tuned kappa_L, nk, ksq_max agree.
* The CLI (device="cpu") runs ports of the JAX CLI tests, and on each run
  every metrics.jsonl line has the keys of the JAX CLI's line on the same
  configuration; both write the same files.
* bench runs every config at 2 chains and 1 step and prints bench.py's
  JSON fields; mixture without its files exits non-zero and prints no
  number (tests/test_torch_topology.py runs it on written files).
* temperature_ladder agrees with JAX; exchange's swaps equal a numpy
  rendering of min(1, exp((1/T_i - 1/T_j)(E_i - E_j))) on the same
  uniforms.
"""

import ast
import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metropolismontecarlo_tpu import run as run_j
from metropolismontecarlo_tpu.ops import ewald as ewald_j
from metropolismontecarlo_tpu.parallel import remc as remc_j
from metropolismontecarlo_tpu.utils import config as config_j
from metropolismontecarlo_tpu_torch import bench
from metropolismontecarlo_tpu_torch import run as run_t
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
from metropolismontecarlo_tpu_torch.models.system import RunParams, SimState
from metropolismontecarlo_tpu_torch.parallel import remc as remc_t
from metropolismontecarlo_tpu_torch.utils import config as config_t
from metropolismontecarlo_tpu_torch.utils.profiling import sweeps_per_sec
from metropolismontecarlo_tpu_torch.utils.validate import validate_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.json")))
LJ_PARAMS = {"strict_min_image": False, "temperature": 1.5, "r_cut": 2.5,
             "cutoff_mode": "site", "coulomb": "none", "p_translate": 1.0,
             "dr_max": 0.3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------- configuration ----------------------------------------


def _config_kind(path):
    with open(path) as f:
        return json.load(f)["model"]["kind"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_build_system_and_params_match_jax(path):
    cfg = config_t.load_config(path)
    assert cfg == config_j.load_config(path)
    p_t, p_j = config_t.build_params(cfg), config_j.build_params(cfg)
    assert dataclasses.asdict(p_t) == {
        f.name: getattr(p_j, f.name) for f in dataclasses.fields(p_t)}
    if _config_kind(path) == "topology" and not os.path.isfile(
            cfg["model"]["top"]):
        # the reference's topology files are not in the repo
        for build in (config_t.build_system, config_j.build_system):
            with pytest.raises(FileNotFoundError, match="topol.top"):
                build(cfg)
        return
    s_t, s_j = config_t.build_system(cfg), config_j.build_system(cfg)
    for f in dataclasses.fields(s_t):
        a, b = getattr(s_t, f.name), getattr(s_j, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f.name)
        else:
            assert a == b, f.name


def test_build_params_refuses_unknown_fields_and_kinds():
    cfg = {"model": {"kind": "lj", "n_mol": 4}, "params": {"r_cutt": 2.0}}
    with pytest.raises(ValueError, match="r_cutt"):
        config_t.build_params(cfg)
    for kind in ("tip4p2005", "tip4pew", "tip4pice"):
        model = {"model": {"kind": kind, "n_mol": 4}}
        s_t, s_j = config_t.build_system(model), config_j.build_system(model)
        assert s_t.name == s_j.name == kind
        np.testing.assert_array_equal(s_t.charges, np.asarray(s_j.charges))
    with pytest.raises(KeyError, match="top"):
        config_t.build_system({"model": {"kind": "topology"}})
    with pytest.raises(ValueError, match="unknown model kind"):
        config_t.build_system({"model": {"kind": "argon", "n_mol": 4}})


def test_start_box_and_ewald_tuning_match_jax(tmp_path, capsys):
    """_start_box of the lattice (box, density), nist and cnf starts, and
    the CLI's ewald_tol tuning at the start box (a port of
    test_cli_ewald_tol_tuning: nk retuned, drift at float64 round-off)."""
    from metropolismontecarlo_tpu.models.water import spce_system as spce_j
    from metropolismontecarlo_tpu_torch.io.configs import write_cnf
    from metropolismontecarlo_tpu_torch.models.water import spce_system

    nist = tmp_path / "nist.txt"
    nist.write_text("11.5 11.5 11.5\n1\n1 0.1 0.2 0.3 O\n"
                    "2 1.1 0.2 0.3 H\n3 0.1 11.2 0.3 H\n")
    write_cnf(tmp_path / "c.cnf", np.zeros((2, 3)), np.eye(4)[:2], 7.25)
    for start in ({"kind": "lattice", "box": 12.0},
                  {"kind": "lattice", "density": 0.03},
                  {"kind": "nist", "path": "nist.txt"},
                  {"kind": "cnf", "path": "c.cnf"}):
        b_t = run_t._start_box({"start": start}, spce_system(16), tmp_path)
        b_j = run_j._start_box({"start": start}, spce_j(16), str(tmp_path))
        assert b_t == pytest.approx(b_j, rel=1e-14), start

    cfg = {"model": {"kind": "spce", "n_mol": 16},
           "params": {"strict_min_image": False, "temperature": 350.0,
                      "r_cut": 5.0, "cutoff_mode": "site",
                      "coulomb": "ewald", "ewald_tol": 1e-5},
           "run": {"n_chains": 2, "n_blocks": 2, "n_steps": 5,
                   "equil_blocks": 1, "seed": 1, "dtype": "float64",
                   "start": {"kind": "lattice", "box": 12.0},
                   "output": {"dir": str(tmp_path / "out")}}}
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    capsys.readouterr()
    run_t.main([str(p)], device="cpu")
    out = capsys.readouterr().out
    kl, nk, ksq = ewald_j.tune_parameters(12.0, 5.0, 1e-5)
    assert f"kappa_L = {kl:.3f}, nk = {nk}, ksq_max = {ksq}" in out
    assert nk != 5
    lines = _lines(tmp_path / "out")
    assert len(lines) == 2
    assert all(ln["drift_max_rel"] < 1e-10 for ln in lines)


# ---------------- the CLI against the JAX CLI --------------------------


def _lines(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _cli_pair(tmp_path, cfg, name="run", resume=False):
    """Run the JAX CLI and the port's on cfg, each into its own output
    directory; assert equal files and equal metrics keys line by line.
    Returns (port lines, port final state, port output dir)."""
    outs = {}
    for pkg, main in (("j", run_j.main),
                      ("t", lambda a: run_t.main(a, device="cpu"))):
        c = json.loads(json.dumps(cfg))
        out = tmp_path / f"{name}_{pkg}"
        c["run"].setdefault("output", {})["dir"] = str(out)
        p = tmp_path / f"{name}_{pkg}.json"
        p.write_text(json.dumps(c))
        state = main([str(p), "--quiet"])
        if resume:
            main([str(p), "--quiet", "--resume",
                  str(out / "checkpoint.npz")])
        outs[pkg] = (out, state)
    (out_j, _), (out_t, state_t) = outs["j"], outs["t"]
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    lines_t, lines_j = _lines(out_t), _lines(out_j)
    assert len(lines_t) == len(lines_j)
    for a, b in zip(lines_t, lines_j):
        assert sorted(a) == sorted(b)
    return lines_t, state_t, out_t


def test_cli_end_to_end(tmp_path):
    """Metrics, RDF, PDB frame, checkpoint, final state and a resume."""
    cfg = {"model": {"kind": "lj", "n_mol": 27},
           "params": dict(LJ_PARAMS, use_lrc=True),
           "run": {"n_chains": 8, "n_blocks": 3, "n_steps": 10,
                   "equil_blocks": 1, "seed": 1, "dtype": "float32",
                   "start": {"kind": "lattice", "density": 0.6},
                   "output": {"checkpoint_every": 1, "pdb_every": 2,
                              "rdf": {"type_i": 0, "type_j": 0,
                                      "r_max": 1.5, "n_bins": 20}}}}
    lines, state, out = _cli_pair(tmp_path, cfg, resume=True)
    for f in ("metrics.jsonl", "rdf.txt", "final.npz", "checkpoint.npz",
              "frame_2.pdb"):
        assert (out / f).exists(), f
    assert len(lines) == 3
    assert all(np.isfinite(ln["energy_mean"]) for ln in lines)
    assert all(np.isfinite(ln["pressure_mean"]) for ln in lines)
    g = np.loadtxt(out / "rdf.txt")
    assert g.shape == (20, 2) and np.all(np.isfinite(g))
    assert isinstance(state, SimState) and state.com.shape == (8, 27, 3)


def test_cli_resume_continues_the_trajectory(tmp_path):
    """A run resumed from its block-2 checkpoint ends in the state of the
    uninterrupted run, bit for bit (float64)."""
    cfg = {"model": {"kind": "lj", "n_mol": 27},
           "params": dict(LJ_PARAMS, use_lrc=False),
           "run": {"n_chains": 4, "n_blocks": 4, "n_steps": 5,
                   "equil_blocks": 1, "seed": 5, "dtype": "float64",
                   "start": {"kind": "lattice", "density": 0.6},
                   "output": {"dir": str(tmp_path / "a"),
                              "checkpoint_every": 2}}}
    p = tmp_path / "a.json"
    p.write_text(json.dumps(cfg))
    full = run_t.main([str(p), "--quiet"], device="cpu")
    import shutil
    shutil.copy(tmp_path / "a" / "checkpoint.npz", tmp_path / "ck2.npz")
    with np.load(tmp_path / "ck2.npz") as data:
        assert int(data["meta_block"]) == 4
    cfg["run"]["n_blocks"] = 2
    cfg["run"]["output"]["dir"] = str(tmp_path / "b")
    p.write_text(json.dumps(cfg))
    run_t.main([str(p), "--quiet"], device="cpu")
    cfg["run"]["n_blocks"] = 4
    p.write_text(json.dumps(cfg))
    resumed = run_t.main([str(p), "--quiet", "--resume",
                          str(tmp_path / "b" / "checkpoint.npz")],
                         device="cpu")
    for f in ("com", "quat", "coords", "energy", "acc", "att", "dr_max",
              "step"):
        np.testing.assert_array_equal(getattr(resumed, f).numpy(),
                                      getattr(full, f).numpy(), err_msg=f)


def test_cli_annealing_schedule(tmp_path):
    cfg = {"model": {"kind": "lj", "n_mol": 27},
           "params": dict(LJ_PARAMS, temperature=1.0, use_lrc=False),
           "run": {"n_chains": 8, "n_blocks": 4, "n_steps": 5,
                   "equil_blocks": 3, "seed": 2, "dtype": "float32",
                   "anneal": {"t_start": 4.0},
                   "start": {"kind": "lattice", "density": 0.5}}}
    _, state, _ = _cli_pair(tmp_path, cfg)
    np.testing.assert_allclose(state.temp.numpy(), 1.0, rtol=1e-6)


def test_cli_fluctuation_observables(tmp_path):
    """Dielectric, heat capacity and Widom outputs: one final record with
    finite values, the running epsilon and Widom mean on every
    production line."""
    cfg = {"model": {"kind": "spce", "n_mol": 8},
           "params": {"temperature": 300.0, "r_cut": 5.0,
                      "coulomb": "ewald", "nk": 3, "ksq_max": 9,
                      "p_translate": 0.5, "dr_max": 0.3, "dphi_max": 0.4},
           "run": {"n_chains": 4, "n_blocks": 3, "n_steps": 3,
                   "equil_blocks": 1, "seed": 2, "dtype": "float64",
                   "start": {"kind": "lattice", "box": 12.0},
                   "output": {"dielectric": True, "heat_capacity": True,
                              "widom": {"n_insertions": 8}}}}
    lines, _, _ = _cli_pair(tmp_path, cfg)
    final = [ln for ln in lines if ln.get("phase") == "final"]
    assert len(final) == 1
    f = final[0]
    for k in ("epsilon", "g_kirkwood", "cv_excess", "widom_boltzmann_mean",
              "mu_excess"):
        assert np.isfinite(f[k]), (k, f)
    assert f["epsilon"] >= 1.0 and f["g_kirkwood"] > 0.0
    assert f["cv_excess"] >= 0.0 and f["widom_boltzmann_mean"] >= 0.0
    prod = [ln for ln in lines if ln.get("phase") == "prod"]
    assert all("widom_boltzmann_mean" in ln and "epsilon_running" in ln
               for ln in prod)


def test_cli_pressure_ladder(tmp_path):
    """Every chain equilibrates to its own isobar: a 10x pressure span
    gives the ideal gas's ~2.15x box span."""
    cfg = {"model": {"kind": "lj", "n_mol": 16},
           "params": {"strict_min_image": False, "temperature": 2.0,
                      "r_cut": 1.0, "cutoff_mode": "site",
                      "coulomb": "none", "p_translate": 1.0, "dr_max": 1.0,
                      "use_lrc": False, "p_volume": 1.0, "dv_max": 0.3},
           "run": {"n_chains": 8, "n_blocks": 4, "n_steps": 120,
                   "equil_blocks": 1, "seed": 3, "dtype": "float64",
                   "pressure_ladder": {"p_min": 0.1, "p_max": 1.0},
                   "start": {"kind": "lattice", "density": 0.3}}}
    lines, state, _ = _cli_pair(tmp_path, cfg)
    box = state.box.numpy()
    assert box[0] > 1.5 * box[-1], box
    assert box[:2].min() > box[-2:].max(), box
    assert all(np.isfinite(ln["pressure_mean"]) for ln in lines)


def test_cli_remc_quench_and_structure_factor(tmp_path):
    """A replica ladder (remc_swap_frac on every line), a quench and the
    S(k) output with NPT fluctuations off the ladder."""
    cfg = {"model": {"kind": "lj", "n_mol": 27},
           "params": dict(LJ_PARAMS, temperature=1.0, use_lrc=True),
           "run": {"n_chains": 8, "n_blocks": 3, "n_steps": 4,
                   "equil_blocks": 1, "seed": 4, "dtype": "float64",
                   "quench_steps": 2, "remc": {"t_min": 0.8, "t_max": 2.0},
                   "start": {"kind": "lattice", "density": 0.5},
                   "output": {"sk": {"n_max": 3}}}}
    lines, state, out = _cli_pair(tmp_path, cfg)
    assert all(0.0 <= ln["remc_swap_frac"] <= 1.0 for ln in lines)
    np.testing.assert_allclose(state.temp.numpy(), remc_t.temperature_ladder(
        0.8, 2.0, 8, dtype=torch.float64).numpy(), rtol=1e-12)
    sk = np.loadtxt(out / "sk.txt")
    assert sk.shape[1] == 2 and np.all(np.isfinite(sk))


def test_cli_gcmc_lrc_end_to_end(tmp_path):
    """use_lrc through the config layer on monatomic muVT: drift-consistent
    blocks, and the attractive tail raises <N> at the same activity."""
    def run(use_lrc):
        cfg = {"model": {"kind": "lj", "n_mol": 1},
               "params": {"temperature": 1.5, "r_cut": 2.5,
                          "cutoff_mode": "site", "coulomb": "none",
                          "p_translate": 0.6, "dr_max": 0.3,
                          "use_lrc": use_lrc, "strict_min_image": False},
               "run": {"n_chains": 32, "n_blocks": 4, "n_steps": 400,
                       "equil_blocks": 2, "seed": 3, "dtype": "float64",
                       "ensemble": {"kind": "gcmc", "activity": 0.08,
                                    "capacity": 64, "box": 6.0,
                                    "n_init": 20},
                       "output": {"checkpoint_every": 2}}}
        lines, _, out = _cli_pair(tmp_path, cfg, f"lrc{use_lrc}")
        assert (out / "checkpoint.npz").exists()
        assert all(np.isfinite(ln["energy_mean"]) for ln in lines)
        assert all(ln["drift_max_rel"] < 1e-6 for ln in lines)
        return np.mean([ln["n_mean"] for ln in lines
                        if ln.get("phase") == "prod"])

    n_on, n_off = run(True), run(False)
    assert n_on > n_off + 0.5, (n_on, n_off)


def test_cli_tmmc_end_to_end(tmp_path):
    """Stratified starts, a burn-in discard, lnpi.txt over a contiguous
    N range with finite ln Pi."""
    cfg = {"model": {"kind": "lj", "n_mol": 1},
           "params": {"strict_min_image": False, "temperature": 1.5,
                      "r_cut": 2.5, "cutoff_mode": "site",
                      "coulomb": "none", "p_translate": 0.3, "dr_max": 0.5,
                      "use_lrc": False},
           "run": {"n_chains": 16, "n_blocks": 4, "n_steps": 400, "seed": 2,
                   "dtype": "float64",
                   "ensemble": {"kind": "tmmc", "activity": 0.05,
                                "capacity": 40, "box": 5.0,
                                "n_init": [1, 30], "discard_blocks": 1}}}
    lines, _, out = _cli_pair(tmp_path, cfg)
    rows = (out / "lnpi.txt").read_text().splitlines()
    data = np.array([r.split() for r in rows[1:]], dtype=np.float64)
    assert data.shape[0] >= 10
    assert np.all(np.isfinite(data[:, 1]))
    assert np.all(np.diff(data[:, 0]) == 1)
    phases = [ln["phase"] for ln in lines]
    assert phases.count("burnin") == 1 and phases.count("prod") == 3


def test_cli_gibbs_and_semigrand(tmp_path, monkeypatch):
    """The Gibbs and semigrand runners: N conserved, one line per block,
    a checkpoint; the semigrand system (two SPC/E species blocks) comes
    from a substituted build_system in both packages."""
    gibbs = {"model": {"kind": "lj", "n_mol": 1},
             "params": {"temperature": 1.2, "r_cut": 2.5,
                        "cutoff_mode": "site", "coulomb": "none",
                        "p_translate": 0.6, "p_volume": 0.05,
                        "dr_max": 0.35, "use_lrc": False,
                        "strict_min_image": False},
             "run": {"n_chains": 4, "n_blocks": 2, "n_steps": 60,
                     "equil_blocks": 1, "seed": 0, "dtype": "float64",
                     "ensemble": {"kind": "gibbs", "boxes": [5.0, 6.0],
                                  "n_init": [20, 8], "capacity": 40,
                                  "dv_max": 0.03},
                     "output": {"checkpoint_every": 1}}}
    lines, state, out = _cli_pair(tmp_path, gibbs, "gibbs")
    assert (out / "checkpoint.npz").exists() and len(lines) == 2
    np.testing.assert_array_equal(state.active.sum((1, 2)).numpy(), 28)

    from metropolismontecarlo_tpu.models.system import System as SystemJ
    from metropolismontecarlo_tpu_torch.models.water import spce_two_blocks
    sys_t = spce_two_blocks(8, 8)
    sys_j = SystemJ(**{f.name: getattr(sys_t, f.name)
                       for f in dataclasses.fields(sys_t)})
    monkeypatch.setattr(config_t, "build_system",
                        lambda cfg, base_dir=".": sys_t)
    monkeypatch.setattr(config_j, "build_system",
                        lambda cfg, base_dir=".": sys_j)
    semi = {"model": {"kind": "spce", "n_mol": 16},
            "params": {"temperature": 600.0, "r_cut": 4.5,
                       "cutoff_mode": "site", "coulomb": "ewald", "nk": 3,
                       "ksq_max": 9, "use_lrc": False, "p_translate": 0.5,
                       "dr_max": 0.5, "dphi_max": 0.5,
                       "strict_min_image": False},
            "run": {"n_chains": 4, "n_blocks": 2, "n_steps": 20,
                    "equil_blocks": 1, "seed": 1, "dtype": "float64",
                    "ensemble": {"kind": "semigrand", "fugacity_ratio": 2.0,
                                 "box": 10.0, "n_a": 4, "n_b": 3,
                                 "p_flip": 0.4}}}
    lines, state, _ = _cli_pair(tmp_path, semi, "semi")
    np.testing.assert_array_equal(state.active.sum(1).numpy(), 7)
    assert all(ln["drift_max_rel"] < 1e-9 for ln in lines)


def test_cli_refuses_unported_ensembles_and_missing_card(tmp_path):
    # every model kind is ported; the osmotic and gibbs_binary ensembles
    # reach their builders, which refuse a one-species model as JAX's do
    for model, ens, exc, match in (
            ("tip4p2005", {"kind": "osmotic", "activity": 1e-4, "box": 9.0,
                           "n_init": 1}, ValueError, "two species"),
            ("spce", {"kind": "osmotic", "activity": 1e-4, "box": 9.0,
                      "n_init": 1}, ValueError, "two species"),
            ("spce", {"kind": "gibbs_binary", "boxes": [9.0, 9.0],
                      "n_init": [[1, 1], [1, 1]]}, ValueError,
             "two species")):
        cfg = {"model": {"kind": model, "n_mol": 8},
               "params": {"strict_min_image": False},
               "run": {"ensemble": ens}}
        p = tmp_path / f"{ens['kind']}.json"
        p.write_text(json.dumps(cfg))
        with pytest.raises(exc, match=match):
            run_t.main([str(p), "--quiet"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_t.main([str(p), "--quiet"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main()


# ---------------- bench ------------------------------------------------


def _bench_fields():
    """The keys of the result record the root bench.py prints."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rec"
                        for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no result record in bench.py")


def test_bench_every_config_on_the_cpu(monkeypatch, capsys, tmp_path):
    fields = _bench_fields()
    assert {"metric", "value", "first_call_s", "command"} <= fields
    monkeypatch.setattr(bench, "MELT_SWEEPS", 0)
    monkeypatch.setenv("BENCH_CHAINS", "2")
    monkeypatch.setenv("BENCH_STEPS", "1")
    for config in ("spce", "wolf", "npt", "lj", "triatomic", "gcmc",
                   "tmmc", "gibbs", "semigrand"):
        monkeypatch.setenv("BENCH_CONFIG", config)
        capsys.readouterr()
        rec = bench.main(device="cpu")
        out = capsys.readouterr().out.strip().splitlines()
        assert json.loads(out[-1]) == rec
        wall = json.loads(out[-2])
        assert wall["config"] == config and wall["run_block_s"] > 0.0
        want = fields | ({"mega"} if config in bench.ENSEMBLES else set())
        assert set(rec) == want, config
        assert rec["value"] > 0.0 and rec["config"] == config
        assert rec["chains"] == 2 and rec["steps"] == 1
    monkeypatch.setenv("BENCH_CONFIG", "mixture")
    monkeypatch.setattr(bench, "REF", str(tmp_path))       # no files there
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        bench.main(device="cpu")
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


# ---------------- remc, validate, profiling ----------------------------


def test_temperature_ladder_matches_jax():
    for kind in ("geometric", "linear"):
        np.testing.assert_allclose(
            remc_t.temperature_ladder(0.7, 2.0, 9, kind,
                                      dtype=torch.float64).numpy(),
            np.asarray(remc_j.temperature_ladder(0.7, 2.0, 9, kind,
                                                 dtype=jnp.float64)),
            rtol=1e-14)


@pytest.mark.parametrize("phase", [0, 1])
def test_exchange_matches_numpy_rendering(phase):
    C = 9
    rng = np.random.default_rng(phase)
    temp = np.geomspace(0.8, 2.0, C)
    energy = rng.normal(-100.0, 3.0, C)
    fields = {f.name: torch.tensor(rng.normal(size=(C, 2)))
              for f in dataclasses.fields(SimState)}
    fields.update(temp=torch.tensor(temp), energy=torch.tensor(energy),
                  com=torch.tensor(rng.normal(size=(C, 4, 3))))
    state = SimState(**fields)
    out, frac = remc_t.exchange(state, torch.Generator().manual_seed(5),
                                phase)
    u = torch.rand(C, generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64).numpy()
    swapped, pairs = np.arange(C), 0
    n_swap = 0
    for i in range(phase, C - 1, 2):
        j = i + 1
        pairs += 1
        p_acc = min(1.0, np.exp((1 / temp[i] - 1 / temp[j])
                                * (energy[i] - energy[j])))
        if u[i] < p_acc:
            swapped[[i, j]] = [j, i]
            n_swap += 2
    np.testing.assert_array_equal(out.energy.numpy(), energy[swapped])
    np.testing.assert_array_equal(out.com.numpy(),
                                  fields["com"].numpy()[swapped])
    np.testing.assert_array_equal(out.temp.numpy(), temp)
    active = 2 * pairs
    assert float(frac) == pytest.approx(n_swap / active)


def test_validate_state_and_sweeps_per_sec():
    params = RunParams(**dict(LJ_PARAMS, use_lrc=False))
    mc = MonteCarlo(lj_system(27), params, device="cpu",
                    dtype=torch.float64)
    box = (27 / 0.1) ** (1 / 3)
    st = mc.init_state(cubic_lattice(27, box), box=box, n_chains=4)
    assert validate_state(st, lj_system(27), params) == []
    bad = dataclasses.replace(st, energy=st.energy * float("nan"))
    assert "non-finite" in validate_state(bad, lj_system(27), params,
                                          strict=False)[0]
    with pytest.raises(AssertionError):
        validate_state(bad, lj_system(27), params)
    assert sweeps_per_sec(mc, st) > 0.0


# ---------------- no JAX in the port -----------------------------------


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import metropolismontecarlo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'metropolismontecarlo_tpu.')) or m == "
        "'metropolismontecarlo_tpu']\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.strip().splitlines()[-1])
    assert n >= 40
