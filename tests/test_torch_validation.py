"""The port's validation drivers (docs/validation_torch/) against the JAX
package's (docs/validation/), on the CPU.

* (a) No driver, nor the helpers they share, imports jax or the JAX
  package (an AST scan).
* (b) Every upper-case module constant a driver shares by name with its
  JAX script is equal, both modules imported (their main is guarded);
  the paths in PATH_CONSTANTS are excluded.
* (c) Each driver's main at its smallest depth (run_all.SMOKE) on
  --device cpu writes a record with a device line, a protocol line and a
  RESULT line; with the default device and no card it exits non-zero.
* (d) The two-particle pair density p(r) ~ r^2 exp(-u/T) on the port's
  plain route in float64, at tests/test_mc.py's protocol (256 chains,
  100 + 60 x 5 sweeps) and under its gates.
* (e) The numpy helpers both scripts define agree with the JAX ones on
  seeded inputs to 1e-12; importing a JAX script leaves JAX's settings
  as they were.

Besides: a record merged from --partials counts the parts' wall, and
run_all leaves the record of a driver that failed as it was.
"""

import ast
import importlib
import importlib.util
import os
import shlex
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "docs", "validation_torch")
JAX_DIR = os.path.join(ROOT, "docs", "validation")
if PORT_DIR not in sys.path:
    sys.path.insert(0, PORT_DIR)

import run_all  # noqa: E402

DRIVERS = [name for name, _ in run_all.DRIVERS]
RECORDS = dict(run_all.DRIVERS)
HELPERS = ["_common", "run_all"]

# module constants that name files or hold a script's plumbing, not
# protocol: excluded from (b)
PATH_CONSTANTS = {
    "OUT": "the JAX script's record path; the port takes --out",
    "NIST": "the reference's data file, outside the repository; the port "
            "builds the same path without a literal and takes --nist",
    "SMOKE": "the JAX script's MMC_SMOKE knob; the port takes --device cpu "
             "and depth flags",
    "LINES": "the JAX script's record buffer; the port's is _common.Record",
}

# the JAX scripts' environment knobs, unset so their defaults are read
ENV_KNOBS = ("LRC_CHAINS", "LRC_BLOCKS", "LRC_STEPS", "EOS_CHAINS_PER_P",
             "EOS_EQUIL", "EOS_PROD", "EOS_SMOKE", "GIBBS_CAP",
             "GIBBS_CHAINS", "GIBBS_EQUIL", "GIBBS_PROD", "GIBBS_STEPS",
             "GIBBS_LRC", "GIBBS_MEGA", "GIBBS_PREEQ", "GIBBS_SMOKE",
             "LRC_SMOKE", "BAR_N", "BAR_CHAINS", "BAR_EQUIL",
             "BAR_STAGE_EQUIL", "BAR_PROD", "BAR_SMOKE", "BAR_CPU",
             "BAR_CACHE", "CO2_CHAINS", "CO2_EQUIL", "CO2_PROD",
             "CO2_SMOKE", "MMC_SMOKE")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one thread per test process is as fast
    and leaves the cores to the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name):
    return importlib.import_module(name)


def _jax(name, monkeypatch):
    """The JAX script as a module of its own, its knobs at their defaults
    and its compilation cache (set at import by some) where the tests
    keep theirs; every JAX setting its import changes is set back after
    it, so none reaches a later test."""
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MMC_CACHE", jax.config.jax_compilation_cache_dir
                       or os.path.join(ROOT, "tests", ".jax_cache"))
    spec = importlib.util.spec_from_file_location(
        f"jax_validation_{name}", os.path.join(JAX_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    update, saved = jax.config.update, {}

    def record_update(key, value):
        saved.setdefault(key, getattr(jax.config, key))
        update(key, value)

    monkeypatch.setattr(jax.config, "update", record_update)
    try:
        spec.loader.exec_module(mod)
    finally:
        monkeypatch.undo()
        for key, value in saved.items():
            update(key, value)
    return mod


# ---------------- (a) imports ----------------

@pytest.mark.parametrize("name", DRIVERS + HELPERS)
def test_driver_imports_no_jax(name):
    with open(os.path.join(PORT_DIR, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    bad = {m for m in mods if m.split(".")[0] in
           ("jax", "jaxlib", "metropolismontecarlo_tpu")}
    assert not bad, bad
    if name in DRIVERS:
        assert any(m.startswith("metropolismontecarlo_tpu_torch")
                   for m in mods)


# ---------------- (b) protocol constants ----------------

def _upper(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")
            and not callable(v) and not isinstance(v, type(sys))}


@pytest.mark.parametrize("name", DRIVERS)
def test_protocol_constants_match_jax(name, monkeypatch):
    port, ref = _upper(_port(name)), _upper(_jax(name, monkeypatch))
    # two JAX scripts keep their whole protocol in main (no constants)
    shared = sorted((set(port) & set(ref)) - set(PATH_CONSTANTS))
    for k in shared:
        a, b = port[k], ref[k]
        if isinstance(b, (np.ndarray, list, tuple)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), k
        else:
            assert a == b and type(a) is type(b), (k, a, b)
    # every protocol constant of the JAX script has its counterpart
    missing = sorted(set(ref) - set(port) - set(PATH_CONSTANTS))
    assert not missing, missing


# ---------------- (c) smoke runs ----------------

@pytest.mark.parametrize("name", DRIVERS)
def test_driver_smoke_writes_record(name, tmp_path):
    out = tmp_path / RECORDS[name]
    assert not str(out).startswith(PORT_DIR)
    _port(name).main(shlex.split(run_all.SMOKE[name])
                     + ["--device", "cpu", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "device: cpu (the kernels' plain versions)"
    assert lines[1].startswith("protocol: ")
    res = [line for line in lines if line.startswith("RESULT: ")]
    assert res and res[0] in ("RESULT: PASS", "RESULT: FAIL")
    assert any(line.startswith("wall: ") for line in lines)


def test_merged_record_wall_counts_the_parts(tmp_path):
    """A record written from --partials counts the parts' processes into
    its wall line."""
    mod = _port("run_tmmc_coexistence")
    out = tmp_path / RECORDS["run_tmmc_coexistence"]
    flags = shlex.split(run_all.SMOKE["run_tmmc_coexistence"]) + [
        "--device", "cpu", "--out", str(out), "--partials",
        str(tmp_path / "partials")]
    for part in ("tmmc", "gibbs"):
        assert mod.main(flags + ["--parts", part]) == 0
        assert not out.exists()
    mod.main(flags)
    wall = [line for line in out.read_text().splitlines()
            if line.startswith("wall: ")]
    assert len(wall) == 1 and "in 2 processes of the parts" in wall[0]


def test_run_all_keeps_the_record_of_a_failed_driver(tmp_path):
    """run_all moves a record into --outdir only once its driver has
    written it: a driver that fails leaves the old record as it was."""
    old = "an earlier run's record\n"
    rec = tmp_path / RECORDS["run_mega_boltzmann"]
    rec.write_text(old)
    args = ["--device", "cpu", "--smoke", "--jobs", "1", "--only",
            "run_mega_boltzmann", "--outdir", str(tmp_path)]
    assert run_all.main(args + ["--set",
                                "run_mega_boltzmann=--no-such-flag"]) == 1
    assert rec.read_text() == old
    assert run_all.main(args) == 0
    assert rec.read_text().startswith("device: cpu")


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_without_card_exits_nonzero(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / RECORDS[name]
    with pytest.raises(SystemExit) as exc:
        _port(name).main(["--out", str(out)])
    assert exc.value.code not in (0, None)
    assert not out.exists()


# ---------------- (d) the two-particle Boltzmann density ----------------

def test_two_particle_boltzmann_plain_f64():
    """tests/test_mc.py::test_two_particle_boltzmann_distribution's
    protocol and gates on the port's plain route in float64."""
    mb = _port("run_mega_boltzmann")
    hist, edges, acc, route, (n_dist, n_draw) = mb.sample_histogram(
        "plain", torch.device("cpu"), chains=256, rounds=60, gap=5,
        decorrelate=100, dtype=torch.float64)
    assert route == "plain"
    chi2, zmax, peak_off, ok, _, p_meas, p_exact, _ = mb.gates(
        hist, edges, acc, acc)
    assert hist.sum() > 0
    assert chi2 < 9.0, (chi2, zmax)
    assert peak_off <= 3
    assert n_dist == n_draw == 60 * 5


# ---------------- (e) shared helpers ----------------

def test_jax_script_import_restores_jax_settings(monkeypatch):
    """Importing a JAX script that sets the compilation cache's settings
    leaves every JAX setting as it was."""
    key = "jax_persistent_cache_min_compile_time_secs"
    before = getattr(jax.config, key)
    jax.config.update(key, 0.5)
    try:
        cache = jax.config.jax_compilation_cache_dir
        _jax("run_gcmc_lrc", monkeypatch)
        assert getattr(jax.config, key) == 0.5
        assert jax.config.jax_compilation_cache_dir == cache
    finally:
        jax.config.update(key, before)


@pytest.mark.parametrize("name", ["run_npt_density", "run_spce_eos",
                                  "run_gibbs_water", "run_co2_density"])
def test_g_per_cc_matches_jax(name, monkeypatch):
    x = np.random.default_rng(1).uniform(0.0, 0.05, 64)
    np.testing.assert_allclose(_port(name).g_per_cc(x),
                               _jax(name, monkeypatch).g_per_cc(x),
                               rtol=1e-12, atol=0)


def test_fit_critical_matches_jax(monkeypatch):
    rng = np.random.default_rng(2)
    temps = [0.85, 0.95, 1.00, 1.05]
    dt = 1.19 - np.asarray(temps)
    rho_v = 0.32 - 0.55 / 2 * dt**0.326 + 0.05 * dt + rng.normal(0, 1e-3, 4)
    rho_l = 0.32 + 0.55 / 2 * dt**0.326 + 0.05 * dt + rng.normal(0, 1e-3, 4)
    a = _port("run_lj_phase_diagram").fit_critical(temps, rho_v, rho_l)
    b = _jax("run_lj_phase_diagram", monkeypatch).fit_critical(
        temps, rho_v, rho_l)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert 1.1 < a[0] < 1.3


def test_moments_matches_jax(monkeypatch):
    hist = np.random.default_rng(3).poisson(50.0, 65).astype(np.float64)
    a = _port("run_gcmc_lrc").moments(hist)
    b = _jax("run_gcmc_lrc", monkeypatch).moments(hist)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


class _FakeBlocks:
    """A stand-in ensemble whose run_block returns seeded statistics."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def run_block(self, st, steps):
        return st + steps, {"n_mean": float(self.rng.normal(27.7, 0.5)),
                            "sfac_err_max": 1e-5, "drift_max_rel": 1e-3}


def test_n_samples_matches_jax(monkeypatch):
    a = _port("run_gcmc_kernel_exchange").n_samples(_FakeBlocks(4), 0, 16,
                                                    10)
    b = _jax("run_gcmc_kernel_exchange", monkeypatch).n_samples(
        _FakeBlocks(4), 0, 16, 10)
    assert a[0] == b[0] == 160
    np.testing.assert_allclose(a[1], b[1], rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", ["run_gibbs_co2_n2",
                                  "run_gibbs_npt_co2_n2"])
def test_mass_rho_matches_jax(name, monkeypatch):
    rng = np.random.default_rng(5)
    n0, n1 = rng.integers(0, 90, (2, 64, 2)).astype(np.float64)
    v = rng.uniform(4e3, 3e4, (64, 2))
    np.testing.assert_allclose(_port(name).mass_rho(n0, n1, v),
                               _jax(name, monkeypatch).mass_rho(n0, n1, v),
                               rtol=1e-12, atol=0)


def test_box_edge_matches_jax(monkeypatch):
    ref = _jax("run_bar_water", monkeypatch)
    for n in (8, 64, 216, 500):
        assert _port("run_bar_water").box_edge(n) == pytest.approx(
            ref.box_edge(n), rel=1e-12)
    assert _port("run_bar_water").box_edge(216) == pytest.approx(18.644,
                                                                 abs=5e-4)


def test_water_two_blocks_matches_jax(monkeypatch):
    """run_semigrand_binomial.py's two-block SPC/E System equals the JAX
    script's field by field."""
    a = _port("run_semigrand_binomial").water_two_blocks(24, 24)
    b = _jax("run_semigrand_binomial", monkeypatch).water_two_blocks(24, 24)
    for f in ("n_mol", "atoms_per_mol", "name", "species"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("body", "masses", "charges", "type_ids", "eps_table",
              "sig_table"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)


def test_bar_analysis_recovers_known_df():
    """run_bar_water.py's staged_bar on Gaussian works of known leg free
    energies: w_f ~ N(dF + s^2/2, s), w_r ~ N(-dF + s^2/2, s) per leg (the
    exact pair for Gaussian work distributions); the sum of the legs comes
    back within 3 of the chain-fold standard errors, each leg within 0.05
    kT, and the folds average to the whole."""
    bw = _port("run_bar_water")
    rng = np.random.default_rng(18)
    temp, chains, samples = 298.15, 64, 40
    legs = [(2.5, 1.5), (-4.0, 2.0), (0.7, 0.5), (-9.1, 2.5)]   # (dF, s)
    works = [(rng.normal(df + s * s / 2, s, (chains, samples)),
              rng.normal(-df + s * s / 2, s, (chains, samples)))
             for df, s in legs]
    works[0][0][3, 5] = np.inf              # a core-vetoed ghost: zero weight
    mu, sem, got, folds = bw.staged_bar(works, temp)
    exact = temp * sum(df for df, _ in legs)
    assert len(folds) == bw.N_FOLDS and 0.0 < sem < 0.5 * temp
    assert abs(mu - exact) < 3.0 * sem, (mu, exact, sem)
    np.testing.assert_allclose(got, [df for df, _ in legs], atol=0.05)
    assert abs(np.mean(folds) - mu) < 3.0 * sem
