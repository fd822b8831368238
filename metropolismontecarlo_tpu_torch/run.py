"""Command-line runner (counterpart of metropolismontecarlo_tpu/run.py):

    python -m metropolismontecarlo_tpu_torch <config.json> [--resume CK]
        [--quiet]

runs the configuration (utils/config.py) on the card and writes, into
run.output.dir, metrics.jsonl (one line per block, the JAX CLI's keys),
rdf.txt, sk.txt, frame_N.pdb, checkpoint.npz, final.npz, lnpi.txt (TMMC)
and the final production averages.  `main(argv, device="cpu")` runs the
same on the CPU (the kernels' plain versions); without a card the default
device raises.

Randomness: one torch.Generator seeded with run.seed drives the moves (and
is saved in every checkpoint, so a resume continues the exact
trajectory); replica exchanges and Widom insertions draw from generators
seeded per block from seed + 7919 and seed + 104729.
"""

import argparse
import dataclasses
import math
import os

import numpy as np
import torch

from metropolismontecarlo_tpu_torch.io.checkpoint import (
    load_state,
    save_ensemble_state,
    save_state,
)
from metropolismontecarlo_tpu_torch.io.configs import cubic_lattice, read_cnf
from metropolismontecarlo_tpu_torch.mc.driver import MonteCarlo
from metropolismontecarlo_tpu_torch.models import energy as energy_model
from metropolismontecarlo_tpu_torch.observables import (
    BlockAverager,
    DipoleAccumulator,
    EnergyFluctuations,
    NPTFluctuations,
    RDFAccumulator,
    StructureFactorAccumulator,
)
# utils.config is read as a module at call time, so a test can substitute
# build_system
from metropolismontecarlo_tpu_torch.utils import config as _config
from metropolismontecarlo_tpu_torch.utils.logging import (
    JsonlLogger,
    banner,
    block_line,
)

REMC_SEED_OFFSET = 7919
WIDOM_SEED_OFFSET = 104729


def seeded_generator(device, seed, fold=None):
    """A torch.Generator on device seeded with seed, or, given `fold`,
    with a number derived from (seed, fold): one independent stream per
    block, as the JAX package folds a block index into a key."""
    gen = torch.Generator(device=torch.device(device))
    s = int(seed) if fold is None else \
        (int(seed) * 1_000_003 + int(fold) + 1) % (1 << 63)
    gen.manual_seed(s)
    return gen


def _start_box(run_cfg, system, base_dir):
    """The starting box edge of the run's start section (a host float)."""
    start = run_cfg.get("start", {"kind": "lattice"})
    kind = start.get("kind", "lattice").lower()
    if kind == "lattice":
        if start.get("box"):
            return float(start["box"])
        return (system.n_mol / float(start["density"])) ** (1.0 / 3.0)
    if kind == "nist":
        from metropolismontecarlo_tpu_torch.models.water import spce_from_nist
        return float(spce_from_nist(os.path.join(base_dir,
                                                 start["path"]))[3])
    if kind == "cnf":
        return float(read_cnf(os.path.join(base_dir, start["path"]))[2])
    raise ValueError(f"unknown start kind {kind!r}")


def _initial_state(mc, run_cfg, system, base_dir):
    start = run_cfg.get("start", {"kind": "lattice"})
    kind = start.get("kind", "lattice").lower()
    n_chains = int(run_cfg.get("n_chains", 8))
    if kind == "lattice":
        box = _start_box(run_cfg, system, base_dir)
        return mc.init_state(cubic_lattice(system.n_mol, box), box=box,
                             n_chains=n_chains)
    if kind == "nist":
        from metropolismontecarlo_tpu_torch.models.water import spce_from_nist
        _, coords, com, box = spce_from_nist(
            os.path.join(base_dir, start["path"]))
        return mc.init_from_coords(coords, com, box, n_chains=n_chains)
    if kind == "cnf":
        com, quat, box = read_cnf(os.path.join(base_dir, start["path"]))
        return mc.init_state((com + box / 2.0) % box, quat=quat, box=box,
                             n_chains=n_chains)
    raise ValueError(f"unknown start kind {kind!r}")


class _Run:
    """What every runner shares: the run section, the output directory,
    the metrics log, the generator and the block schedule."""

    def __init__(self, cfg, args, device, n_steps_default):
        self.run_cfg = cfg.get("run", {})
        self.ens = self.run_cfg.get("ensemble")
        self.out_cfg = self.run_cfg.get("output", {})
        self.out_dir = self.out_cfg.get("dir")
        self.quiet = args.quiet
        self.device = device
        self.seed = int(self.run_cfg.get("seed", 0))
        self.n_chains = int(self.run_cfg.get("n_chains", 8))
        self.n_blocks = int(self.run_cfg.get("n_blocks", 10))
        self.n_steps = int(self.run_cfg.get("n_steps", n_steps_default))
        self.equil = int(self.run_cfg.get("equil_blocks", 0))
        self.ckpt_every = int(self.out_cfg.get("checkpoint_every", 0))
        self.generator = seeded_generator(device, self.seed)
        self.logger = JsonlLogger(os.path.join(self.out_dir, "metrics.jsonl")
                                  if self.out_dir else None)

    def path(self, name):
        return os.path.join(self.out_dir, name)

    def checkpoint_due(self, block):
        return bool(self.out_dir and self.ckpt_every
                    and (block + 1) % self.ckpt_every == 0)

    def say(self, text):
        if not self.quiet:
            print(text)


def _ensemble_blocks(r, app, state, line, phases=True, extra=None):
    """The block loop of the gcmc, binary, semigrand and gibbs runners:
    run_block, the printed line, one metrics line (list values dropped;
    "phase" equil/prod unless phases is False), checkpoint.npz every
    output.checkpoint_every blocks, production averages of the float
    metrics.  extra(stats) adds derived metrics first."""
    averages = BlockAverager()
    for block in range(r.n_blocks):
        state, stats = app.run_block(state, r.n_steps)
        if extra is not None:
            extra(stats)
        r.say(line(block, stats))
        rec = {k: v for k, v in stats.items() if not isinstance(v, list)}
        rec["block"] = block
        if phases:
            rec["phase"] = "equil" if block < r.equil else "prod"
        r.logger.write(rec)
        if phases and r.checkpoint_due(block):
            save_ensemble_state(r.path("checkpoint.npz"), state,
                                {"block": block}, generator=r.generator)
        if phases and block >= r.equil:
            averages.add(**{k: v for k, v in stats.items()
                            if isinstance(v, float)})
    r.logger.close()
    return state, averages


def _run_gcmc(cfg, system, params, dtype, args, device):
    """muVT: `"ensemble": {"kind": "gcmc", "activity", "capacity", "box",
    "n_init", "p_exchange", "n_orient", "bias", "mega"}` (monatomic
    systems: mc/gcmc.py GCMC; rigid molecules: mc/gcmc_mol.py MolGCMC,
    whose capacity is the model's n_mol), or `{"kind": "binary",
    "activities": [z0, z1], "box", "n_init": [n0, n1], "p_exchange",
    "n_orient", "mega"}` on a two-species-block system, or `{"kind":
    "osmotic", "activity", "box", "n_init", "p_exchange", "n_orient",
    "mega"}` (mc/gcmc_osmotic.py OsmoticGCMC: solute exchange in a fixed
    solvent; the model's first species block is the solvent, the second
    the solute slots)."""
    r = _Run(cfg, args, device, 1000)
    ens = r.ens
    common = dict(dtype=dtype, mega=ens.get("mega"), device=device,
                  generator=r.generator)
    if ens.get("kind") == "binary":
        from metropolismontecarlo_tpu_torch.mc.gcmc_binary import BinaryGCMC
        g = BinaryGCMC(system, params,
                       activities=tuple(float(z) for z in ens["activities"]),
                       p_exchange=float(ens.get("p_exchange", 0.4)),
                       n_orient=int(ens.get("n_orient", 1)), **common)
        state = g.init(box=float(ens["box"]),
                       n_init=tuple(int(n) for n in ens["n_init"]),
                       n_chains=r.n_chains)
        state, _ = _ensemble_blocks(
            r, g, state, phases=False, line=lambda b, s: (
                f"blk {b:4d}  <N0> {s['n0_mean']:8.2f}  "
                f"<N1> {s['n1_mean']:8.2f}  "
                f"accX {s['acc_insert0']:.3f}/{s['acc_insert1']:.3f}  "
                f"drift {s['drift_max_rel']:.2e}"))
        r.say("done.")
        return state
    if ens.get("kind") == "osmotic":
        from metropolismontecarlo_tpu_torch.mc.gcmc_osmotic import (
            OsmoticGCMC,
        )
        if "bias" in ens:
            raise ValueError("ensemble.bias applies only to molecular GCMC "
                             "(mc/gcmc_mol.py); the osmotic app does not "
                             "support cavity bias yet")
        g = OsmoticGCMC(system, params, activity=float(ens["activity"]),
                        p_exchange=float(ens.get("p_exchange", 0.3)),
                        n_orient=int(ens.get("n_orient", 1)), **common)
    elif system.atoms_per_mol > 1:
        from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
        if int(ens["capacity"]) != system.n_mol:
            raise ValueError(
                f"molecular GCMC: model n_mol ({system.n_mol}) must equal "
                f"ensemble capacity ({ens['capacity']}) - the molecule "
                "slots are the system's molecules")
        g = MolGCMC(system, params, activity=float(ens["activity"]),
                    p_exchange=float(ens.get("p_exchange", 0.3)),
                    n_orient=int(ens.get("n_orient", 1)),
                    bias=ens.get("bias", "orientation"), **common)
    else:
        from metropolismontecarlo_tpu_torch.mc.gcmc import GCMC
        unsupported = {"p_exchange", "n_orient", "bias"} & set(ens)
        if unsupported:
            raise ValueError(
                f"ensemble keys {sorted(unsupported)} apply only to "
                "molecular (P > 1) GCMC; the monatomic app splits moves by "
                "params.p_translate and needs no orientations")
        g = GCMC(system, params, activity=float(ens["activity"]),
                 capacity=int(ens["capacity"]), **common)
    state = g.init(box=float(ens["box"]), n_init=int(ens["n_init"]),
                   n_chains=r.n_chains)
    vol = float(ens["box"]) ** 3

    def density(stats):
        stats["density_mean"] = stats["n_mean"] / vol

    state, averages = _ensemble_blocks(
        r, g, state, extra=density, line=lambda b, s: (
            f"blk {b:4d}  <N> {s['n_mean']:9.3f}  "
            f"rho {s['density_mean']:.5f}  accI {s['acc_insert']:.3f}  "
            f"accD {s['acc_delete']:.3f}  full {s['full_frac']:.3f}  "
            f"drift {s['drift_max_rel']:.2e}"))
    if averages.blocks:
        z = float(ens["activity"])
        rho = averages.mean("density_mean")
        mu = f"beta*mu_ex = ln(z/rho) = {math.log(z / rho):.4f}" \
            if rho > 0.0 else "beta*mu_ex undefined (<N> = 0)"
        r.say(f"production averages over {len(averages.blocks)} blocks: "
              f"<N> = {averages.mean('n_mean'):.3f} "
              f"+- {averages.sem('n_mean'):.3f}   " + mu)
        r.say("done.")
    return state


def _run_tmmc(cfg, system, params, dtype, args, device):
    """Flat-histogram muVT: `"ensemble": {"kind": "tmmc", "activity",
    "capacity", "box", "n_init": n | [lo, hi] (stratified starts),
    "melt_blocks" (molecular: fixed-N blocks first), "discard_blocks"
    (reset the collection matrix after that many blocks), "p_exchange",
    "n_orient", "coexistence", "mega"}`; writes lnpi.txt."""
    from metropolismontecarlo_tpu_torch.mc.tmmc import (
        TMMC,
        TMMCMol,
        coexistence,
        surface_tension,
    )

    r = _Run(cfg, args, device, 1000)
    ens = r.ens
    box = float(ens["box"])
    common = dict(dtype=dtype, mega=ens.get("mega"), device=device,
                  generator=r.generator)
    if system.atoms_per_mol > 1:
        if int(ens["capacity"]) != system.n_mol:
            raise ValueError(
                f"molecular TMMC: model n_mol ({system.n_mol}) must equal "
                f"ensemble capacity ({ens['capacity']})")
        t = TMMCMol(system, params, activity=float(ens["activity"]),
                    p_exchange=float(ens.get("p_exchange", 0.3)),
                    n_orient=int(ens.get("n_orient", 1)), **common)
    else:
        if "melt_blocks" in ens:
            raise ValueError("melt_blocks applies only to molecular TMMC "
                             "(monatomic lattice starts relax within the "
                             "first block)")
        t = TMMC(system, params, activity=float(ens["activity"]),
                 capacity=int(ens["capacity"]), **common)
    n_init = ens["n_init"]
    if isinstance(n_init, (list, tuple)):
        lo, hi = n_init
        n_init = np.linspace(float(lo), float(hi),
                             r.n_chains).astype(np.int32)
    else:
        n_init = int(n_init)
    state = t.init(box=box, n_init=n_init, n_chains=r.n_chains)
    melt = int(ens.get("melt_blocks", 0))
    discard = int(ens.get("discard_blocks", 0))
    if melt:
        from metropolismontecarlo_tpu_torch.mc.gcmc_mol import MolGCMC
        g0 = MolGCMC(system, params, activity=float(ens["activity"]),
                     p_exchange=0.0, **common)
        for block in range(melt):
            state, stats = g0.run_block(state, r.n_steps)
            r.say(f"melt {block:4d}  <E> {stats['energy_mean']:.1f}  "
                  f"accT {stats['acc_trans']:.3f}  "
                  f"drift {stats['drift_max_rel']:.2e}")
            r.logger.write(dict(stats, block=block, phase="melt"))
    for block in range(r.n_blocks):
        state, stats = t.run_block(state, r.n_steps)
        if block + 1 == discard:
            t.reset_collection()
        r.say(f"blk {block:4d}  N [{stats['n_min']},{stats['n_max']}]  "
              f"<N> {stats['n_mean']:8.2f}  "
              f"visited {stats['visited_frac']:.2f}  "
              f"accI {stats['acc_insert']:.3f}  "
              f"accD {stats['acc_delete']:.3f}  "
              f"drift {stats['drift_max_rel']:.2e}")
        r.logger.write(dict(stats, block=block,
                            phase="burnin" if block < discard else "prod"))
    lnpi = t.lnpi()
    if r.out_dir:
        fin = np.isfinite(lnpi)
        with open(r.path("lnpi.txt"), "w") as f:
            f.write("# N  lnPi  (z0 = %g)\n" % t.activity)
            for n_, v in zip(np.where(fin)[0], lnpi[fin]):
                f.write(f"{n_} {v:.8f}\n")
    if ens.get("coexistence"):
        try:
            res = coexistence(lnpi, t.activity, box**3)
            gamma = surface_tension(res["lnpi_coex"], box,
                                    params.temperature)
            r.say(f"coexistence: z* = {res['z_coex']:.6g}  "
                  f"rho_vap = {res['rho_vap']:.6g}  "
                  f"rho_liq = {res['rho_liq']:.6g}  gamma = {gamma:.6g}")
            r.logger.write({"phase": "coexistence", "z_coex": res["z_coex"],
                            "rho_vap": res["rho_vap"],
                            "rho_liq": res["rho_liq"], "gamma": gamma})
        except ValueError as err:
            print(f"coexistence solve failed: {err}")
    r.logger.close()
    r.say("done.")
    return state


def _run_semigrand(cfg, system, params, dtype, args, device):
    """Semigrand: `"ensemble": {"kind": "semigrand", "fugacity_ratio",
    "box", "n_a", "n_b", "p_flip", "n_orient", "mega"}` on a
    two-species-block system."""
    from metropolismontecarlo_tpu_torch.mc.semigrand import Semigrand

    r = _Run(cfg, args, device, 1000)
    ens = r.ens
    g = Semigrand(system, params,
                  fugacity_ratio=float(ens["fugacity_ratio"]),
                  p_flip=float(ens.get("p_flip", 0.3)), dtype=dtype,
                  n_orient=int(ens.get("n_orient", 1)),
                  mega=ens.get("mega"), device=device,
                  generator=r.generator)
    state = g.init(box=float(ens["box"]), n_a=int(ens["n_a"]),
                   n_b=int(ens["n_b"]), n_chains=r.n_chains)
    state, averages = _ensemble_blocks(r, g, state, line=lambda b, s: (
        f"blk {b:4d}  <N_B> {s['nb_mean']:9.3f}  "
        f"x_B {s['nb_mean'] / s['n_tot_mean']:.4f}  "
        f"accAB {s['acc_flip_ab']:.3f}  accBA {s['acc_flip_ba']:.3f}  "
        f"drift {s['drift_max_rel']:.2e}"))
    if averages.blocks:
        r.say(f"production averages over {len(averages.blocks)} blocks: "
              f"<N_B> = {averages.mean('nb_mean'):.3f} "
              f"+- {averages.sem('nb_mean'):.3f}")
        r.say("done.")
    return state


def _run_gibbs(cfg, system, params, dtype, args, device):
    """Gibbs ensemble: `"ensemble": {"kind": "gibbs", "boxes": [L1, L2],
    "n_init": [n1, n2], "capacity", "dv_max", "p_transfer", "n_orient",
    "mega"}` (monatomic: mc/gibbs.py GibbsEnsemble; rigid molecules:
    mc/gibbs_mol.py MolGibbsEnsemble, whose per-box capacity is the
    model's n_mol), or `{"kind": "gibbs_binary", "boxes", "n_init": [[n0
    box 1, n0 box 2], [n1 box 1, n1 box 2]], "dv_max", "p_transfer",
    "n_orient", "mega", "pressure"}` on a two-species-block model
    (mc/gibbs_binary.py BinaryGibbsEnsemble; a "pressure" in K/A^3 runs
    constant-pressure Gibbs)."""
    r = _Run(cfg, args, device, 10000)
    ens = r.ens
    common = dict(dv_max=float(ens.get("dv_max", 0.03)), dtype=dtype,
                  mega=ens.get("mega"), device=device, generator=r.generator)
    binary = ens.get("kind") == "gibbs_binary"
    if binary:
        from metropolismontecarlo_tpu_torch.mc.gibbs_binary import (
            BinaryGibbsEnsemble,
        )
        npt_p = ens.get("pressure")
        g = BinaryGibbsEnsemble(
            system, params, p_transfer=float(ens.get("p_transfer", 0.3)),
            n_orient=int(ens.get("n_orient", 1)),
            npt_pressure=None if npt_p is None else float(npt_p), **common)
    elif system.atoms_per_mol > 1:
        from metropolismontecarlo_tpu_torch.mc.gibbs_mol import (
            MolGibbsEnsemble,
        )
        if int(ens["capacity"]) != system.n_mol:
            raise ValueError(
                f"molecular Gibbs: model n_mol ({system.n_mol}) must equal "
                f"ensemble capacity ({ens['capacity']}) - the molecule "
                "slots are the system's molecules")
        g = MolGibbsEnsemble(system, params,
                             p_transfer=float(ens.get("p_transfer", 0.3)),
                             n_orient=int(ens.get("n_orient", 1)), **common)
    else:
        from metropolismontecarlo_tpu_torch.mc.gibbs import GibbsEnsemble
        unsupported = {"p_transfer", "n_orient"} & set(ens)
        if unsupported:
            raise ValueError(
                f"ensemble keys {sorted(unsupported)} apply only to "
                "molecular (P > 1) Gibbs; the monatomic app splits moves "
                "by params.p_translate and needs no orientations")
        g = GibbsEnsemble(system, params, capacity=int(ens["capacity"]),
                          **common)
    n_init = [tuple(int(n) for n in row) for row in ens["n_init"]] \
        if binary else tuple(int(n) for n in ens["n_init"])
    state = g.init(boxes=tuple(float(b) for b in ens["boxes"]),
                   n_init=n_init, n_chains=r.n_chains)

    def line(b, s):
        head = f"blk {b:4d}  rho_l {s['rho_liq']:.4f}  " \
            f"rho_v {s['rho_vap']:.4f}  "
        if binary:
            return head + (f"x0_l {s['x0_liq']:.3f}  x0_v {s['x0_vap']:.3f}  "
                           f"accX {s['acc_transfer0']:.3f}/"
                           f"{s['acc_transfer1']:.3f}  "
                           f"accV {s['acc_vol']:.3f}  "
                           f"drift {s['drift_max_rel']:.2e}")
        return head + (f"accX {s['acc_transfer']:.3f}  "
                       f"accV {s['acc_vol']:.3f}  full {s['full_frac']:.3f}  "
                       f"drift {s['drift_max_rel']:.2e}")

    state, averages = _ensemble_blocks(r, g, state, line=line)
    if averages.blocks:
        r.say(f"production averages over {len(averages.blocks)} blocks: "
              f"rho_liq = {averages.mean('rho_liq'):.4f} "
              f"+- {averages.sem('rho_liq'):.4f}   "
              f"rho_vap = {averages.mean('rho_vap'):.4f} "
              f"+- {averages.sem('rho_vap'):.4f}")
        r.say("done.")
    return state


def _ewald_box(run_cfg, system, base_dir):
    """The box the Ewald parameters are tuned at: an ensemble's own box;
    for Gibbs the largest box the volume exchange can reach,
    (V1 + V2)^(1/3) (kappa = kappa_L / box shrinks with the box, so the
    real-space truncation is worst there, and nk grows with it); else the
    start box."""
    ens = run_cfg.get("ensemble")
    if ens and "box" in ens:
        return float(ens["box"])
    if ens and "boxes" in ens:
        box0 = float(sum(float(b) ** 3 for b in ens["boxes"])) ** (1 / 3)
        if "pressure" in ens:
            # NPT-Gibbs boxes are not bounded by the initial total volume
            box0 = max(box0, 1.4 * max(float(b) for b in ens["boxes"]))
        return box0
    return _start_box(run_cfg, system, base_dir)


def main(argv=None, device="cuda"):
    """Run a configuration; returns the final state.  device: the card
    unless the caller passes "cpu"; without a CUDA device the default
    raises."""
    ap = argparse.ArgumentParser(prog="metropolismontecarlo_tpu_torch")
    ap.add_argument("config", help="JSON run configuration")
    ap.add_argument("--resume", help="checkpoint .npz to resume from")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLI runs on the GPU; call "
                           "main(argv, device='cpu') to run on the CPU")
    # S(k) phases need full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = _config.load_config(args.config)
    base_dir = os.path.dirname(os.path.abspath(args.config))
    run_cfg = cfg.get("run", {})
    out_dir = run_cfg.get("output", {}).get("dir")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ens = run_cfg.get("ensemble")
    kind = ens.get("kind") if ens else None
    if not args.quiet:
        banner()

    system = _config.build_system(cfg, base_dir)
    params = _config.build_params(cfg)
    ewald_tol = cfg.get("params", {}).get("ewald_tol")
    if ewald_tol and params.coulomb == "ewald":
        from metropolismontecarlo_tpu_torch.ops.ewald import tune_parameters
        box0 = _ewald_box(run_cfg, system, base_dir)
        kl, nk, ksq = tune_parameters(box0, params.qq_cut, float(ewald_tol))
        params = dataclasses.replace(params, kappa_L=kl, nk=nk, ksq_max=ksq)
        if not args.quiet:
            print(f"ewald tuned to tol {ewald_tol:g} at box {box0:.3f}: "
                  f"kappa_L = {kl:.3f}, nk = {nk}, ksq_max = {ksq}")
    dtype = torch.float64 if run_cfg.get("dtype") == "float64" \
        else torch.float32

    runner = {"gcmc": _run_gcmc, "binary": _run_gcmc,
              "osmotic": _run_gcmc, "tmmc": _run_tmmc, "gibbs": _run_gibbs,
              "gibbs_binary": _run_gibbs,
              "semigrand": _run_semigrand}.get(kind)
    if runner is not None:
        return runner(cfg, system, params, dtype, args, device)
    return _run_nvt(cfg, system, params, dtype, args, device, base_dir)


def _run_nvt(cfg, system, params, dtype, args, device, base_dir):
    """NVT / NPT on MonteCarlo, with the options of the run section."""
    r = _Run(cfg, args, device, 100)
    run_cfg, out_cfg = r.run_cfg, r.out_cfg
    rc = run_cfg.get("recompute_chunk", "auto")
    pl_cfg = run_cfg.get("pressure_ladder")
    pressure_ladder = None
    if pl_cfg:
        lo, hi = float(pl_cfg["p_min"]), float(pl_cfg["p_max"])
        spacing = np.geomspace if pl_cfg.get("spacing", "geometric") \
            == "geometric" else np.linspace
        pressure_ladder = spacing(lo, hi, r.n_chains)
    mc = MonteCarlo(system, params, device=device, generator=r.generator,
                    dtype=dtype,
                    recompute_chunk=rc if rc in ("auto", None) else int(rc),
                    pressure_ladder=pressure_ladder)

    if args.resume:
        state, meta, gen_state = load_state(args.resume, device, dtype)
        first_block = int(meta.get("block", 0))
        if gen_state is None:
            print(f"{args.resume} holds no generator state (a checkpoint "
                  f"of the JAX package): its per-chain keys are ignored "
                  f"and the generator is seeded from run.seed = {r.seed}")
        else:
            r.generator.set_state(gen_state)
        # the sorted-slab windows, sized from the resumed configuration
        state = mc.retune_slabs(state)
        print(f"resumed from {args.resume} at block {first_block}")
    else:
        state = _initial_state(mc, run_cfg, system, base_dir)
        first_block = 0

    remc_cfg = run_cfg.get("remc")
    if remc_cfg and not args.resume:
        from metropolismontecarlo_tpu_torch.parallel.remc import (
            temperature_ladder,
        )
        state = dataclasses.replace(state, temp=temperature_ladder(
            float(remc_cfg["t_min"]), float(remc_cfg["t_max"]),
            state.temp.shape[0], dtype=state.temp.dtype, device=device))
    quench_steps = int(run_cfg.get("quench_steps", 0))
    if quench_steps and not args.resume:
        state = mc.quench(state, quench_steps)
    anneal_cfg = run_cfg.get("anneal")

    rdf = sk = dipole = cvacc = nptfl = None
    if "rdf" in out_cfg:
        c = out_cfg["rdf"]
        rdf = RDFAccumulator(system, int(c.get("type_i", 0)),
                             int(c.get("type_j", 0)),
                             float(c.get("r_max", params.r_cut)),
                             int(c.get("n_bins", 200)))
    if "sk" in out_cfg:
        c = out_cfg["sk"]
        sk = StructureFactorAccumulator(
            system, type_sel=c.get("type"), n_max=int(c.get("n_max", 6)),
            chunk=mc.recompute_chunk)
    # fluctuation observables pool chains: none on REMC ladders
    if out_cfg.get("dielectric") and not remc_cfg:
        dipole = DipoleAccumulator(system, chunk=mc.recompute_chunk)
    if out_cfg.get("heat_capacity") and not remc_cfg:
        cvacc = EnergyFluctuations()
    if out_cfg.get("npt_fluctuations") and not remc_cfg \
            and params.p_volume > 0 and pressure_ladder is None:
        nptfl = NPTFluctuations(pressure=params.pressure)
    widom_cfg = out_cfg.get("widom")
    widom_b = []
    averages = BlockAverager()
    pdb_every = int(out_cfg.get("pdb_every", 0))
    tail_args = None
    if params.lj_shift == "none":
        tail_args = (np.asarray(system.type_counts, np.float64),
                     torch.as_tensor(np.array(system.eps_table), dtype=dtype),
                     torch.as_tensor(np.array(system.sig_table), dtype=dtype))

    for block in range(first_block, r.n_blocks):
        adjust = block < r.equil
        if anneal_cfg and adjust and r.equil > 0:
            frac = block / max(r.equil - 1, 1)
            t_start = float(anneal_cfg["t_start"])
            t_b = t_start * (params.temperature / t_start) ** frac
            state = dataclasses.replace(
                state, temp=torch.full_like(state.temp, t_b))
        elif anneal_cfg and block == r.equil:
            state = dataclasses.replace(
                state, temp=torch.full_like(state.temp, params.temperature))
        state, metrics = mc.run_block(state, r.n_steps, adjust=adjust)
        if block == r.equil - 1:
            # equilibrated: re-size the sorted-slab windows from the fluid
            state = mc.retune_slabs(state)
        if remc_cfg:
            from metropolismontecarlo_tpu_torch.parallel.remc import exchange
            state, swap_frac = exchange(
                state, seeded_generator(device, r.seed + REMC_SEED_OFFSET,
                                        block), block % 2)
            metrics["remc_swap_frac"] = float(swap_frac)
        # the virial pressure of the block-end recompute; for
        # cut-unshifted LJ the impulsive term is reported beside it
        vol = float(torch.mean(state.box.double() ** 3))
        metrics["pressure_mean"] = float(energy_model.pressure(
            params, system.n_mol, vol, metrics["virial_mean"]))
        if tail_args is not None:
            from metropolismontecarlo_tpu_torch.ops.tail import (
                impulsive_pressure,
            )
            metrics["pressure_trunc_corr"] = float(impulsive_pressure(
                *tail_args, params.r_cut, vol))
        if not adjust:
            for acc in (rdf, sk, cvacc, nptfl):
                if acc is not None:
                    acc.update(state)
            if dipole is not None:
                dipole.update(state)
                metrics["epsilon_running"] = dipole.result()["epsilon"]
            if widom_cfg:
                w = mc.widom(state, int(widom_cfg.get("n_insertions", 64)),
                             species=int(widom_cfg.get("species", 0)),
                             generator=seeded_generator(
                                 device, r.seed + WIDOM_SEED_OFFSET, block))
                bmean = float(torch.mean(w["boltzmann_mean"]))
                widom_b.append(bmean)
                metrics["widom_boltzmann_mean"] = bmean
        r.say(block_line(block, metrics))
        r.logger.write(dict(metrics, block=block,
                            phase="equil" if adjust else "prod"))
        if not adjust:
            averages.add(**{k: v for k, v in metrics.items()
                            if isinstance(v, float)})
        if r.out_dir and pdb_every and (block + 1) % pdb_every == 0:
            from metropolismontecarlo_tpu_torch.io.pdb import write_pdb
            n = system.n_atoms
            names = [f"T{t}" for t in system.flat(system.type_ids)]
            write_pdb(r.path(f"frame_{block + 1}.pdb"),
                      state.coords[0].T[:n].cpu().numpy(), names,
                      [system.name[:3].upper()] * n,
                      system.atom_mol_slot[0] + 1,
                      box=float(state.box[0]))
        if r.checkpoint_due(block):
            save_state(r.path("checkpoint.npz"), state,
                       metadata={"block": block + 1}, generator=r.generator)

    if rdf is not None and r.out_dir:
        np.savetxt(r.path("rdf.txt"), np.column_stack(rdf.result()),
                   header="r g(r)")
    if sk is not None and r.out_dir and sk.n_samples:
        np.savetxt(r.path("sk.txt"), np.column_stack(sk.result()),
                   header="k S(k)")
    final_obs = {}
    if dipole is not None and dipole.n_samples:
        d = dipole.result()
        final_obs.update(epsilon=d["epsilon"], g_kirkwood=d["g_kirkwood"])
    if cvacc is not None and cvacc.n_samples > 1:
        final_obs["cv_excess"] = cvacc.result()["cv_excess"]
    if nptfl is not None and nptfl.n > 1:
        f = nptfl.result()
        final_obs.update(kappa_T=f["kappa_T"], alpha_P=f["alpha_P"],
                         cp_conf=f["cp_conf"])
    if widom_b:
        bmean = float(np.mean(widom_b))
        final_obs["widom_boltzmann_mean"] = bmean
        final_obs["mu_excess"] = -params.temperature * math.log(bmean) \
            if bmean > 0.0 else float("inf")
    if final_obs:
        r.logger.write(dict(final_obs, phase="final"))
        r.say("observables: " + "  ".join(
            f"{k} = {v:.6g}" for k, v in final_obs.items()))
    if r.out_dir:
        save_state(r.path("final.npz"), state,
                   metadata={"block": r.n_blocks}, generator=r.generator)
    r.logger.close()
    if averages.blocks:
        r.say(f"production averages over {len(averages.blocks)} blocks: "
              f"<E> = {averages.mean('energy_mean'):.4f} "
              f"+- {averages.sem_blocking('energy_mean'):.4f}   "
              f"<P> = {averages.mean('pressure_mean'):.6f} "
              f"+- {averages.sem_blocking('pressure_mean'):.6f}")
    r.say("done.")
    return state


if __name__ == "__main__":
    main()
