"""JSON run configuration (counterpart of
metropolismontecarlo_tpu/utils/config.py, same schema): one document
describes the model, the RunParams and the run schedule.

    {"model":  {"kind": "spce" | "tip3p" | "tip4p2005" | "tip4pew" |
                        "tip4pice" | "co2" | "n2" | "lj" | "triatomic" |
                        "topology", "n_mol": 750, ...},
     "params": {... RunParams fields ..., "ewald_tol": 1e-5},
     "run":    {"n_chains", "n_blocks", "n_steps", "equil_blocks", "seed",
                "dtype", "recompute_chunk", "pressure_ladder", "remc",
                "quench_steps", "anneal", "ensemble", "start", "output"}}

The topology kind reads a GROMACS topology and PDB templates, paths
relative to the configuration's directory: {"kind": "topology", "top":
"topol.top", "defines": [...], "templates": {"SOL": "tip3p.pdb", ...},
"molecules": [["SOL", 100], ...]} ("defines" and "molecules" optional).
See the JAX module's docstring for every key of "run".
"""

import dataclasses
import json
import os

from metropolismontecarlo_tpu_torch.models.system import RunParams

def load_config(path):
    with open(path) as f:
        return json.load(f)


def build_params(cfg):
    """RunParams from the "params" section.  The pseudo-field "ewald_tol"
    is dropped here: it needs the start box, so run.py applies it."""
    fields = {f.name for f in dataclasses.fields(RunParams)}
    given = dict(cfg.get("params", {}))
    given.pop("ewald_tol", None)
    unknown = set(given) - fields
    if unknown:
        raise ValueError(f"unknown RunParams fields: {sorted(unknown)}")
    return RunParams(**given)


def build_system(cfg, base_dir="."):
    """The System of the "model" section; the topology kind reads its
    files relative to base_dir."""
    model = cfg["model"]
    kind = model["kind"].lower()
    if kind == "topology":
        from metropolismontecarlo_tpu_torch.io.topology import read_top
        from metropolismontecarlo_tpu_torch.models.from_topology import (
            system_from_topology,
            templates_from_pdbs,
        )
        top = read_top(os.path.join(base_dir, model["top"]),
                       defines=model.get("defines", ()))
        templates = templates_from_pdbs(top, {
            k: os.path.join(base_dir, v)
            for k, v in model["templates"].items()})
        molecules = [tuple(x) for x in model["molecules"]] \
            if "molecules" in model else None
        return system_from_topology(top, templates, molecules=molecules,
                                    name=kind)
    n = int(model["n_mol"])
    if kind == "spce":
        from metropolismontecarlo_tpu_torch.models.water import spce_system
        return spce_system(n)
    if kind == "tip3p":
        from metropolismontecarlo_tpu_torch.models.water import tip3p_system
        return tip3p_system(n)
    if kind in ("tip4p2005", "tip4pew", "tip4pice"):
        from metropolismontecarlo_tpu_torch.models import water
        return {"tip4p2005": water.tip4p2005_system,
                "tip4pew": water.tip4pew_system,
                "tip4pice": water.tip4pice_system}[kind](n)
    if kind in ("co2", "n2"):
        from metropolismontecarlo_tpu_torch.models import linear
        return {"co2": linear.co2_system, "n2": linear.n2_system}[kind](n)
    if kind == "lj":
        from metropolismontecarlo_tpu_torch.models.monatomic import lj_system
        return lj_system(n, eps=model.get("eps", 1.0),
                         sigma=model.get("sigma", 1.0))
    if kind == "triatomic":
        from metropolismontecarlo_tpu_torch.models.polyatomic import (
            triatomic_system,
        )
        return triatomic_system(n, alpha_deg=model.get("alpha_deg", 75.0))
    raise ValueError(f"unknown model kind {kind!r}")
