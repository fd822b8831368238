"""JSON run configuration (counterpart of
metropolismontecarlo_tpu/utils/config.py, same schema): one document
describes the model, the RunParams and the run schedule.

    {"model":  {"kind": "spce" | "tip3p" | "co2" | "n2" | "lj" |
                        "triatomic", "n_mol": 750, ...},
     "params": {... RunParams fields ..., "ewald_tol": 1e-5},
     "run":    {"n_chains", "n_blocks", "n_steps", "equil_blocks", "seed",
                "dtype", "recompute_chunk", "pressure_ladder", "remc",
                "quench_steps", "anneal", "ensemble", "start", "output"}}

See the JAX module's docstring for every key of "run".  The model kinds
"tip4p2005", "tip4pew", "tip4pice" and "topology" are not ported yet and
raise NotImplementedError.
"""

import dataclasses
import json

from metropolismontecarlo_tpu_torch.models.system import RunParams

NOT_PORTED_MODELS = {
    "tip4p2005": "the TIP4P family (ROADMAP queue 1 step 8)",
    "tip4pew": "the TIP4P family (ROADMAP queue 1 step 8)",
    "tip4pice": "the TIP4P family (ROADMAP queue 1 step 8)",
    "topology": "io/topology.py and models/from_topology.py (ROADMAP "
                "queue 1 step 8)",
}


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
    """The System of the "model" section.  base_dir is where a model's
    files would be read from (the topology kind, not ported yet)."""
    model = cfg["model"]
    kind = model["kind"].lower()
    if kind in NOT_PORTED_MODELS:
        raise NotImplementedError(
            f"model kind {kind!r} needs {NOT_PORTED_MODELS[kind]}, which "
            "the PyTorch port does not have yet")
    n = int(model["n_mol"])
    if kind == "spce":
        from metropolismontecarlo_tpu_torch.models.water import spce_system
        return spce_system(n)
    if kind == "tip3p":
        from metropolismontecarlo_tpu_torch.models.water import tip3p_system
        return tip3p_system(n)
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
