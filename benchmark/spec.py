"""BENCHMARK.json and the files it names: configurations, traffic mixes,
limits, ensembles, references and per-layer readers, each found by its
name, so that a cell, a configuration or a metric is added by adding
files and entries."""

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return _json(ROOT / "BENCHMARK.json")


def config(name):
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name):
    return _json(HERE / "traffic" / f"{name}.json")


def limits(workload):
    return _json(HERE / "limits" / f"{workload}.json")


def ensemble(kind):
    return importlib.import_module(f"benchmark.ensembles.{kind}")


def reference(name):
    return importlib.import_module(f"benchmark.reference.{name}")


def reader(metric):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end(bench, name):
    """The end-to-end metric entries the cell `name` reports."""
    return [m for m in bench["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(bench, name):
    """The per-layer metric entries the cell reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, name)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
