"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import math
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert c["reduced"] == spec.config(c["name"])["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_named_file_loads(w):
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"]
    spec.reference(cfg["reference"])
    traffic = spec.traffic(w["traffic"])
    assert callable(spec.ensemble(traffic["ensemble"]).Cell)
    lim = spec.limits(w["name"])
    assert all(math.isfinite(v["limit"]) for v in lim.values())
    e2e = {m["name"] for m in spec.end_to_end(BENCH, w["name"])}
    assert e2e == {"setup_s", traffic["rate"]}
    layer = spec.per_layer(BENCH, w["name"])
    assert layer
    for m in layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e


def test_per_layer_names_its_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"driver", "recompute", "kernels", "device"}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
