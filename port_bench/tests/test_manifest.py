"""``BENCHMARK.json`` against the contract's shape, and every file and
reader it names."""

import json
import os
import re

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = harness.manifest()


def test_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["port_bench"]
    assert 1 <= B["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200
    assert len(json.dumps(B)) <= 64 * 1024


def test_names_and_units():
    every = (B["configs"] + B["workloads"] + B["end_to_end"]
             + B["per_layer"])
    for e in every:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[kind]]
        assert len(names) == len(set(names))
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_entries_have_only_their_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert "\t" not in c["why"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_references_resolve():
    cells = {w["name"] for w in B["workloads"]}
    configs = {c["name"] for c in B["configs"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for w in B["workloads"]:
        assert w["config"] in configs
        assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                           f"{w['traffic']}.json"))
    for c in B["configs"]:
        assert c["file"].startswith("port_bench/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(harness.HERE, "limits",
                                           f"{c['name']}.json"))
    assert configs == {w["config"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in B["configs"]])
def test_config_runs_the_shipped_yaml(name):
    import yaml

    doc = harness.load_json("configs", f"{name}.json")
    with open(os.path.join(harness.ROOT, doc["shipped_yaml"])) as f:
        assert yaml.safe_load(f) == doc["yaml"]
