"""BENCHMARK.json against the contract, and every cell and metric resolved
to its files by name."""

import json
import os
import re

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for word in s["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_bounds():
    s = spec()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_every_cell_resolves_to_its_files():
    s = spec()
    for w in s["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = harness.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "drivers", cell.traffic["driver"] + ".py"))
        harness.driver(cell)
        reported = [m for m in s["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert cell.traffic["metric"] in [m["name"] for m in reported]
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in s["per_layer"])
    for c in s["configs"]:
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_every_metric_has_its_reader():
    for m in spec()["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_every_limit_a_cell_compares_is_set():
    for w in spec()["workloads"]:
        cell = harness.resolve(w["name"])
        assert all(v >= 0 for v in cell.config["limits"].values())
