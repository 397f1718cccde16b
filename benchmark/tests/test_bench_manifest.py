"""BENCHMARK.json against the contract it is written to, and the files it
names."""
import json
import re

import pytest

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = manifest.manifest()
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    cells = 24
    assert 2 + 14 * cells * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_entries(group):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = [e["name"] for e in MAN[group]]
    assert len(set(names)) == len(names)
    for e in MAN[group]:
        assert set(e) <= allowed[group]
        assert NAME.match(e["name"])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if group == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and e["chips"] in (1, 4)


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_file_is_found_by_name():
    configs = {c["name"]: c for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = manifest.load_json("configs", c["name"])
        assert all(k in data for k in c["reduced"]) and data["reduced"] == c["reduced"]
    used = set()
    for w in MAN["workloads"]:
        _, entry, spec, cfg, mix = manifest.cell(w["name"])
        assert w["config"] in configs and cfg["name"] == w["config"] and mix["name"] == w["traffic"]
        assert spec["why"] == w["why"]
        used.add(w["config"])
    assert used == set(configs)
    for m in MAN["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_pairs_and_chips():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = [m["name"] for m in manifest.metrics_of(MAN, cell, "end_to_end")]
    per = manifest.metrics_of(MAN, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in e2e


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers <= {"closed loop", "solve tick", "kernels", "device", "sweep"}
