"""``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def cell_files(name: str):
    """(the cell file, its config, its traffic mix), by the cell's name."""
    spec = load_json("workloads", name)
    return spec, load_json("configs", spec["config"]), load_json("traffic", spec["traffic"])


def cell(name: str, root: Path = ROOT):
    """(manifest, its workload entry, the cell file, config, traffic mix)."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec, cfg, mix = cell_files(name)
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json's {key} differs from BENCHMARK.json's")
    return man, entry, spec, cfg, mix


def metrics_of(man: dict, cell_name: str, group: str) -> list:
    """The ``group`` (``end_to_end`` or ``per_layer``) metrics this cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in man[group] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read(rec, cell, cfg)`` of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
