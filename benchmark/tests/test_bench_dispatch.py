"""``run.py`` runs a cell by the ``entry`` of its workload file: every
closed-loop cell reaches ``closed_loop.run`` with the arguments it has
always had, and a machine with fewer cards than a cell asks for gets exit
3 and no result line."""
import json

import pytest

from benchmark import run
from benchmark.harness import closed_loop, manifest

MAN = manifest.manifest()
CLOSED = [w["name"] for w in MAN["workloads"]
          if manifest.cell_files(w["name"])[0]["entry"] == "closed_loop"]


class Reached(Exception):
    pass


@pytest.mark.parametrize("cell", CLOSED)
def test_closed_loop_cells_reach_closed_loop_run(monkeypatch, cell):
    def recorder(*a, **k):
        raise Reached(a, k)

    monkeypatch.setattr(closed_loop, "run", recorder)
    _, _, spec, cfg, mix = manifest.cell(cell)
    args = run.parse_args(["--workload", cell, "--seed", "2147483711", "--seconds", "20",
                           "--trace", "1"])
    assert run.ENTRIES[spec["entry"]] is run.closed_loop_cell
    with pytest.raises(Reached) as got:
        run.ENTRIES[spec["entry"]](args, spec, cfg, mix)
    a, k = got.value.args
    assert a == (spec, cfg, mix, 2147483711, 20.0, True, "cuda", run.T_START) and k == {}


def test_every_cell_has_an_entry():
    for w in MAN["workloads"]:
        assert manifest.cell_files(w["name"])[0]["entry"] in run.ENTRIES


def _with_sweep_cell():
    """BENCHMARK.json with the sweep cell's entries (its files are in
    ``workloads/``, ``configs/`` and ``traffic/``)."""
    spec, cfg, _ = manifest.cell_files("sweep-h10-dr-x4")
    man = json.loads(json.dumps(MAN))
    if "sweep-h10-dr-x4" not in [w["name"] for w in man["workloads"]]:
        man["workloads"].append({k: spec[k] for k in ("name", "config", "traffic", "chips",
                                                      "why")})
    return man


@pytest.mark.parametrize("cell, cards", [("srb-h16-trot-admm", 0), ("sweep-h10-dr-x4", 0),
                                         ("sweep-h10-dr-x4", 1), ("sweep-h10-dr-x4", 3)])
def test_too_few_cards_exits_3_without_a_result(monkeypatch, capsys, cell, cards):
    import torch

    man = _with_sweep_cell()
    monkeypatch.setattr(manifest, "manifest", lambda root=manifest.ROOT: man)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(run, "fixed_caches", lambda: None)
    chips = next(w["chips"] for w in man["workloads"] if w["name"] == cell)
    rc = run.main(["--workload", cell, "--seed", "7", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 3 and out == "" and f"needs {chips} CUDA card(s)" in err
