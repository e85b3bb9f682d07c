"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.core.cell import Cell, reference_config
from conftest import REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for name in m["workloads"]:
            reported = {e["name"] for e in Cell(REPO, name).end_to_end()}
            assert m["moves"] in reported, (m["name"], name)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = Cell(REPO, name)
    assert cell.config["name"] == cell.entry["config"]
    conf = next(c for c in BENCH["configs"] if c["name"] == cell.entry["config"])
    assert (REPO / conf["file"]).is_file() and conf["reduced"] == cell.config["reduced"]
    assert callable(cell.traffic().run)
    per_layer = cell.per_layer()
    assert per_layer and {m["name"] for m in cell.end_to_end()} >= {"setup_s"}
    for m in per_layer:
        assert callable(cell.reader(m["name"]))
    cf = reference_config(cell.config)
    assert list(cf.patch_size) == [128, 128, 64] and cf.start_filts == 18 and cf.end_filts == 36


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    root = make_root(tmp_path, ["lidc3d_retina_unet.train"])
    cell = Cell(root, "tiny_lidc3d_retina_unet.train")
    assert cell.config["name"] == "tiny_lidc3d_retina_unet" and cell.params["pool_batches"] == 3
    assert {m["name"] for m in cell.per_layer()} == {m["name"] for m in Cell(REPO, "lidc3d_retina_unet.train").per_layer()}
    for path in (REPO / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and ".cache" not in path.parts and \
                "tests" not in path.parts:
            copy = root / path.relative_to(REPO)
            assert copy.read_bytes() == path.read_bytes(), path
