"""Shared fixtures of the benchmark's tests, and the ``card`` marker: a test
marked ``card`` needs a CUDA card and skips without one (decided inside the
fixture, never while a module is imported). Run them on the card with
``python3 -m pytest benchmark/tests -m card``."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on the CPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_config(config: dict) -> dict:
    """A configuration file shrunk to a CPU test's size: patch 64x64x16,
    narrow widths, few candidates; the structure and every other key as
    the full one."""
    c = copy.deepcopy(config)
    pub = c["published"]
    pub.update(patch_size=[64, 64, 16], start_filts=4, end_filts=8, batch_size=2,
               n_rpn_features=8, pre_nms_limit=400, model_max_instances_per_batch_element=6,
               backbone_shapes=[[16, 16, 16], [8, 8, 8], [4, 4, 4], [2, 2, 2]],
               window=[0, 0, 64, 64, 0, 16], scale=[64, 64, 64, 64, 16, 16])
    if c["model"] == "mrcnn":
        pub.update(post_nms_rois_training=20, post_nms_rois_inference=30, roi_chunk_size=25)
    c["name"] = "tiny_" + c["name"]
    return c


def tiny_params(params: dict) -> dict:
    p = copy.deepcopy(params)
    p.update(pool_batches=3, lesion_min=[4, 4, 2], lesion_max=[16, 16, 8])
    if "in_flight" in p:
        p.update(in_flight=2, warmup_chunks=4, judged_chunks=2)
    return p


def make_root(tmp_path: Path, cells) -> Path:
    """A checkout holding ``BENCHMARK.json`` and a copy of ``benchmark/`` with
    a tiny cell added as files for each of ``cells`` (full cell names)."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    for name in cells:
        w = json.loads((REPO / "benchmark" / "workloads" / f"{name}.json").read_text())
        cfg = tiny_config(json.loads((REPO / "benchmark" / "configs" / f"{w['config']}.json").read_text()))
        (root / "benchmark" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        tiny = dict(w, name="tiny_" + name, config=cfg["name"], params=tiny_params(w["params"]))
        (root / "benchmark" / "workloads" / f"{tiny['name']}.json").write_text(json.dumps(tiny))
        bench["workloads"].append(dict(entries[name], name=tiny["name"], config=cfg["name"]))
        if cfg["name"] not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": cfg["name"], "source": "test", "file": "", "reduced": [], "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if name in m.get("workloads", ()):
                m["workloads"].append(tiny["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
