"""The per-layer metrics that read the program's own spans and counters
(``core/program_spans.py``): numbers in a traced run of the program, None
for the control, whose window runs no program code, and for a reading with
no CUDA card behind it (``refine_ms.infer``'s event pairs)."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark import run
from benchmark.core.cell import program_config
from conftest import REPO, make_root

SPAN_METRICS = {
    "lidc3d_retina_unet.train": ("upload_ms.train", "upload_mb.train", "host_wait_ms.train"),
    "lidc3d_mrcnn.train": ("upload_ms.train", "upload_mb.train", "host_wait_ms.train"),
    "lidc3d_retina_unet.infer": ("host_wait_ms.infer", "refine_ms.infer"),
}


def _run(argv, **kwargs):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert run.main(argv, **kwargs) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _tiny(tmp_path, cell, program):
    root = make_root(tmp_path, [cell])
    return _run(["--workload", "tiny_" + cell, "--seed", "3000000101", "--seconds", "1", "--trace", "1"],
                device="cpu", root=root, program=program)["metrics"]


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_cpu_cell_reads_the_program_spans(tmp_path, cell):
    metrics = _tiny(tmp_path, cell, "port")
    for name in SPAN_METRICS[cell]:
        if name == "refine_ms.infer":
            assert name not in metrics  # no event pairs without a CUDA card
        else:
            assert metrics[name]["value"] >= 0.0, name
    if cell.endswith("train"):
        assert metrics["upload_ms.train"]["value"] > 0.0 and metrics["upload_mb.train"]["value"] > 0.0


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_control_reads_no_program_span(tmp_path, cell):
    _tiny(tmp_path, cell, "port")  # a recording of the program left in this process
    metrics = _tiny(tmp_path / "control", cell, "control")
    assert not set(SPAN_METRICS[cell]) & set(metrics)


def test_upload_mb_is_the_arithmetic_of_the_batch(tmp_path):
    """A Retina U-Net step uploads the image (float32) and seg labels
    (int32) of every patch, the padded GT boxes (float32 coordinates, int32
    ids, bool flags) and the refinement's three float32 constants."""
    config = json.loads((REPO / "benchmark" / "configs" / "lidc3d_retina_unet.json").read_text())
    max_gt = program_config(config).max_gt_boxes
    metrics = _tiny(tmp_path, "lidc3d_retina_unet.train", "port")
    voxels = 2 * 64 * 64 * 16  # the tiny configuration's batch of 2 at 64 x 64 x 16
    expected = (voxels * 4 * 2 + 2 * max_gt * (6 * 4 + 4 + 1) + 3 * 6 * 4) / 1e6
    assert metrics["upload_mb.train"]["value"] == pytest.approx(expected, rel=1e-12)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_card_cell_reads_every_span_metric(card, cell):
    metrics = _run(["--workload", cell, "--seed", "3000000103", "--seconds", "3", "--trace", "1"])["metrics"]
    assert all(metrics[name]["value"] >= 0.0 for name in SPAN_METRICS[cell])
