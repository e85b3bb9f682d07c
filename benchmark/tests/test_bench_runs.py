"""Whole runs of tiny cells on the CPU, on the program's plain kernel paths:
the reference agrees with the program, every fault planted in the timed
path makes ``correct`` false, the comparisons' arithmetic, and a run that
finds no card stops without a result."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.core import compare
from conftest import make_root

CELLS = ["lidc3d_retina_unet.train", "lidc3d_retina_unet.infer", "lidc3d_mrcnn.train"]


def _run(tmp_path, cell, trace=0, seed=3_000_000_019):
    root = make_root(tmp_path, [cell])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", "tiny_" + cell, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
                      device="cpu", root=root)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(tmp_path, cell):
    out = _run(tmp_path, cell)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert c["value"] < 1e-5  # the same plain arithmetic on both sides, but for Adam's moment over 1 - beta1
    e2e = {"setup_s"} | ({"train_patches_per_s"} if cell.endswith("train") else {"infer_patches_per_s", "infer_p95_ms"})
    assert set(out["metrics"]) == e2e | {"peak_device_gib"}


def test_traced_run_reports_per_layer_metrics(tmp_path):
    out = _run(tmp_path, "lidc3d_retina_unet.infer", trace=1)
    assert {"host_dispatch_ms.infer", "mfu.infer"} <= set(out["metrics"])
    assert "window_s" in out["device"] and "breakdown" in out


def _unchanged_state(monkeypatch):
    from medicaldetectiontoolkit_torch.models import base

    monkeypatch.setattr(base.Detector, "_update", lambda self: None)


def _half_batch(monkeypatch):
    """Training on the first half of each batch, the mean over those rows."""
    from medicaldetectiontoolkit_torch.models import mrcnn, retina_net

    for cls in (retina_net.RetinaNetDetector, mrcnn.MaskRCNNDetector):
        prep = cls._prep

        def half(self, batch, _prep=prep):
            n = batch["data"].shape[0] // 2
            return _prep(self, {k: v[:n] for k, v in batch.items()})

        monkeypatch.setattr(cls, "_prep", half)


def _one_tensor_left(monkeypatch):
    """The optimizer's step leaves the largest parameter tensor unchanged."""
    from medicaldetectiontoolkit_torch.models import base

    update = base.Detector._update

    def skip_one(self):
        p = max(self.module.parameters(), key=lambda t: t.numel())
        before = p.detach().clone()
        update(self)
        with torch.no_grad():
            p.copy_(before)

    monkeypatch.setattr(base.Detector, "_update", skip_one)


def _altered_loss(monkeypatch):
    from medicaldetectiontoolkit_torch.models import mrcnn, retina_net

    for cls in (retina_net.RetinaNetDetector, mrcnn.MaskRCNNDetector):
        convert = cls.train_forward_convert

        def altered(self, *args, _convert=convert, **kwargs):
            out = _convert(self, *args, **kwargs)
            return dict(out, loss=out["loss"] * 1.001)

        monkeypatch.setattr(cls, "train_forward_convert", altered)


def _served(monkeypatch, change):
    from medicaldetectiontoolkit_torch.models import base

    convert = base.Detector.test_forward_convert

    def altered(self, *args, **kwargs):
        out = convert(self, *args, **kwargs)
        out["boxes"] = change(out["boxes"])
        return out

    monkeypatch.setattr(base.Detector, "test_forward_convert", altered)


def _half_served(monkeypatch):
    _served(monkeypatch, lambda boxes: boxes[:len(boxes) // 2] + [[] for _ in boxes[len(boxes) // 2:]])


def _altered_answer(monkeypatch):
    _served(monkeypatch, lambda boxes: [[dict(r, box_score=r["box_score"] + 1e-3) for r in rows] for rows in boxes])


def _duplicated_answer(monkeypatch):
    """Each element's best detection served twice, as an NMS that keeps an
    overlapping box would serve it."""
    _served(monkeypatch, lambda boxes: [rows + [dict(max(rows, key=lambda r: r["box_score"]))] if rows else rows
                                        for rows in boxes])


TRAIN_FAULTS = (_unchanged_state, _half_batch, _altered_loss, _one_tensor_left)
SERVE_FAULTS = (_half_served, _altered_answer, _duplicated_answer)
FAULTS = [(c, f) for c in ("lidc3d_retina_unet.train", "lidc3d_mrcnn.train") for f in TRAIN_FAULTS] + \
         [("lidc3d_retina_unet.infer", f) for f in SERVE_FAULTS]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(tmp_path, cell)
    assert out["correct"] is False, out["checks"]


def test_no_card_no_result(tmp_path, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "lidc3d_retina_unet.train", "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def _cf():
    from types import SimpleNamespace

    return SimpleNamespace(detection_nms_threshold=1e-5, model_min_confidence=0.1,
                           model_max_instances_per_batch_element=2)


def _cand(boxes, scores, cls=None):
    n = len(scores)
    return {"elem": np.zeros(n, np.int64), "cls": np.ones(n, np.int64) if cls is None else np.asarray(cls),
            "score": np.asarray(scores, np.float32), "box": np.asarray(boxes, np.float32)}


A, B, C = [0, 0, 4, 4, 0, 2], [2, 2, 6, 6, 0, 2], [20, 20, 24, 24, 0, 2]


def _served_of(*dets):
    return [(np.asarray([d[0] for d in dets], np.float64).reshape(-1, 6), np.ones(len(dets), np.int64),
             np.asarray([d[1] for d in dets], np.float64))]


def test_detection_gap_follows_the_programs_choice_at_a_tie():
    cand = _cand([A, B, C], [0.5000001, 0.5, 0.3])
    # the program kept B over A (a tie): B suppresses A, then C
    assert compare.detection_gap(_cf(), _served_of((B, 0.5), (C, 0.3)), cand) == pytest.approx(1e-7, abs=1e-7)
    # the reference's own choice reads 0
    assert compare.detection_gap(_cf(), _served_of((A, 0.5000001), (C, 0.3)), cand) < 1e-7


def test_detection_gap_reads_a_suppressed_or_repeated_detection():
    cand = _cand([A, B, C], [0.6, 0.5, 0.3])
    cf = _cf()
    assert compare.detection_gap(cf, _served_of((A, 0.6), (B, 0.5)), cand) == 1.0  # A suppresses B
    assert compare.detection_gap(cf, _served_of((A, 0.6), (A, 0.6)), cand) == 1.0  # served twice
    assert compare.detection_gap(cf, _served_of((A, 0.6), (C, 0.3)), cand) < 1e-7


def test_a_model_without_a_family_file_stops_the_run(tmp_path):
    import json

    from benchmark.core.cell import Cell

    root = make_root(tmp_path, ["lidc3d_retina_unet.train"])
    path = root / "benchmark" / "configs" / "tiny_lidc3d_retina_unet.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), model="unknown_net")))
    with pytest.raises(SystemExit, match="unknown_net"):
        Cell(root, "tiny_lidc3d_retina_unet.train").family()


def test_detection_gap_reads_errors():
    cand = _cand([A, B, C], [0.6, 0.5, 0.3])
    cf = _cf()
    assert compare.detection_gap(cf, _served_of((B, 0.5), (C, 0.3)), cand) == pytest.approx(0.1, abs=1e-7)  # A was due
    assert compare.detection_gap(cf, _served_of((A, 0.61), (C, 0.3)), cand) == pytest.approx(0.01, abs=1e-7)  # score off
    assert compare.detection_gap(cf, _served_of((A, 0.6),), cand) == pytest.approx(0.2, abs=1e-7)  # C missed
    assert compare.detection_gap(cf, _served_of(([9, 9, 12, 12, 0, 2], 0.6), (C, 0.3)), cand) == 1.0
    assert compare.detection_gap(cf, _served_of(([1, 0, 4, 4, 0, 2], 0.6), (C, 0.3)), cand) < 1e-7  # a rounding
    assert compare.detection_gap(cf, _served_of((A, float("nan")),), cand) == float("inf")


def test_seg_gap_and_train_gaps():
    logits = torch.tensor([[[0.0, 1.0]], [[0.5, 0.2]]]).reshape(1, 2, 2)  # (b, C, voxels)
    assert compare.seg_gap(np.array([[[1, 0]]]), logits) == pytest.approx(0.0)
    assert compare.seg_gap(np.array([[[0, 0]]]), logits) == pytest.approx(0.5)
    g = {"a": torch.ones(4), "b": torch.full((4,), 1e-9)}
    r = compare.train_gaps([1.0], [1.0], g, g, {"a": torch.ones(4) * 2, "b": torch.ones(4)},
                           {"a": torch.ones(4), "b": torch.zeros(4)})
    assert r["loss_gap"] == 0 and r["grad_gap"] == 0 and r["change_gap"] == pytest.approx(1.0) and r["left_out"] == 1
