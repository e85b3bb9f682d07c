"""The bound of ``k5_roofline.train`` (``core/wgrad.py``): which convs of
the two LIDC training cells K5's gate admits, their share of the step's
multiply-adds, the least time, and the metric's reading from a trace."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

from benchmark.core import wgrad, work
from benchmark.core.cell import Cell, reference_config
from conftest import REPO


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,n_convs,share", [("lidc3d_retina_unet", 62, 0.792), ("lidc3d_mrcnn", 29, 0.832)])
def test_admitted_convs_and_their_share(name, n_convs, share):
    """62 conv calls a Retina U-Net step (79.2% of its forward's 1,232
    GMAC: the 63 with a kernel larger than 1 and cin > 2, 98.1%, less the
    strided 7x7x7 stem, 18.9%, which the gate leaves to cuDNN), 29 a Mask
    R-CNN step (83.2% of the differentiated 160.7 GMAC); none of them 1x1x1,
    strided or the 1-channel stem."""
    config = _config(name)
    rows, total = wgrad.convs(reference_config(config), config["model"])
    assert len(rows) == n_convs
    assert sum(r[3] for r in rows) / total == pytest.approx(share, abs=5e-4)
    assert all(math.prod(w[2:]) > 1 and x[1] > 2 for x, w, _, _ in rows)
    assert all(dy[2:] == x[2:] or w[2:] == (7, 7, 3) for x, w, dy, _ in rows)
    assert total / 1e9 == pytest.approx({"lidc3d_retina_unet": 1232.03, "lidc3d_mrcnn": 160.68}[name], abs=0.01)


def test_bound_of_a_step():
    """Each admitted conv is bound by its operations at these widths: the
    step's bound is 2 x their MACs at 67 TFLOP/s (1.951 TFLOP a Retina U-Net
    step, 29 ms); None where the configuration runs bfloat16 or TF32."""
    config = _config("lidc3d_retina_unet")
    cf = reference_config(config)
    rows, _ = wgrad.convs(cf, "retina_unet")
    flop = 2.0 * sum(r[3] for r in rows)
    assert flop / 1e12 == pytest.approx(1.951, abs=1e-3)
    assert wgrad.k5_bound_s(cf, "retina_unet", config["precision"]) == pytest.approx(flop / work.PEAK_FLOPS["float32"])
    assert wgrad.k5_bound_s(cf, "retina_unet", {"dtype": "bfloat16", "tf32": False}) is None
    assert wgrad.k5_bound_s(cf, "retina_unet", {"dtype": "float32", "tf32": True}) is None
    assert wgrad.k5_bound_s(cf, "detection_unet", config["precision"]) is None


def test_gate_rule():
    import torch.nn as nn

    assert wgrad.admitted(nn.Conv3d(4, 8, 3, padding=1), (2, 4, 8, 8, 8))
    assert wgrad.admitted(nn.Conv3d(4, 8, (7, 7, 3)), (2, 4, 8, 8, 8))
    assert not wgrad.admitted(nn.Conv3d(4, 8, 7, stride=(2, 2, 1), padding=3), (2, 4, 8, 8, 8))
    for conv, shape in ((nn.Conv3d(4, 8, 1), (2, 4, 8, 8, 8)), (nn.Conv3d(2, 8, 3, padding=1), (2, 2, 8, 8, 8)),
                        (nn.Conv3d(4, 8, 3, stride=2, padding=1), (2, 4, 8, 8, 8)),
                        (nn.Conv3d(4, 8, 3, padding=3), (2, 4, 8, 8, 8)),
                        (nn.Conv3d(4, 8, 3, dilation=2), (2, 4, 8, 8, 8)), (nn.Conv2d(4, 8, 3), (2, 4, 8, 8))):
        assert not wgrad.admitted(conv, shape)


@pytest.mark.parametrize("launched", [True, False])
def test_metric_reads_the_kernels_time(launched):
    """Bound x steps over the two kernels' time; None in a trace without
    K5 (the parent commit)."""
    cell = Cell(REPO, "lidc3d_mrcnn.train")
    cf = reference_config(cell.config)
    bound = wgrad.k5_bound_s(cf, "mrcnn", cell.config["precision"])
    kernels = [("void conv3d_wgrad_partial_kernel<8, 3, 4>", 0.0, 400.0), ("conv3d_wgrad_reduce_kernel", 0.0, 100.0),
               ("wgrad2d_grouped_direct_kernel", 0.0, 900.0)] if launched else [("cudnn_wgrad", 0.0, 900.0)]
    run = SimpleNamespace(kind="train", trace={"kernels": kernels}, requests=4, ref_cf=cf, cell=cell)
    value = cell.reader("k5_roofline.train")(run)
    if launched:
        assert value == pytest.approx(bound * 4 / 500e-6 * 100)
    else:
        assert value is None
    assert cell.reader("k5_roofline.train")(SimpleNamespace(kind="infer", trace={"kernels": kernels})) is None
