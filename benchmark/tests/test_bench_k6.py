"""The bound of ``k6_roofline.train`` (``core/pointwise_wgrad.py``): which
convs of the two LIDC training cells K6's gate admits, the least time of a
step, the metric's reading from a trace, and K5's bound left as it was."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmark.core import pointwise_wgrad, wgrad
from benchmark.core.cell import Cell, reference_config
from conftest import REPO


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,n_convs,bound_ms", [("lidc3d_retina_unet", 37, 1.670), ("lidc3d_mrcnn", 44, 0.831)])
def test_bound_of_a_step(name, n_convs, bound_ms):
    """37 stride-1 1x1x1 conv calls a Retina U-Net step (1.670 ms: x, dy
    and dw once at 3.35 TB/s, every one bound by its bytes), 44 a Mask
    R-CNN step (0.831 ms); None where the configuration runs bfloat16 or
    TF32, or for a family the walk does not know."""
    config = _config(name)
    cf = reference_config(config)
    rows = pointwise_wgrad.convs(cf, config["model"])
    assert len(rows) == n_convs
    assert all(w[2:] == (1, 1, 1) and x[2:] == dy[2:] for x, w, dy, _ in rows)
    bound = pointwise_wgrad.k6_bound_s(cf, config["model"], config["precision"])
    assert bound * 1e3 == pytest.approx(bound_ms, abs=5e-4)
    assert pointwise_wgrad.k6_bound_s(cf, config["model"], {"dtype": "bfloat16", "tf32": False}) is None
    assert pointwise_wgrad.k6_bound_s(cf, config["model"], {"dtype": "float32", "tf32": True}) is None
    assert pointwise_wgrad.k6_bound_s(cf, "detection_unet", config["precision"]) is None


def test_gate_rule():
    import torch.nn as nn

    assert pointwise_wgrad.admitted(nn.Conv3d(4, 8, 1), (2, 4, 8, 8, 8))
    for conv, shape in ((nn.Conv3d(4, 8, 1, stride=(2, 2, 2)), (2, 4, 8, 8, 8)),
                        (nn.Conv3d(4, 8, 3, padding=1), (2, 4, 8, 8, 8)), (nn.Conv3d(4, 8, 1, groups=2), (2, 4, 8, 8, 8)),
                        (nn.Conv2d(4, 8, 1), (2, 4, 8, 8))):
        assert not pointwise_wgrad.admitted(conv, shape)


@pytest.mark.parametrize("name,k5_s", [("lidc3d_retina_unet", 0.02911289833074627),
                                       ("lidc3d_mrcnn", 0.003989515615522388)])
def test_k5_bound_unchanged(name, k5_s):
    """K5's bound reads as it did before K6: its convs are those with a
    kernel larger than 1."""
    config = _config(name)
    assert wgrad.k5_bound_s(reference_config(config), config["model"], config["precision"]) == pytest.approx(
        k5_s, rel=1e-12)


@pytest.mark.parametrize("launched", [True, False])
def test_metric_reads_the_kernels_time(launched):
    """Bound x steps over the two kernels' time; None in a trace without
    K6 (the parent commit); K5's and cuDNN's kernels are not read."""
    cell = Cell(REPO, "lidc3d_retina_unet.train")
    cf = reference_config(cell.config)
    bound = pointwise_wgrad.k6_bound_s(cf, "retina_unet", cell.config["precision"])
    kernels = [("void (anonymous namespace)::pointwise_wgrad_partial_kernel<4>", 0.0, 3000.0),
               ("pointwise_wgrad_reduce_kernel", 0.0, 100.0), ("conv3d_wgrad_partial_kernel<8, 3, 4>", 0.0, 400.0),
               ("wgrad2d_grouped_direct_kernel", 0.0, 900.0)] if launched else [("cudnn_wgrad", 0.0, 900.0)]
    run = SimpleNamespace(kind="train", trace={"kernels": kernels}, requests=4, ref_cf=cf, cell=cell)
    value = cell.reader("k6_roofline.train")(run)
    if launched:
        assert value == pytest.approx(bound * 4 / 3100e-6 * 100)
    else:
        assert value is None
    assert cell.reader("k6_roofline.train")(SimpleNamespace(kind="infer", trace={"kernels": kernels})) is None
