"""The FLOP counter and the kernels' bounds against shapes worked by hand."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest

from benchmark.core import work
from benchmark.core.cell import reference_config
from benchmark.reference import mrcnn, retina_unet
from conftest import REPO


def _cf(name):
    return reference_config(json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text()))


def test_flops_of_a_single_conv_layer_net():
    """A one-block stand-in whose MACs are easy to count: the counter adds
    out voxels x cin x k^3 per conv and in x out per linear."""
    import torch
    import torch.nn as nn

    from benchmark.reference.models import ConvND

    net = nn.Sequential(ConvND(3, 2, 4, ks=3, pad=1), ConvND(3, 4, 8, ks=1))
    counter = work._MacCounter(net, (ConvND,))
    net(torch.empty((3, 2, 8, 8, 4), device="meta"))
    counter.close()
    voxels = 3 * 8 * 8 * 4
    assert counter.macs == voxels * 4 * 2 * 27 + voxels * 8 * 4


def test_retina_unet_counts():
    cf = _cf("lidc3d_retina_unet")
    fwd = retina_unet.flops(cf, train=False)
    assert retina_unet.flops(cf, train=True) == pytest.approx(3 * fwd, rel=1e-12)
    # conv0 alone: 8 x 18 x 128 x 128 x 64 outputs of 1 x 27 MACs
    conv0 = 2 * 8 * 18 * 128 * 128 * 64 * 27
    assert fwd > 50 * conv0 and fwd / 8 == pytest.approx(0.308e12, rel=0.01)
    assert work.n_anchors(cf) == 673_920


def test_mask_rcnn_counts():
    cf = _cf("lidc3d_mrcnn")
    fwd = mrcnn.flops(cf, train=False)
    # the classifier's first conv on the 4,000 proposals: 36 x 147 -> 144
    assert fwd > 2 * 4000 * 144 * 36 * 147
    assert mrcnn.flops(cf, train=True) > 3 * (fwd - 2 * 4000 * (144 * 36 * 147 + 144 * 144))


def test_stem_bounds():
    cf = _cf("lidc3d_retina_unet")
    n_in, n_out = 8 * 128 * 128 * 64, 8 * 18 * 128 * 128 * 64
    assert work.k3_bound_s(cf) == pytest.approx((n_in + 18 * 27 + 18 + n_out) * 4 / 3.35e12)
    assert work.k3_bound_s(cf) * 1e3 == pytest.approx(0.1903, abs=1e-4)  # bytes bound, PERF.md's figure
    c1 = _cf("lidc3d_mrcnn")
    ops = 2 * 8 * 18 * 64 * 64 * 64 * 343
    assert work.k3_bound_s(c1) == pytest.approx(ops / 67e12)  # C1, k 7: operations bound
    assert work.k3_bound_s(c1) * 1e3 == pytest.approx(0.3865, abs=1e-4)


def test_nms_bounds():
    cf = _cf("lidc3d_retina_unet")
    reads = 50000 * 7 * 4 + 16 * 50000
    assert retina_unet.k1_bound_s(cf) == pytest.approx((reads + 16 * 30 * 5) / 3.35e12)
    mr = _cf("lidc3d_mrcnn")
    # proposals: 8 lanes of their own 6,000, 500 kept (the IoU tests bound it);
    # refinement: 8 x 2 lanes of the 8,000 (proposal, class) candidates, 30 kept
    proposals = max((8 * 6000 * 28 + 8 * 500 * 5) / 3.35e12, (8 * 6000 + 8 * (500 * 499 // 2) * 33) / 67e12)
    refine = max((8000 * 28 + 16 * 8000 + 16 * 30 * 5) / 3.35e12, (16 * 8000 + 16 * (30 * 29 // 2) * 33) / 67e12)
    assert mrcnn.k1_bound_s(mr) == pytest.approx(proposals + refine)
    assert work.bound_s(1.0, 67e12) == 1.0 and work.bound_s(3.35e12, 0) == 1.0
    assert math.isclose(work.OPS_PER_IOU, 33)


def test_stem_without_stride1_levels():
    cf = SimpleNamespace(batch_size=2, patch_size=[32, 32, 8], operate_stride1=False, n_channels=1, start_filts=4)
    cin, k, s, n_out = work._stem(cf)
    assert (cin, k, s, n_out) == (1, 7, 2, 2 * 4 * 16 * 16 * 8)
