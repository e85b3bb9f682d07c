"""The pointwise weight-gradient kernel K6 on the CPU: its plain version, the
autograd function that takes dw from it for a 1x1x1 conv, the kernel's
schedule (a model of the CUDA source's staging and sums), the plans of the
main path's shapes, the gate, and the ``k6.calls`` counter.

Tolerances:
  * the plain version and the schedule model against
    ``torch.nn.grad.conv3d_weight`` in float64: 1e-12 of max|dw| (the same
    products summed in other orders);
  * the autograd function's dx, dw and db against ``F.conv3d``'s autograd in
    float64: 1e-12 of each gradient's max;
  * the gate: 37 calls a step of the LIDC Retina U-Net module and 44 of the
    LIDC Mask R-CNN module (``BENCHMARK.json``'s training cells), exactly.

There is no card here: the kernel itself is held against the plain version
and float64 on the card by ``chip_smoke.py`` phase 3f and
``tools/time_pointwise_wgrad.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from medicaldetectiontoolkit_torch.models import backbone as tbb  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402
from medicaldetectiontoolkit_torch.ops import conv_wgrad, pointwise_wgrad  # noqa: E402
from medicaldetectiontoolkit_torch.ops import pointwise_wgrad_cuda as pw  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

# (x shape, cout): scaled-down shapes of the convs the gate admits: a
# lateral, a one-channel-out head, a wide deep level, a RoI head of 1 voxel,
# z not a multiple of 4
CLASSES = {
    "lateral": ((2, 5, 8, 6, 8), 9),
    "seg_head": ((2, 9, 6, 6, 4), 2),
    "deep_wide": ((2, 40, 2, 2, 2), 30),
    "roi_1_voxel": ((6, 13, 1, 1, 1), 13),
    "z_odd": ((3, 7, 5, 3, 5), 4),
}


def _operands(xs, cout, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g, dtype=dtype)
    dy = torch.randn((xs[0], cout, *xs[2:]), generator=g, dtype=dtype)
    return x, dy


def _close(a, b, rel=1e-12):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_plain_matches_conv3d_weight(case):
    xs, cout = CLASSES[case]
    x, dy = _operands(xs, cout)
    got = pointwise_wgrad.pointwise_wgrad_reference(x, dy)
    ref = torch.nn.grad.conv3d_weight(x, (cout, xs[1], 1, 1, 1), dy)
    assert got.dtype == torch.float64 and got.shape == (cout, xs[1]) and _close(got, ref.reshape(cout, xs[1]))


@pytest.mark.parametrize("needs_dx", [True, False])
@pytest.mark.parametrize("case", sorted(CLASSES))
def test_function_matches_autograd(case, needs_dx):
    """dx (cuDNN's dgrad on the card, ``aten.convolution_backward`` here),
    dw (K6's plain version) and db (dy's sum) of a 1x1x1 conv against
    ``F.conv3d``'s own autograd; no dx where x needs none."""
    xs, cout = CLASSES[case]
    x, _ = _operands(xs, cout)
    g = torch.Generator().manual_seed(1)
    w = torch.randn((cout, xs[1], 1, 1, 1), generator=g, dtype=torch.float64)
    b = torch.randn(cout, generator=g, dtype=torch.float64)
    one, zero = (1, 1, 1), (0, 0, 0)
    outs = []
    for fn in (lambda x, w, b: conv_wgrad.Conv3dWgradFunction.apply(x, w, b, one, zero),
               lambda x, w, b: F.conv3d(x, w, b, one, zero)):
        xx, ww, bb = (t.clone().requires_grad_(r) for t, r in ((x, needs_dx), (w, True), (b, True)))
        y = fn(xx, ww, bb)
        y.backward(torch.cos(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape))
        outs.append((y.detach(), xx.grad, ww.grad, bb.grad))
    (y, dx, dw, db), (y_ref, dx_ref, dw_ref, db_ref) = outs
    assert torch.equal(y, y_ref) and dw.shape == dw_ref.shape
    assert (dx is None) == (not needs_dx) and (dx is None or _close(dx, dx_ref))
    assert _close(dw, dw_ref) and _close(db, db_ref)


def k6_model(x, dy, p):
    """What ``pointwise_wgrad_partial_kernel`` and
    ``pointwise_wgrad_reduce_kernel`` compute with plan ``p``, in float64
    and the source's own index arithmetic: each stage of each tile staged
    into its buffer (lane l the voxels 4 l .. 4 l + 3 of the stage, each
    voxel's image and offset from its flattened index, zeros past the last
    voxel, zero rows past cout and cin; unstaged words NaN), each lane's
    sums over its voxels, the warp's lanes summed, each slice's partial
    written once per entry, then the slices summed in order."""
    B, C, V = x.shape
    M = dy.shape[1]
    R, VT = pw.R, pw.VT
    tm, tc, S = p["tm"], p["tc"], p["slices"]
    ntm, ntc, n_stages = p["ntm"], p["ntc"], p["n_stages"]
    N = B * V
    assert n_stages == -(-N // VT) and p["threads"] == 32 * tm * tc <= 32 * pw.MAX_WARPS
    assert ntm * tm * R >= M and ntc * tc * R >= C and p["smem"] == pw.smem_bytes(tm, tc) <= pw.SMEM_MAX
    xf, dyf = x.reshape(-1), dy.reshape(-1)
    partial = np.full((S, M * C), np.nan)
    lanes = np.arange(32)
    for tile in range(ntm * ntc):
        m0, c0 = tile % ntm * tm * R, tile // ntm * tc * R
        rows_m, rows_c = min(tm * R, M - m0), min(tc * R, C - c0)
        for sl in range(S):
            acc = np.zeros((tm * tc, 32, R, R))
            for s in range(sl * n_stages // S, (sl + 1) * n_stages // S):
                buf = np.full(((tm + tc) * R, VT), np.nan)
                buf[rows_m:tm * R] = 0
                buf[tm * R + rows_c:] = 0
                n = s * VT + 4 * lanes[:, None] + np.arange(4)  # (lane, e)
                valid = (n[:, :1] < N) if p["vec"] else (n < N)
                valid = np.broadcast_to(valid, n.shape)
                b = np.where(valid, n // V, 0)
                v = np.where(valid, n - b * V, 0)
                for r in range(rows_m + rows_c):
                    if r < rows_m:
                        src, row = dyf[(b * M + m0 + r) * V + v], r
                    else:
                        src, row = xf[(b * C + c0 + r - rows_m) * V + v], tm * R + r - rows_m
                    buf[row] = np.where(valid, src, 0.0).reshape(-1)
                for w in range(tm * tc):
                    mg, cg = w % tm, w // tm
                    d = buf[mg * R:(mg + 1) * R].reshape(R, 32, 4)
                    xv = buf[(tm + cg) * R:(tm + cg + 1) * R].reshape(R, 32, 4)
                    acc[w] += np.einsum("ilk,jlk->lij", d, xv)
            total = acc.sum(1)  # the butterfly
            for w in range(tm * tc):
                mg, cg = w % tm, w // tm
                for i in range(R):
                    for j in range(R):
                        m, c = m0 + mg * R + i, c0 + cg * R + j
                        if m < M and c < C:
                            assert np.isnan(partial[sl, m * C + c])  # one owner per entry
                            partial[sl, m * C + c] = total[w, i, j]
    assert not np.isnan(partial).any()
    return partial.sum(0).reshape(M, C)


# (x shape, cout, MAX_WARPS, MAX_RUN, SMs): plans with several tiles along
# cout and cin, slices of uneven runs, one slice, the 4-byte path, images
# shorter than a stage, a last stage past the voxels
SCHEDULES = {
    "one_tile_slices": ((2, 9, 8, 6, 8), 10, 24, 1024, 5),
    "tiles_cout": ((3, 5, 4, 4, 4), 20, 2, 1024, 4),
    "tiles_cin": ((2, 20, 6, 6, 4), 5, 2, 1024, 3),
    "tiles_both_one_slice": ((2, 14, 3, 3, 4), 13, 2, 1024, 1),
    "run_limit": ((2, 7, 10, 8, 8), 3, 24, 2, 1),
    "short_images": ((11, 6, 3, 2, 2), 7, 24, 1024, 2),
    "v_odd": ((3, 7, 5, 3, 5), 8, 24, 1024, 2),
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_kernel_schedule_matches_conv3d_weight(case, aligned, monkeypatch):
    xs, cout, warps, run, sms = SCHEDULES[case]
    monkeypatch.setattr(pw, "MAX_WARPS", warps)
    monkeypatch.setattr(pw, "MAX_RUN", run)
    pw.plan.cache_clear()
    try:
        V = math.prod(xs[2:])
        p = pw.plan((xs[0], xs[1], V, cout), sms, aligned)
        x, dy = _operands(xs, cout)
        got = k6_model(x.numpy().reshape(xs[0], xs[1], V), dy.numpy().reshape(xs[0], cout, V), p)
    finally:
        pw.plan.cache_clear()
    ref = torch.nn.grad.conv3d_weight(x, (cout, xs[1], 1, 1, 1), dy).reshape(cout, xs[1])
    assert p["vec"] == int(aligned and V % 4 == 0)
    assert p["slices"] >= -(-p["n_stages"] // run)
    assert _close(torch.from_numpy(got), ref)


# the stride-1 1x1x1 weight gradients of the benchmark's LIDC training cells
# (batch 8 of 128 x 128 x 64), by (x shape, cout)
LIDC_SHAPES = [
    ((8, 36, 128, 128, 64), 2), ((8, 18, 128, 128, 64), 36), ((8, 72, 32, 32, 64), 18), ((8, 72, 32, 32, 64), 36),
    ((8, 18, 64, 64, 64), 36), ((8, 18, 32, 32, 64), 18), ((8, 18, 32, 32, 64), 72), ((8, 144, 16, 16, 32), 36),
    ((8, 36, 16, 16, 32), 144), ((8, 288, 8, 8, 16), 72), ((8, 288, 8, 8, 16), 36), ((8, 72, 8, 8, 16), 288),
    ((8, 576, 4, 4, 8), 144), ((8, 576, 4, 4, 8), 36), ((8, 144, 4, 4, 8), 576), ((8, 128, 32, 32, 64), 6),
    ((8, 128, 32, 32, 64), 18), ((48, 36, 28, 28, 10), 3), ((8, 128, 16, 16, 32), 6), ((8, 128, 16, 16, 32), 18),
    ((8, 128, 8, 8, 16), 6), ((8, 128, 8, 8, 16), 18), ((8, 128, 4, 4, 8), 6), ((8, 128, 4, 4, 8), 18),
    ((48, 144, 1, 1, 1), 144),
]


@pytest.mark.parametrize("xs,cout", LIDC_SHAPES)
def test_plans_of_the_lidc_shapes(xs, cout):
    """On an H100 (132 SMs) every main-path shape has a plan within the
    kernel's limits: threads, shared memory, 2 MB of partials, runs of at
    most 4,096 products a sum, the 16-byte copies wherever V allows, and
    dw in one tile wherever it fits in one block's warps and shared memory
    (so x and dy are read once)."""
    V = math.prod(xs[2:])
    p = pw.plan((xs[0], xs[1], V, cout), 132)
    assert p is not None and p["threads"] <= 32 * pw.MAX_WARPS and p["smem"] <= pw.SMEM_MAX
    assert p["scratch"] * 4 <= pw.SCRATCH_BYTES and 1 <= p["slices"] <= p["n_stages"]
    assert 4 * -(-p["n_stages"] // p["slices"]) <= 4 * pw.MAX_RUN
    assert p["vec"] == int(V % 4 == 0)
    assert p["ntm"] * p["tm"] * pw.R >= cout and p["ntc"] * p["tc"] * pw.R >= xs[1]
    gm, gc = -(-cout // pw.R), -(-xs[1] // pw.R)
    if gm * gc <= pw.MAX_WARPS and pw.smem_bytes(gm, gc) <= pw.SMEM_MAX:
        assert p["ntm"] * p["ntc"] == 1


def _lidc_module_step(model, monkeypatch):
    """One training step of a small LIDC-topology module on the CPU with the
    gate's device test passed: (the 1x1x1 ConvND layers that took K6 at
    their last call, the step's counters)."""
    monkeypatch.setattr(conv_wgrad, "on_card", lambda t: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setenv("MDT_STEM_PALLAS", "1")
    if model == "mrcnn":
        cf = make_config(model="mrcnn", dim=3, patch_size=[64, 64, 16], batch_size=2, retina_scales=False)
        cf.pre_nms_limit, cf.post_nms_rois_training = 2000, 300
    else:
        cf = make_config(model=model, dim=3, patch_size=[64, 64, 16], batch_size=2)
    cf.use_remat = True
    net = build_model(cf, None, device="cpu")
    net.initialize(seed=4)
    trace.enable()
    try:
        net.train_forward_convert(net.train_forward_dispatch(make_batch(cf, seed=1)), make_batch(cf, seed=1),
                                  need_seg_preds=False)
        counters = trace.summary()["counters"]
    finally:
        trace.disable()
    layers = [m for m in net.module.modules()
              if isinstance(m, tbb.ConvND) and m.wgrad_kernel and math.prod(m.conv.kernel_size) == 1]
    return layers, counters


@pytest.mark.parametrize("model,k6,k5,n_layers", [("retina_unet", 37, 62, 37), ("mrcnn", 44, 29, 38),
                                                   ("detection_unet", 37, 18, 37)])
def test_gate_admits_the_lidc_convs(model, k6, k5, n_layers, monkeypatch):
    """The LIDC training cells' modules (and Detection U-Net's, which
    ``chip_smoke.py`` trains on the card too): each stride-1 1x1x1 conv
    takes K6 once a step: 37 calls of 37 layers in Retina U-Net (its
    ResNet bottlenecks' 1x1 convs, the laterals, the seg head), 44 of 38
    in Mask R-CNN (the RPN's two 1x1 heads on 4 levels, the classifier's
    second conv, the mask head's last), 37 of 37 in Detection U-Net; K5
    keeps its 62, 29 and 18 calls; the strided 1x1x1 shortcuts keep
    cuDNN."""
    layers, counters = _lidc_module_step(model, monkeypatch)
    assert counters.get("k6.calls", 0) == k6 and counters.get("k5.calls", 0) == k5
    for m in layers:
        assert m.conv.stride == (1, 1, 1) and m.conv.padding == (0, 0, 0) and not m.stem_kernel
    assert len(layers) == n_layers


def _conv_call(dim=3, cin=4, stride=1, dtype=torch.float32, grad=True):
    layer = tbb.ConvND(dim, cin, 8, ks=1, stride=stride, relu=None, dtype=dtype)
    x = torch.randn((2, cin, 16, 16, 8) if dim == 3 else (2, cin, 16, 16))
    with torch.set_grad_enabled(grad):
        layer(x)
    return layer


REFUSED = {
    "bfloat16": lambda: _conv_call(dtype=torch.bfloat16),
    "2d": lambda: _conv_call(dim=2),
    "no_grad": lambda: _conv_call(grad=False),
    "stride_222": lambda: _conv_call(stride=2),
    "stride_221": lambda: _conv_call(stride=(2, 2, 1)),
}


@pytest.mark.parametrize("case", sorted(REFUSED) + ["tf32_on", "cpu_tensor"])
def test_gate_refuses(case, monkeypatch):
    """A 1x1x1 conv in bfloat16, 2D, without a gradient, strided (the ResNet
    shortcuts), with TF32 on (exec on one card) or on a CPU tensor keeps
    ``F.conv3d`` / ``F.conv2d``; the same conv in float32 with TF32 off on
    the card is admitted."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", case == "tf32_on")
    if case != "cpu_tensor":
        monkeypatch.setattr(conv_wgrad, "on_card", lambda t: True)
    assert not REFUSED.get(case, _conv_call)().wgrad_kernel
    monkeypatch.setattr(conv_wgrad, "on_card", lambda t: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert _conv_call().wgrad_kernel


def test_k6_calls_counter():
    """One ``k6.calls`` per K6 call while tracing is on; none while it is
    off; K5's counter does not move."""
    x, dy = _operands(CLASSES["lateral"][0], CLASSES["lateral"][1], torch.float32)
    pointwise_wgrad.pointwise_wgrad(x, dy)
    trace.enable()
    try:
        for _ in range(3):
            pointwise_wgrad.pointwise_wgrad(x, dy)
        counters = trace.summary()["counters"]
        assert counters["k6.calls"] == 3 and "k5.calls" not in counters
    finally:
        trace.disable()
    assert trace.summary()["counters"]["k6.calls"] == 3


def test_cuda_wrapper_takes_cuda_tensors_only():
    x, dy = _operands(CLASSES["lateral"][0], CLASSES["lateral"][1], torch.float32)
    with pytest.raises(ValueError):
        pw.pointwise_wgrad(x, dy)
    with pytest.raises(ValueError):
        pointwise_wgrad.pointwise_wgrad(x.to("meta"), dy.to("meta"))
