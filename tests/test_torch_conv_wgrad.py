"""The conv weight-gradient kernel K5 on the CPU: its plain version, the
autograd function that takes dw from it, the kernel's schedule (a model of
the CUDA source's staging and sums), the plans of the main path's shapes,
and the gate that decides which convs take it.

Tolerances:
  * the plain version and the schedule model against
    ``torch.nn.grad.conv3d_weight`` in float64: 1e-12 of max|dw| (the same
    products summed in other orders);
  * the autograd function's dx, dw and db against ``F.conv3d``'s autograd in
    float64: 1e-12 of each gradient's max;
  * the gate: 62 convs a step of the LIDC Retina U-Net module and 29 of the
    LIDC Mask R-CNN module (``BENCHMARK.json``'s training cells) take K5,
    exactly; their 1x1x1 convs take K6 (``test_torch_pointwise_wgrad.py``).

There is no card here: the kernel itself is held against the plain version
on the card by ``chip_smoke.py`` phase 3e and ``tools/time_conv_wgrad.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from medicaldetectiontoolkit_torch.models import backbone as tbb  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402
from medicaldetectiontoolkit_torch.ops import conv_wgrad, conv_wgrad_cuda as cw  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.utils import trace  # noqa: E402

torch.set_num_threads(2)

# (x shape, w shape, stride, padding): scaled-down shapes of every class the
# gate admits
CLASSES = {
    "k3_pad1": ((2, 5, 9, 8, 8), (6, 5, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "k7_stride221_pad3": ((2, 3, 12, 11, 8), (5, 3, 7, 7, 7), (2, 2, 1), (3, 3, 3)),
    "k773_pad0": ((3, 6, 7, 7, 3), (16, 6, 7, 7, 3), (1, 1, 1), (0, 0, 0)),
    "slab_pad011": ((2, 4, 8, 6, 8), (8, 4, 3, 3, 3), (1, 1, 1), (0, 1, 1)),
    "k235_mixed": ((1, 4, 7, 6, 6), (4, 4, 2, 3, 5), (2, 1, 1), (1, 2, 4)),
}


def _operands(xs, ws, stride, padding, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g, dtype=dtype)
    out = [(n + 2 * p - k) // s + 1 for n, k, s, p in zip(xs[2:], ws[2:], stride, padding)]
    dy = torch.randn((xs[0], ws[0], *out), generator=g, dtype=dtype)
    return x, dy


def _close(a, b, rel=1e-12):
    return float((a - b).abs().max()) <= rel * float(b.abs().max())


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_plain_matches_conv3d_weight(case):
    xs, ws, stride, padding = CLASSES[case]
    x, dy = _operands(xs, ws, stride, padding)
    got = conv_wgrad.conv3d_wgrad_reference(x, dy, ws[2:], stride, padding)
    ref = torch.nn.grad.conv3d_weight(x, ws, dy, stride=stride, padding=padding)
    assert got.dtype == torch.float64 and got.shape == ref.shape and _close(got, ref)


@pytest.mark.parametrize("needs_dx", [True, False])
@pytest.mark.parametrize("case", sorted(CLASSES))
def test_function_matches_autograd(case, needs_dx):
    """dx (cuDNN's dgrad on the card, ``aten.convolution_backward`` here),
    dw (K5's plain version) and db (dy's sum) against ``F.conv3d``'s own
    autograd; no dx where x needs none."""
    xs, ws, stride, padding = CLASSES[case]
    x, _ = _operands(xs, ws, stride, padding)
    g = torch.Generator().manual_seed(1)
    w = torch.randn(ws, generator=g, dtype=torch.float64)
    b = torch.randn(ws[0], generator=g, dtype=torch.float64)
    outs = []
    for fn in (lambda x, w, b: conv_wgrad.Conv3dWgradFunction.apply(x, w, b, stride, padding),
               lambda x, w, b: F.conv3d(x, w, b, stride, padding)):
        xx, ww, bb = (t.clone().requires_grad_(r) for t, r in ((x, needs_dx), (w, True), (b, True)))
        y = fn(xx, ww, bb)
        y.backward(torch.cos(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape))
        outs.append((y.detach(), xx.grad, ww.grad, bb.grad))
    (y, dx, dw, db), (y_ref, dx_ref, dw_ref, db_ref) = outs
    assert torch.equal(y, y_ref)
    assert (dx is None) == (not needs_dx) and (dx is None or _close(dx, dx_ref))
    assert _close(dw, dw_ref) and _close(db, db_ref)


def k5_model(x, dy, shape, p):
    """What ``conv3d_wgrad_partial_kernel`` and ``conv3d_wgrad_reduce_kernel``
    compute with plan ``p``, in float64 and the source's own index
    arithmetic: the staging of each chunk into its buffer (the digit counter
    stepping by the block's threads, 16- or 4-byte copies, zeros outside the
    tensors; unstaged words NaN), each thread's walk over the chunk's voxels
    with its ring of KZT x values, each slice's partial written once per
    entry, then the slices summed in order."""
    B, C, Y, X, Z, M, KY, KX, KZ, sy, sx, py, px, pz = shape
    Yo, Xo, Zo = cw.out_size(shape)
    tm, kzt, kzg, ms, ct, kyt, n_ci, n_ky, nb, ny, nx, nz, vec, S = (p[k] for k in cw.PLAN_KEYS)
    Q = 4 if vec else 1
    zoff = (4 - pz % 4) % 4 if vec else 0
    wy, wx = (ny - 1) * sy + kyt, (nx - 1) * sx + KX
    wzp = -(-(zoff + nz + kzg * kzt - 1) // Q) * Q
    pdy, pxc = cw._row_pitch(nb * ny * nx * nz), cw._row_pitch(nb * wy * wx * wzp)
    nbc, nyc, nxc, nzc = -(-B // nb), -(-Yo // ny), -(-Xo // nx), -(-Zo // nz)
    n_chunks, T = nbc * nyc * nxc * nzc, p["threads"]
    assert n_chunks == p["n_chunks"]
    xf, dyf = x.reshape(-1), dy.reshape(-1)
    partial = np.full((S, M * C * KY * KX * KZ), np.nan)
    words = ms * tm * pdy + 4 * ct * pxc
    assert 2 * words * 4 == p["smem"] <= cw.SMEM_MAX and p["threads"] <= -(-cw.MAX_THREADS // 32) * 32

    def split(u, nq, nc, nr, nbb):
        out = []
        for n in (nq, nc, nr, nbb):
            out.append(u % n)
            u //= n
        return out + [u]

    def copies(buf, base, nq, radices, total, src_of, dst_of):
        for t in range(T):
            d, s, u = split(t, nq, *radices), split(T, nq, *radices), t
            while u < total:
                src, dst = src_of(*d), dst_of(*d)
                buf[dst:dst + Q] = 0 if src is None else base[src:src + Q]
                u, carry = u + T, 0
                for i, n in enumerate((nq, *radices)):  # ``advance``
                    d[i] += s[i] + carry
                    carry = int(d[i] >= n)
                    d[i] -= n * carry
                d[4] += s[4] + carry

    def stage(buf, chunk, cit, kyi):
        oz0, r = chunk % nzc * nz, chunk // nzc
        ox0, r = r % nxc * nx, r // nxc
        oy0, b0 = r % nyc * ny, r // nyc * nb

        def dy_src(q, c, rr, bb, h):
            b, oy, ox, oz = b0 + bb, oy0 + rr, ox0 + c, oz0 + q * Q
            ok = b < B and oy < Yo and ox < Xo and oz < Zo
            return (((b * M + h) * Yo + oy) * Xo + ox) * Zo + oz if ok else None

        copies(buf, dyf, nz // Q, (nx, ny, nb), M * nb * ny * nx * (nz // Q), dy_src,
               lambda q, c, rr, bb, h: h * pdy + ((bb * ny + rr) * nx + c) * nz + q * Q)
        ch0 = cit * 4 * ct
        iy0, ix0, iz0 = oy0 * sy - py + kyi * kyt, ox0 * sx - px, oz0 - pz - zoff

        def x_src(q, c, rr, bb, h):
            b, iy, ix, iz = b0 + bb, iy0 + rr, ix0 + c, iz0 + q * Q
            ok = b < B and 0 <= iy < Y and 0 <= ix < X and 0 <= iz < Z
            assert not (ok and Q == 4 and (iz % 4 or iz + 4 > Z))
            return (((b * C + ch0 + h) * Y + iy) * X + ix) * Z + iz if ok else None

        copies(buf, xf, wzp // Q, (wx, wy, nb), min(4 * ct, C - ch0) * nb * wy * wx * (wzp // Q), x_src,
               lambda q, c, rr, bb, h: ms * tm * pdy + h * pxc + ((bb * wy + rr) * wx + c) * wzp + q * Q)

    t = np.arange(T)
    slot, r = t % ms, t // ms
    cg, r = r % ct, r // ct
    kx, r = r % KX, r // KX
    kyl, kzgi = r % kyt, r // kyt
    active = kzgi < kzg
    dstep, xstep = ms * pdy, ct * pxc

    def read(buf, idx):
        return np.where(active, buf[np.where(active, idx, 0)], 0.0)

    for blk in range(n_ci * n_ky):
        cit, kyi = blk // n_ky, blk % n_ky
        for sl in range(S):
            buf = np.full(words, np.nan)
            buf[M * pdy:ms * tm * pdy] = 0  # rows past cout and past the tile's input channels
            buf[ms * tm * pdy + min(4 * ct, C - cit * 4 * ct) * pxc:] = 0
            acc = np.zeros((T, kzt, tm, 4))
            for chunk in range(sl * n_chunks // S, (sl + 1) * n_chunks // S):
                stage(buf, chunk, cit, kyi)
                xs = ms * tm * pdy + cg * pxc + zoff + kzgi * kzt
                for bb in range(nb):
                    for y in range(ny):
                        for xx in range(nx):
                            dp = slot * pdy + ((bb * ny + y) * nx + xx) * nz
                            xp = xs + ((bb * wy + y * sy + kyl) * wx + xx * sx + kx) * wzp
                            ring = np.zeros((T, kzt, 4))
                            for a in range(kzt - 1):
                                ring[:, a] = np.stack([read(buf, xp + a + j * xstep) for j in range(4)], 1)
                            for oz in range(nz):
                                u = oz % kzt
                                d = np.stack([read(buf, dp + oz + i * dstep) for i in range(tm)], 1)
                                ring[:, (u + kzt - 1) % kzt] = np.stack(
                                    [read(buf, xp + oz + kzt - 1 + j * xstep) for j in range(4)], 1)
                                for a in range(kzt):
                                    acc[:, a] += d[:, :, None] * ring[:, (u + a) % kzt, None, :]
            for i in range(tm):
                for j in range(4):
                    for a in range(kzt):
                        co, ci = slot + ms * i, cit * 4 * ct + cg + ct * j
                        ky, kz = kyi * kyt + kyl, kzgi * kzt + a
                        ok = active & (co < M) & (ci < C) & (ky < KY) & (kz < KZ)
                        idx = (((co * C + ci) * KY + ky) * KX + kx) * KZ + kz
                        assert np.isnan(partial[sl, idx[ok]]).all()  # one owner per entry
                        partial[sl, idx[ok]] = acc[ok, a, i, j]
    assert not np.isnan(partial).any()
    return partial.sum(0).reshape(M, C, KY, KX, KZ)


# (x shape, w shape, stride, padding, CHUNK_VOXELS, MAX_THREADS, SMs): plans
# with several chunks, slices, input-channel tiles and ky tiles, kz groups,
# 16- and 4-byte copies, batch chunks
SCHEDULES = {
    "k3_slices": ((2, 5, 6, 7, 8), (6, 5, 3, 3, 3), (1, 1, 1), (1, 1, 1), 16, 384, 7),
    "k7_stride221": ((2, 3, 9, 8, 8), (5, 3, 7, 7, 7), (2, 2, 1), (3, 3, 3), 16, 384, 5),
    "k773_batch_chunks": ((3, 4, 7, 7, 3), (16, 4, 7, 7, 3), (1, 1, 1), (0, 0, 0), 16, 128, 3),
    "ci_tiles": ((2, 9, 6, 6, 4), (16, 9, 3, 3, 3), (1, 1, 1), (1, 1, 1), 32, 40, 9),
    "ky_tiles": ((2, 9, 6, 6, 4), (16, 9, 3, 3, 3), (1, 1, 1), (1, 1, 1), 32, 10, 9),
    "kz_groups": ((1, 3, 5, 5, 12), (3, 3, 3, 3, 9), (1, 2, 1), (2, 1, 8), 8, 384, 3),
    "k537_odd": ((2, 13, 7, 6, 8), (12, 13, 5, 3, 7), (2, 1, 1), (2, 0, 3), 24, 60, 11),
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_kernel_schedule_matches_conv3d_weight(case, aligned, monkeypatch):
    xs, ws, stride, padding, voxels, threads, sms = SCHEDULES[case]
    monkeypatch.setattr(cw, "CHUNK_VOXELS", voxels)
    monkeypatch.setattr(cw, "MAX_THREADS", threads)
    cw.plan.cache_clear()
    try:
        shape = (*xs, ws[0], *ws[2:], stride[0], stride[1], *padding)
        p = cw.plan(shape, sms, aligned)
        x, dy = _operands(xs, ws, stride, padding)
        got = k5_model(x.numpy(), dy.numpy(), shape, p)
    finally:
        cw.plan.cache_clear()
    ref = torch.nn.grad.conv3d_weight(x, ws, dy, stride=stride, padding=padding)
    assert p["vec"] == int(aligned and xs[4] % 4 == 0 and cw.out_size(shape)[2] % 4 == 0)
    assert _close(torch.from_numpy(got), ref)


# the weight gradients of the benchmark's LIDC training cells (batch 8 of
# 128 x 128 x 64) that K5 takes, and the strided 7x7x7 stem, which the
# kernel takes and the gate leaves to cuDNN, by (x shape, w shape, stride,
# padding)
LIDC_SHAPES = [
    ((8, 36, 128, 128, 64), (36, 36, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((8, 18, 128, 128, 64), (18, 18, 7, 7, 7), (2, 2, 1), (3, 3, 3)),
    ((8, 18, 128, 128, 64), (18, 18, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((8, 64, 32, 32, 64), (64, 64, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((8, 64, 32, 32, 64), (54, 64, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((8, 36, 32, 32, 64), (64, 36, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((8, 36, 32, 32, 64), (128, 36, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((8, 144, 4, 4, 8), (144, 144, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((48, 36, 7, 7, 3), (144, 36, 7, 7, 3), (1, 1, 1), (0, 0, 0)),
    ((48, 36, 14, 14, 5), (36, 36, 3, 3, 3), (1, 1, 1), (1, 1, 1)),
]


@pytest.mark.parametrize("xs,ws,stride,padding", LIDC_SHAPES)
def test_plans_of_the_lidc_shapes(xs, ws, stride, padding):
    """On an H100 (132 SMs) every main-path shape has a plan within the
    kernel's limits: threads, shared memory, 16 MB of partials, at most one
    block per SM, and the 16-byte copies wherever z allows."""
    shape = (*xs, ws[0], *ws[2:], stride[0], stride[1], *padding)
    p = cw.plan(shape, 132)
    assert p is not None and p["threads"] <= cw.MAX_THREADS and p["smem"] <= cw.SMEM_MAX
    assert p["scratch"] * 4 <= cw.SCRATCH_BYTES and p["slices"] * p["n_ci"] * p["n_ky"] <= 132
    assert p["slices"] <= p["n_chunks"] and p["vec"] == int(xs[4] % 4 == 0 and cw.out_size(shape)[2] % 4 == 0)
    assert p["ms"] * p["tm"] >= ws[0] and 4 * p["ct"] * p["n_ci"] >= xs[1] and p["kzg"] * p["kzt"] >= ws[4]


def _lidc_module_step(model, monkeypatch):
    """One training step of a small LIDC-topology module on the CPU with the
    gate's device test passed: (ConvND layers with a kernel larger than 1
    that took K5 at their last call, the step's ``k5.calls``)."""
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
        calls = trace.summary()["counters"].get("k5.calls", 0)
    finally:
        trace.disable()
    layers = [m for m in net.module.modules()
              if isinstance(m, tbb.ConvND) and m.wgrad_kernel and math.prod(m.conv.kernel_size) > 1]
    return layers, calls


@pytest.mark.parametrize("model,expected", [("retina_unet", 62), ("mrcnn", 29), ("detection_unet", 18)])
def test_gate_admits_the_lidc_convs(model, expected, monkeypatch):
    """The LIDC training cells' modules (and Detection U-Net's, which
    ``chip_smoke.py`` trains on the card too): each stride-1 conv with a
    kernel larger than 1 voxel and cin > 2 takes K5 once a step: 62 calls of
    32 layers in Retina U-Net (its two heads' 10 layers run on 4 pyramid
    levels; the strided 7x7x7 stem keeps cuDNN), 29 of 26 in Mask R-CNN (the
    RPN's conv on 4), 18 of 22 in Detection U-Net (its FPN's four pyramid
    outputs feed no loss, so run no backward); K4's stem keeps its path and
    the 1x1x1 convs take K6 (``test_torch_pointwise_wgrad.py``)."""
    layers, calls = _lidc_module_step(model, monkeypatch)
    assert calls == expected
    for m in layers:
        assert math.prod(m.conv.kernel_size) > 1 and m.conv.in_channels > 2 and not m.stem_kernel
        assert m.conv.stride == (1, 1, 1)
    assert len(layers) == {"retina_unet": 32, "mrcnn": 26, "detection_unet": 22}[model]


def _conv_call(dim=3, cin=4, ks=3, stride=1, pad=1, dtype=torch.float32, grad=True):
    layer = tbb.ConvND(dim, cin, 8, ks=ks, stride=stride, pad=pad, relu=None, dtype=dtype)
    x = torch.randn((2, cin, 16, 16, 8) if dim == 3 else (2, cin, 16, 16))
    with torch.set_grad_enabled(grad):
        layer(x)
    return layer


REFUSED = {
    "bfloat16": lambda: _conv_call(dtype=torch.bfloat16),
    "2d": lambda: _conv_call(dim=2),
    "1x1x1": lambda: _conv_call(ks=1, pad=0, stride=(2, 2, 2)),
    "k4_stem": lambda: _conv_call(cin=1, ks=3),
    "no_grad": lambda: _conv_call(grad=False),
    "z_stride_2": lambda: _conv_call(stride=2),
    "yx_stride_2": lambda: _conv_call(ks=7, stride=(2, 2, 1), pad=3),
}


@pytest.mark.parametrize("case", sorted(REFUSED) + ["tf32_on", "cpu_tensor"])
def test_gate_refuses(case, monkeypatch):
    """bfloat16, TF32 on (exec on one card), 2D, a strided 1x1x1 (the
    ResNet shortcuts; a stride-1 one takes K6), the cin-1 stem under
    ``MDT_STEM_PALLAS=1`` (K4's), no gradient, a stride (z, or y and x as
    the 7x7x7 stem's), a CPU tensor:
    ``F.conv3d`` / ``F.conv2d`` as before; the same conv in float32 with
    TF32 off on the card is admitted."""
    monkeypatch.setenv("MDT_STEM_PALLAS", "1")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", case == "tf32_on")
    if case != "cpu_tensor":
        monkeypatch.setattr(conv_wgrad, "on_card", lambda t: True)
    layer = REFUSED.get(case, _conv_call)()
    assert not layer.wgrad_kernel
    if case == "k4_stem":
        assert layer.stem_kernel
    if case in ("tf32_on", "cpu_tensor"):
        monkeypatch.setattr(conv_wgrad, "on_card", lambda t: True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
        assert _conv_call().wgrad_kernel


@pytest.mark.parametrize("args", [dict(dilation=(2, 1, 1)), dict(groups=2), dict(padding=(3, 1, 1)),
                                  dict(stride=(3, 1, 1))])
def test_gate_refuses_geometry(args, monkeypatch):
    monkeypatch.setattr(conv_wgrad, "on_card", lambda t: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, w = torch.randn(2, 4, 8, 8, 8), torch.randn(8, 4, 3, 3, 3, requires_grad=True)
    assert conv_wgrad.admits(x, w, (1, 1, 1), (1, 1, 1))
    assert not conv_wgrad.admits(x, w, **dict(dict(stride=(1, 1, 1), padding=(1, 1, 1)), **args))


def test_k5_calls_counter():
    """One ``k5.calls`` per K5 call while tracing is on; none while it is
    off."""
    xs, ws, stride, padding = CLASSES["k3_pad1"]
    x, dy = _operands(xs, ws, stride, padding, torch.float32)
    conv_wgrad.conv3d_wgrad(x, dy, ws[2:], stride, padding)
    trace.enable()
    try:
        for _ in range(3):
            conv_wgrad.conv3d_wgrad(x, dy, ws[2:], stride, padding)
        assert trace.summary()["counters"]["k5.calls"] == 3
    finally:
        trace.disable()
    assert trace.summary()["counters"]["k5.calls"] == 3


def test_cuda_wrapper_takes_cuda_tensors_only():
    xs, ws, stride, padding = CLASSES["k3_pad1"]
    x, dy = _operands(xs, ws, stride, padding, torch.float32)
    with pytest.raises(ValueError):
        cw.conv3d_wgrad(x, dy, ws[2:], stride, padding)
    with pytest.raises(ValueError):
        conv_wgrad.conv3d_wgrad(x.to("meta"), dy.to("meta"), ws[2:], stride, padding)
