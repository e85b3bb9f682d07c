"""Port RoIAlign (plain PyTorch) against the JAX RoIAlign: ``roi_align``, the
NumPy oracle, ``pyramid_roi_align_xla``, the Pallas kernel in interpret mode,
and the level assignment of ``mrcnn.pyramid_roi_align``.

Tolerances:
  * against JAX's ``roi_align`` and ``pyramid_roi_align_xla``: 1e-5
    relative plus 1e-6 absolute on maps in [0, 1), 1e-5 absolute on maps
    drawn from a unit normal (XLA:CPU may contract a multiply and an add of
    a lerp into one fused op where PyTorch rounds twice: a few ulps over up
    to three chained lerps, more where a lerp of opposite signs cancels);
    indices and lerp weights of ``_level_axis_indices`` exactly (the same
    float32 operations, no multiply-add to contract);
  * against the Pallas kernel in interpret mode: as against the XLA
    formulation, which the JAX package holds that kernel to within 2e-5
    relative (``tests/test_roi_align_pallas.py``);
  * against the float64 NumPy oracle: 1e-5 absolute (float32 rounding);
  * output dtype float32 for bf16 maps on both sides, exactly;
  * FPN level assignment: equal for random boxes. For boxes built to lie
    within a few ulps of a .5 rounding boundary, XLA's ``log`` and
    PyTorch's differ in the last bit for some inputs, so such a box may land
    one level apart; the test counts them, and every one must be within
    1e-6 of the boundary in float64.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import mrcnn as jmrcnn  # noqa: E402
from medicaldetectiontoolkit_tpu.ops import roi_align as jroi  # noqa: E402
from medicaldetectiontoolkit_tpu.ops import roi_align_pallas as jpallas  # noqa: E402
from medicaldetectiontoolkit_torch.models import mrcnn as tmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch.ops import roi_align as troi  # noqa: E402
from medicaldetectiontoolkit_torch.ops import roi_align_cuda  # noqa: E402
from medicaldetectiontoolkit_torch.tools import time_roi_align as roi_tool  # noqa: E402

torch.set_num_threads(2)


def to_cf(x):
    """JAX channel-last (B, *sp, C) numpy -> port channel-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1)))


def from_cf(t):
    """port (R, C, *crop) -> JAX channel-last (R, *crop, C) numpy."""
    return np.moveaxis(t.numpy(), 1, -1)


def edge_boxes(dim):
    """Boxes beyond [0, 1] (clamped), zero-size boxes and a full box."""
    rows = [[-0.2, -0.3, 1.4, 1.2], [0.9, 0.9, 1.1, 1.3], [0.5, 0.5, 0.5, 0.5], [0.0, 0.0, 1.0, 1.0],
            [0.3, 0.7, 0.3, 0.9]]
    z = [[-0.5, 1.5], [0.8, 1.2], [0.5, 0.5], [0.0, 1.0], [0.2, 0.2]]
    return np.array([r + zz for r, zz in zip(rows, z)] if dim == 3 else rows, np.float32)


def random_boxes(rng, dim, R):
    lo = rng.rand(R, dim) * 0.6
    hi = lo + rng.rand(R, dim) * 0.4
    cols = [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]] + ([lo[:, 2], hi[:, 2]] if dim == 3 else [])
    return np.stack(cols, -1).astype(np.float32)


@pytest.mark.parametrize("dim,crop", [(2, (7, 7)), (2, (1, 1)), (2, (3, 5)), (3, (7, 7, 3)), (3, (4, 4, 1)),
                                      (3, (1, 1, 1))])
def test_roi_align_matches_jax_and_oracle(dim, crop):
    rng = np.random.RandomState(dim * 10 + crop[0])
    img = rng.rand(2, *((16, 20, 6)[:dim]), 3).astype(np.float32)
    boxes = np.concatenate([random_boxes(rng, dim, 6), edge_boxes(dim)])
    idx = rng.randint(0, 2, len(boxes)).astype(np.int32)
    want = np.asarray(jroi.roi_align(jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(idx), crop))
    got = troi.roi_align(to_cf(img), torch.from_numpy(boxes), torch.from_numpy(idx), crop)
    assert got.shape == (len(boxes), 3, *crop) and got.dtype == torch.float32
    np.testing.assert_allclose(from_cf(got), want, rtol=1e-5, atol=1e-6)
    oracle = jroi.roi_align_numpy_reference(img, boxes, idx, crop)
    np.testing.assert_allclose(from_cf(got), oracle, rtol=0, atol=1e-5)


def make_pyramid(rng, dim, B=2, C=5, L=3, dtype=np.float32):
    base = (16, 16, 8)[:dim]
    return [rng.randn(B, *(max(1, s // 2**lvl) for s in base), C).astype(dtype) for lvl in range(L)]


@pytest.mark.parametrize("dim,crop", [(2, (5, 5)), (2, (7, 7)), (3, (7, 7, 3)), (3, (3, 3, 1))])
@pytest.mark.parametrize("bf16", [False, True])
def test_pyramid_matches_xla_and_pallas(dim, crop, bf16):
    rng = np.random.RandomState(dim + 7 * crop[0] + bf16)
    fms = make_pyramid(rng, dim)
    boxes = np.concatenate([random_boxes(rng, dim, 13), edge_boxes(dim)])
    R = len(boxes)
    bix = rng.randint(0, 2, R).astype(np.int32)
    lvl = (np.arange(R) % 3).astype(np.int32)  # every level
    jfms = [jnp.asarray(f) for f in fms]
    tfms = [to_cf(f) for f in fms]
    if bf16:
        jfms = [f.astype(jnp.bfloat16) for f in jfms]
        tfms = [f.to(torch.bfloat16) for f in tfms]
        # the same bf16 values on both sides
        for j, t in zip(jfms, tfms):
            np.testing.assert_array_equal(np.moveaxis(np.asarray(j.astype(jnp.float32)), -1, 1), t.float().numpy())
    args = (jnp.asarray(boxes), jnp.asarray(bix), jnp.asarray(lvl), crop)
    want = np.asarray(jpallas.pyramid_roi_align_xla(jfms, *args))
    kern = np.asarray(jpallas.pyramid_roi_align_pallas(jfms, *args, interpret=True))
    got = troi.pyramid_roi_align(tfms, torch.from_numpy(boxes), torch.from_numpy(bix), torch.from_numpy(lvl), crop)
    assert got.dtype == torch.float32 and want.dtype == kern.dtype == np.float32
    assert got.shape == (R, 5, *crop)
    np.testing.assert_allclose(from_cf(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(from_cf(got), kern, rtol=2e-5, atol=1e-5)
    # the dispatcher takes the plain version for CPU tensors
    auto = troi.pyramid_roi_align_auto(tfms, torch.from_numpy(boxes), torch.from_numpy(bix),
                                       torch.from_numpy(lvl), crop)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("dim,crop", [(2, (7, 7)), (3, (14, 14, 5))])
def test_level_axis_indices_match_jax(dim, crop):
    rng = np.random.RandomState(3)
    boxes = np.concatenate([random_boxes(rng, dim, 40), edge_boxes(dim)])
    lvl = rng.randint(0, 4, len(boxes)).astype(np.int32)
    sizes = [32, 16, 8, 4]
    for ax, ((lo, hi), c) in enumerate(zip(troi._AXIS_COLS, crop)):
        want = jpallas._level_axis_indices(jnp.asarray(boxes), jnp.asarray(lvl), c, sizes, lo, hi)
        got = troi._level_axis_indices(torch.from_numpy(boxes), torch.from_numpy(lvl), c, sizes, lo, hi)
        for w, g in zip(want, got):
            assert g.dtype == (torch.int32 if w.dtype == jnp.int32 else torch.float32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def boundary_boxes(rng, n):
    """Normalised 2D boxes whose h*w lies within a few ulps of a level
    boundary 2**(2k - 9) (where 4 + log2(sqrt(h*w)) = k - 0.5)."""
    rows = []
    for k in (2, 3, 4, 5):
        target = 2.0 ** (2 * k - 9)
        for _ in range(n):
            h = float(np.clip(math.sqrt(target) * (0.7 + 0.6 * rng.rand()), 1e-3, 1.0))
            w = min(target / h * (1 + (rng.rand() - 0.5) * 2e-6), 1.0)
            y1, x1 = rng.rand() * (1 - h), rng.rand() * (1 - w)
            rows.append([y1, x1, y1 + h, x1 + w])
    return np.array(rows, np.float32)


def levels_of(boxes, levels):
    """(JAX, port) level of each box: each side's own pyramid RoIAlign over
    constant maps (level l filled with l), crop 1 (an out-of-range level
    pools zeros on both sides)."""
    n = len(levels)
    jfms = [jnp.full((1, 8, 8, 1), float(i), jnp.float32) for i in range(n)]
    jfn = jax.jit(lambda f, b: jmrcnn.pyramid_roi_align(f, b, jnp.zeros(b.shape[0], jnp.int32), (1, 1), levels))
    want = np.asarray(jfn(jfms, jnp.asarray(boxes))).reshape(-1)
    tfms = [torch.full((1, 1, 8, 8), float(i)) for i in range(n)]
    got = tmrcnn.pyramid_roi_align(tfms, torch.from_numpy(boxes), torch.zeros(len(boxes), dtype=torch.int32),
                                   (1, 1), levels).reshape(-1).numpy()
    return want, got


@pytest.mark.parametrize("levels", [(0, 1, 2, 3), (1, 2, 3), (0, 1, 2, 3, 4)])
def test_level_assignment_matches_jax(levels):
    rng = np.random.RandomState(len(levels))
    lo = rng.rand(400, 2) * 0.7
    boxes = np.concatenate([lo, lo + rng.rand(400, 2) * 0.3], 1).astype(np.float32)
    # zero-area boxes go to the first level; with a 5th level, h*w > 0.65 to P6
    boxes = np.concatenate([boxes, np.array([[0.2, 0.2, 0.2, 0.6], [0.5, 0.5, 0.5, 0.5], [0.0, 0.0, 0.9, 0.8],
                                             [0.0, 0.0, 0.8, 0.8]], np.float32)])
    want, got = levels_of(boxes, levels)
    np.testing.assert_array_equal(got, want)
    assert len(set(want.tolist())) >= 3  # the boxes span several levels
    assert tmrcnn.roi_levels(torch.from_numpy(boxes[-4:-2]), levels).tolist() == [0, 0]


def test_level_assignment_near_rounding_boundaries():
    boxes = boundary_boxes(np.random.RandomState(0), 100)
    want, got = levels_of(boxes, (0, 1, 2, 3))
    flips = np.flatnonzero(got != want)
    b = boxes.astype(np.float64)
    x = 4.0 + np.log2(np.sqrt((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])))
    assert np.all(np.abs(x[flips] - np.floor(x[flips]) - 0.5) < 1e-6), boxes[flips]
    assert np.all(np.abs(got[flips] - want[flips]) == 1)
    assert flips.size < 0.1 * len(boxes), f"{flips.size} of {len(boxes)} boundary boxes flip"


def test_dispatcher_refuses_other_devices_and_cuda_wrapper_refuses_cpu():
    rng = np.random.RandomState(0)
    fms = [to_cf(f) for f in make_pyramid(rng, 2)]
    boxes = torch.from_numpy(random_boxes(rng, 2, 4))
    bix = torch.zeros(4, dtype=torch.int32)
    lvl = torch.zeros(4, dtype=torch.int32)
    meta = [f.to("meta") for f in fms]
    with pytest.raises(ValueError, match="meta"):
        troi.pyramid_roi_align_auto(meta, boxes.to("meta"), bix.to("meta"), lvl.to("meta"), (3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda.pyramid_roi_align(fms, boxes, bix, lvl, (3, 3))
    assert roi_align_cuda.pyramid_roi_align.launches == 0


def test_cuda_level_struct_matches_the_source():
    """The ctypes mirror of ``struct Level`` in ``csrc/roi_align.cu``: one
    pointer, the int64 strides of B and C, the three extents and three
    in-plane strides as int32, 48 bytes; and the source's caps."""
    import ctypes

    assert ctypes.sizeof(roi_align_cuda._Level) == 48
    assert [f for f, _ in roi_align_cuda._Level._fields_] == ["data", "sb", "sc", "size", "stride"]
    src = roi_align_cuda.SOURCE.read_text()
    assert "  long long sb, sc;" in src and "  int size[3];" in src and "  int stride[3];" in src
    assert f"constexpr int kMaxLevels = {roi_align_cuda.MAX_LEVELS};" in src
    assert roi_align_cuda.MAX_OUTPUTS == 2**30 and "constexpr long long kMaxOutputs = 1LL << 30;" in src
    assert f"constexpr int kMaxCrop = {roi_align_cuda.MAX_CROP};" in src
    assert f"constexpr int kSlabFloats = {roi_align_cuda.SLAB_FLOATS};" in src
    # the launcher's slab limit, as prepare computes it
    assert "2LL * ch * (dim == 3 ? 2LL * cw * (2 * cz + 1) : 2 * cw + 1)" in src


# ---- the CUDA kernel's arithmetic, modelled on the CPU ----------------------
#
# ``csrc/roi_align.cu`` computes each RoI's rows itself and evaluates its
# outputs from a shared-memory slab. Both are modelled here in numpy float32
# and held bit for bit (no tolerance) against the plain version on the CPU:
# the rows by ``roi_align_cuda.level_axis_rows`` in the CPU's division form,
# the evaluation by ``slab_model`` below, which follows the kernel's slots,
# strided addressing and association.

F32 = np.float32
LIDC = [(32, 32, 64), (16, 16, 32), (8, 8, 16), (4, 4, 8)]


@pytest.mark.parametrize("dim,crop", [(2, (7, 7)), (2, (1, 1)), (3, (7, 7, 3)), (3, (14, 14, 5)), (3, (4, 4, 1))])
@pytest.mark.parametrize("kind", ["random", "edge", "adversarial"])
def test_kernel_row_model_matches_plain_and_jax(dim, crop, kind):
    """The kernel's row arithmetic (``roi_align_cuda.level_axis_rows``) in
    the CPU's division form equals the plain ``_level_axis_indices`` and
    JAX's exactly; level indices outside the pyramid give zero rows on all
    three. On the card the kernel scales by the reciprocal, as PyTorch's CUDA
    division by a Python number does; on the division-adversarial boxes of
    ``tools/time_roi_align.py`` that form differs from the CPU's, and its
    lattice boxes land on integer coordinates and on S - 1."""
    rng = np.random.RandomState(len(kind) + 10 * crop[0] + dim)
    sizes = [s[:dim] for s in LIDC]
    R = 200
    lvl = rng.randint(-1, 5, R).astype(np.int32)  # -1 and 4: outside the 4 levels
    on = np.clip(lvl, 0, 3)
    if kind == "random":
        boxes = random_boxes(rng, dim, R)
    elif kind == "edge":
        boxes = np.resize(edge_boxes(dim), (R, 2 * dim))
    else:
        boxes = roi_tool.adversarial_boxes(np, rng, dim, crop, sizes, lvl)
    assert roi_align_cuda.SCALE_BY_RECIPROCAL  # the card's form, copied by the kernel
    differs = False
    for ax, ((lo, hi), c) in enumerate(zip(troi._AXIS_COLS, crop)):
        axis_sizes = [s[ax] for s in sizes]
        model = roi_align_cuda.level_axis_rows(boxes, lvl, c, axis_sizes, lo, hi, reciprocal=False)
        plain = troi._level_axis_indices(torch.from_numpy(boxes), torch.from_numpy(lvl), c, axis_sizes, lo, hi)
        jx = jpallas._level_axis_indices(jnp.asarray(boxes), jnp.asarray(lvl), c, axis_sizes, lo, hi)
        for m, p, j in zip(model, plain, jx):
            assert m.dtype == p.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_array_equal(m, p.numpy())
            np.testing.assert_array_equal(m, np.asarray(j))
        card = roi_align_cuda.level_axis_rows(boxes, lvl, c, axis_sizes, lo, hi, reciprocal=True)
        differs |= not all(np.array_equal(a, b) for a, b in zip(card, model))
    if kind == "adversarial" and any(c & (c - 1) for c in crop):
        assert differs  # these boxes tell the card's form from the CPU's
    if kind == "adversarial" and crop[0] > 1:
        # lattice boxes on levels that hold the crop's cells: every y
        # coordinate an integer, and the last one S - 1 at indices 3 mod 8
        y0, _, ly = roi_align_cuda.level_axis_rows(boxes, lvl, crop[0], [s[0] for s in sizes], 0, 2)
        S = np.array([s[0] for s in sizes])[on]
        fits = (np.arange(R) % 4 == 3) & (lvl >= 0) & (lvl < 4) & (S >= crop[0])
        assert fits.sum() > 10 and np.all(ly[fits] == 0)
        last = fits & (np.arange(R) % 8 == 3)
        assert last.any() and np.array_equal(y0[last, -1], S[last] - 1)


def axis_slots(idx0, idx1, n):
    """The kernel's slab slots of one axis of one RoI: the index range when
    it holds at most 2n indices, else the 2n corner indices themselves.
    Returns (slot -> map index, slot of idx0, slot of idx1)."""
    lo, hi = int(idx0.min()), int(idx1.max())
    if hi - lo + 1 <= 2 * n:
        return np.arange(lo, hi + 1), idx0 - lo, idx1 - lo
    return np.stack([idx0, idx1], 1).reshape(-1), 2 * np.arange(n), 2 * np.arange(n) + 1


def slab_model(fms, boxes, bix, lvl, crop, reciprocal=False):
    """numpy float32 model of the kernel: per RoI, its rows on its level,
    the slab of every channel gathered through the map's strides at the slot
    indices (bf16 and f16 converted to float32), and each output as
    lerp_z(lerp_x(lerp_y(corners))) with lerp(a, b, w) = a * (1 - w) + b * w.
    A level outside the pyramid gives zeros."""
    dim = len(crop)
    boxes, bix, lvl = boxes.numpy(), bix.numpy(), lvl.numpy()
    C = fms[0].shape[1]
    out = np.zeros((len(boxes), C, *crop), F32)
    for r in range(len(boxes)):
        if not 0 <= lvl[r] < len(fms):
            continue
        fm = fms[lvl[r]]
        # the map's storage, read through its strides as the kernel does
        flat = torch.as_strided(fm, (fm.untyped_storage().nbytes() // fm.element_size(),), (1,), 0).float().numpy()
        sizes, strides = fm.shape[2:], fm.stride()
        tables, rows = [], []
        for ax, ((lo, hi), n) in enumerate(zip(troi._AXIS_COLS, crop)):
            i0, i1, w = roi_align_cuda.axis_rows(boxes[r:r + 1, lo], boxes[r:r + 1, hi], n, sizes[ax], reciprocal)
            table, s0, s1 = axis_slots(i0[0], i1[0], n)
            tables.append(table * (strides[2 + ax] if sizes[ax] > 1 else 0))
            rows.append((s0, s1, w[0], F32(1) - w[0]))
        offs = fm.storage_offset() + bix[r] * strides[0] + np.arange(C) * strides[1]
        grid = np.ix_(offs, *tables)
        slab = flat[sum(grid)]  # (C, slots_y, slots_x, (slots_z))

        def at(*sl):
            return slab[np.ix_(np.arange(C), *sl)]

        (y0, y1, wy, my), (x0, x1, wx, mx) = rows[0], rows[1]
        wy, my = wy[:, None], my[:, None]
        if dim == 2:
            c0 = at(y0, x0) * my + at(y1, x0) * wy
            c1 = at(y0, x1) * my + at(y1, x1) * wy
            out[r] = c0 * mx + c1 * wx
            continue
        z0, z1, wz, mz = rows[2]
        wy, my, wx, mx = wy[..., None], my[..., None], wx[:, None], mx[:, None]
        col = []
        for zc in (z0, z1):
            c0 = at(y0, x0, zc) * my + at(y1, x0, zc) * wy
            c1 = at(y0, x1, zc) * my + at(y1, x1, zc) * wy
            col.append(c0 * mx + c1 * wx)
        out[r] = col[0] * mz + col[1] * wz
    return out


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_kernel_slab_model_matches_plain(dim, dtype, layout):
    """The kernel's evaluation (``slab_model``: range and corner-list slots,
    strided addressing, the y -> x -> z association) equals the plain
    ``pyramid_roi_align`` bit for bit on the CPU, on random, edge,
    division-adversarial and lattice boxes over every level, with level
    indices -1 and n_levels, in float32 and bf16 maps; "strided" makes
    level 0 a channels-last view and level 1 a slice of a larger map."""
    rng = np.random.RandomState(dim * 3 + len(dtype) + len(layout))
    tdt = getattr(torch, dtype)
    sizes = [s[:dim] for s in [(16, 16, 8), (8, 8, 4), (4, 4, 2), (2, 2, 1)]]
    B, C = 2, 3
    fms = [torch.from_numpy(rng.randn(B, C, *s).astype(F32)).to(tdt) for s in sizes]
    if layout == "strided":
        fms[0] = torch.from_numpy(rng.randn(B, *sizes[0], C).astype(F32)).to(tdt).movedim(-1, 1)
        s1 = sizes[1]
        wide = torch.from_numpy(rng.randn(B, 2 * C, s1[0], s1[1] + 3, *s1[2:]).astype(F32)).to(tdt)
        fms[1] = wide[:, ::2, :, 1:s1[1] + 1]
    for crop in [(7, 7, 3), (14, 14, 5), (1, 1, 1)] if dim == 3 else [(7, 7), (14, 14), (1, 1)]:
        n = 24
        lvl = np.tile(np.arange(-1, 5), n // 6 * 4).astype(np.int32)  # every level, and -1, 4
        parts = [random_boxes(rng, dim, n), np.resize(edge_boxes(dim), (n, 2 * dim)),
                 roi_tool.adversarial_boxes(np, rng, dim, crop, sizes, lvl[2 * n:])]
        boxes = torch.from_numpy(np.concatenate(parts))
        bix = torch.from_numpy(rng.randint(0, B, len(boxes)).astype(np.int32))
        tl = torch.from_numpy(lvl)
        want = troi.pyramid_roi_align(fms, boxes, bix, tl, crop)
        got = slab_model(fms, boxes, bix, tl, crop)
        assert want.dtype == torch.float32 and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got, want.numpy())


def test_prepare_refuses_crops_beyond_the_kernel():
    """``prepare`` refuses a crop the kernel does not take (more than
    MAX_CROP cells on an axis, or a slab beyond SLAB_FLOATS) before it looks
    at the tensors, and takes the main path's crops."""
    fms = [torch.zeros(1, 1, 4, 4, 4)]
    args = (torch.zeros(1, 6), torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    for crop in [(65, 1, 1), (40, 40, 3), (0, 7, 3)]:
        with pytest.raises(ValueError, match="crop_size"):
            roi_align_cuda.prepare(fms, *args, crop)
    for crop in [(7, 7, 3), (14, 14, 5)]:  # past the crop check: the CPU maps are refused
        with pytest.raises(ValueError, match="CUDA"):
            roi_align_cuda.prepare(fms, *args, crop)
