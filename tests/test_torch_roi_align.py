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
    pointer and five int64 strides, 48 bytes; and the source's caps."""
    import ctypes

    assert ctypes.sizeof(roi_align_cuda._Level) == 48
    assert [f for f, _ in roi_align_cuda._Level._fields_] == ["data", "sb", "sc", "sy", "sx", "sz"]
    src = roi_align_cuda.SOURCE.read_text()
    assert f"constexpr int kMaxLevels = {roi_align_cuda.MAX_LEVELS};" in src
    assert roi_align_cuda.MAX_OUTPUTS == 2**30 and "constexpr long long kMaxOutputs = 1LL << 30;" in src
