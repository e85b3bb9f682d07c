"""Port box ops (torch) against ``medicaldetectiontoolkit_tpu.ops.boxes`` in float32.

Tolerance: exact for the ops built from +, -, *, /, min, max (same operation
order in both). ``apply_box_deltas`` / ``box_refinement`` take ``exp`` /
``log`` from different math libraries (XLA's and ATen's), which differ in
the last bit for about one input in ten; that bit is scaled by the box
size, so they are held to 1 ulp of the largest output magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.ops import boxes as jb  # noqa: E402
from medicaldetectiontoolkit_torch.ops import boxes as tb  # noqa: E402

torch.set_num_threads(2)


def rand_boxes(rng, n, dim, extent=64.0):
    lo = rng.rand(n, dim) * extent
    hi = lo + rng.rand(n, dim) * extent / 2 + 0.5
    cols = [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]] + ([lo[:, 2], hi[:, 2]] if dim == 3 else [])
    return np.stack(cols, -1).astype(np.float32)


def assert_within_1ulp_of_scale(got, want):
    atol = np.spacing(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def both(fn_name, *arrays, **kw):
    j = np.asarray(getattr(jb, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in arrays], **kw))
    t = getattr(tb, fn_name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in arrays], **kw)
    return j, t.numpy()


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_box_deltas_and_refinement(dim):
    rng = np.random.RandomState(dim)
    boxes = rand_boxes(rng, 500, dim)
    deltas = (rng.randn(500, 2 * dim) * 0.3).astype(np.float32)
    j, t = both("apply_box_deltas", boxes, deltas)
    assert t.shape == (500, 2 * dim) and t.dtype == np.float32
    assert_within_1ulp_of_scale(t, j)
    gt = rand_boxes(rng, 500, dim)
    j, t = both("box_refinement", boxes, gt)
    assert_within_1ulp_of_scale(t, j)


@pytest.mark.parametrize("dim", [2, 3])
def test_clip_and_shape_ops_exact(dim):
    rng = np.random.RandomState(10 + dim)
    boxes = rand_boxes(rng, 400, dim, extent=90.0) - 10.0
    window = np.array([0, 0, 64, 48] + ([0, 8] if dim == 3 else []))
    j, t = both("clip_boxes", boxes, window)
    np.testing.assert_array_equal(t, j)
    shape = (64, 48, 8)[:dim]
    for fn in ("clip_boxes_to_shape", "normalize_boxes", "denormalize_boxes"):
        j, t = both(fn, boxes, shape)
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("pixel_offset", [0.0, 1.0])
@pytest.mark.parametrize("dim", [2, 3])
def test_area_and_pairwise_iou_exact(dim, pixel_offset):
    rng = np.random.RandomState(20 + dim)
    a, b = rand_boxes(rng, 60, dim), rand_boxes(rng, 45, dim)
    b[:5] = np.round(b[:5])
    b[5, 2] = b[5, 0] - 1.5  # degenerate: zero union with offset 0 guarded
    j, t = both("box_area", a, pixel_offset=pixel_offset)
    np.testing.assert_array_equal(t, j)
    j, t = both("pairwise_iou", a, b, pixel_offset=pixel_offset)
    assert t.shape == (60, 45)
    np.testing.assert_array_equal(t, j)


def test_box_dim_rejects_other_widths():
    with pytest.raises(ValueError, match="4 or 6"):
        tb.box_dim(torch.zeros(3, 5))
