"""Port NMS (plain PyTorch) against the JAX NMS: Pallas kernel in interpret
mode, the XLA ``batched_nms`` and the NumPy oracle.

Tolerance: none. Keep lists must be identical (idx and mask), because the
port computes IoU in the same float32 operation order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.ops import nms as jnms  # noqa: E402
from medicaldetectiontoolkit_tpu.ops.nms_pallas import nms_pallas  # noqa: E402
from medicaldetectiontoolkit_torch.ops import nms as tnms  # noqa: E402
from medicaldetectiontoolkit_torch.ops import nms_cuda  # noqa: E402

torch.set_num_threads(2)


def make_case(seed, L, n, dim, integer=False, ties=False, valid_frac=None, dead_lane=None):
    rng = np.random.RandomState(seed)
    extent, size = (20.0, 5.0) if integer else (80.0, 30.0)
    lo = rng.rand(L, n, dim) * extent
    hi = lo + rng.rand(L, n, dim) * size + 1.0
    if integer:
        lo, hi = np.round(lo), np.round(hi)
    cols = [lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]] + ([lo[..., 2], hi[..., 2]] if dim == 3 else [])
    boxes = np.stack(cols, -1).astype(np.float32)
    scores = (rng.randint(0, 8, (L, n)) / 8.0 if ties else rng.rand(L, n)).astype(np.float32)
    valid = None
    if valid_frac is not None:
        valid = rng.rand(L, n) < valid_frac
        if dead_lane is not None:
            valid[dead_lane] = False
    return boxes, scores, valid


CASES = {
    # name: (make_case kwargs, thresh, max_output)
    "random_2d": (dict(seed=0, L=3, n=100, dim=2, valid_frac=0.8), 0.4, 16),
    "random_3d": (dict(seed=1, L=3, n=100, dim=3, valid_frac=0.8), 0.3, 16),
    "ties_int_2d": (dict(seed=2, L=2, n=128, dim=2, integer=True, ties=True), 0.1, 40),
    "ties_int_3d": (dict(seed=3, L=2, n=128, dim=3, integer=True, ties=True), 0.1, 40),
    "all_invalid_lane": (dict(seed=4, L=3, n=64, dim=3, valid_frac=0.5, dead_lane=1), 0.5, 8),
    "n37": (dict(seed=5, L=2, n=37, dim=2), 0.5, 10),
    "max_output_gt_survivors": (dict(seed=6, L=2, n=20, dim=3, integer=True), 0.0, 32),
}


@pytest.mark.parametrize("pixel_offset", [0.0, 1.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax(case, pixel_offset):
    kw, thresh, max_out = CASES[case]
    boxes, scores, valid = make_case(**kw)
    t_idx, t_mask = tnms.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), thresh, max_out,
        valid=None if valid is None else torch.from_numpy(valid), pixel_offset=pixel_offset,
    )
    t_idx, t_mask = t_idx.numpy(), t_mask.numpy()
    jv = None if valid is None else jnp.asarray(valid)
    x_idx, x_mask = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out, valid=jv,
                                     pixel_offset=pixel_offset)
    p_idx, p_mask = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out, valid=jv,
                               pixel_offset=pixel_offset, interpret=True)
    for idx, mask in ((x_idx, x_mask), (p_idx, p_mask)):
        np.testing.assert_array_equal(t_idx, np.asarray(idx))
        np.testing.assert_array_equal(t_mask, np.asarray(mask))
    for lane in range(scores.shape[0]):
        s = scores[lane] if valid is None else np.where(valid[lane], scores[lane], -np.inf)
        want = [k for k in jnms.nms_numpy_reference(boxes[lane], s, thresh, pixel_offset) if np.isfinite(s[k])]
        np.testing.assert_array_equal(t_idx[lane][t_mask[lane]], np.asarray(want[:max_out], np.int32))
    if case == "all_invalid_lane":
        assert not t_mask[1].any() and (t_idx[1] == -1).all()


def test_broadcast_lanes_match_materialised():
    """refine_detections passes one box/score array expanded to every lane
    (stride 0); the result equals materialised per-lane copies."""
    boxes, scores, _ = make_case(seed=7, L=1, n=300, dim=3, integer=True, ties=True)
    valid = np.random.RandomState(8).randint(0, 4, 300)[None] == np.arange(4)[:, None]
    tb, ts, tv = torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid)
    a = tnms.batched_nms(tb.expand(4, 300, 6), ts.expand(4, 300), 1e-5, 12, valid=tv)
    b = tnms.batched_nms(tb.repeat(4, 1, 1), ts.repeat(4, 1), 1e-5, 12, valid=tv)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    base, stride = nms_cuda._lane_rows(ts.expand(4, 300), torch.float32)
    assert stride == 0 and tuple(base.shape) == (300,)


def test_kernel_coordinate_layout():
    """The CUDA wrapper hands the kernel SoA coordinates (lanes, 2*dim, N),
    one shared row block with lane stride 0 for an expanded lane axis."""
    boxes, _, _ = make_case(seed=12, L=3, n=40, dim=3)
    tb = torch.from_numpy(boxes)
    base, stride = nms_cuda._lane_rows(tb.transpose(1, 2), torch.float32)
    assert base.is_contiguous() and stride == 6 * 40
    assert torch.equal(base, tb.transpose(1, 2))
    base, stride = nms_cuda._lane_rows(tb[:1].expand(3, 40, 6).transpose(1, 2), torch.float32)
    assert base.is_contiguous() and stride == 0
    assert torch.equal(base, tb[0].t())


@pytest.mark.parametrize("dim", [2, 3])
def test_single_lane_nms_matches_jax(dim):
    boxes, scores, valid = make_case(seed=11 + dim, L=1, n=90, dim=dim, valid_frac=0.7)
    t_idx, t_mask = tnms.nms(torch.from_numpy(boxes[0]), torch.from_numpy(scores[0]), 0.3, 12,
                             valid=torch.from_numpy(valid[0]))
    j_idx, j_mask = jnms.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.3, 12, valid=jnp.asarray(valid[0]))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    assert t_mask.any()


def test_dispatcher_keys_on_device(monkeypatch):
    boxes, scores, valid = make_case(seed=9, L=2, n=50, dim=2, valid_frac=0.7)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 8)
    kw = dict(valid=torch.from_numpy(valid))

    def no_kernel(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(nms_cuda, "batched_nms", no_kernel)
    got = tnms.batched_nms_auto(*args, **kw)
    want = tnms.batched_nms(*args, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="no NMS implementation"):
        tnms.batched_nms_auto(*(a.to("meta") if torch.is_tensor(a) else a for a in args))


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises on CPU tensors before building."""
    boxes, scores, _ = make_case(seed=10, L=2, n=16, dim=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        nms_cuda.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 4)
