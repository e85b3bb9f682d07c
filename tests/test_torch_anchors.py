"""Port pyramid anchors (torch) against ``medicaldetectiontoolkit_tpu.ops.anchors``.

Tolerance: exact. Both compute in float64 with the same operations in the same
order, so the coordinates, and the float32 anchors the detectors use, are
identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from medicaldetectiontoolkit_tpu.ops import anchors as janchors  # noqa: E402
from medicaldetectiontoolkit_tpu.testing import make_config  # noqa: E402
from medicaldetectiontoolkit_torch.ops import anchors as tanchors  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_slice_config  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("dim,retina_scales,anchor_stride", [(2, True, 1), (2, False, 1), (3, True, 1), (3, False, 1),
                                                             (2, True, 2)])
def test_level_anchors_match_jax(dim, retina_scales, anchor_stride):
    cf = make_config(dim=dim, retina_scales=retina_scales)
    for level in cf.pyramid_levels:
        shape = cf.backbone_shapes[level]
        args = (cf.rpn_anchor_scales["xy"][level], cf.rpn_anchor_ratios, shape, cf.backbone_strides["xy"][level])
        if dim == 2:
            ref = janchors.generate_anchors_2d(*args, anchor_stride)
            got = tanchors.generate_anchors(*args, anchor_stride)
        else:
            ref = janchors.generate_anchors_3d(args[0], cf.rpn_anchor_scales["z"][level], *args[1:],
                                               cf.backbone_strides["z"][level], anchor_stride)
            got = tanchors.generate_anchors(*args, anchor_stride, scales_z=cf.rpn_anchor_scales["z"][level],
                                            feature_stride_z=cf.backbone_strides["z"][level])
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dim", [2, 3])
def test_pyramid_anchors_match_jax(dim):
    cf = make_config(dim=dim)
    ref = janchors.generate_pyramid_anchors(cf)
    got = tanchors.generate_pyramid_anchors(cf)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref.astype(np.float32))


def test_slice_geometry_anchor_count():
    """The served 3D geometry: 74,880 positions x 9 anchors, same as JAX."""
    cf = make_slice_config()
    got = tanchors.generate_pyramid_anchors(cf)
    assert got.shape == (673920, 6)
    np.testing.assert_array_equal(got.numpy(), janchors.generate_pyramid_anchors(cf))
