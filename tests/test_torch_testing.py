"""The port's ``testing`` helpers against the JAX package's.

Tolerance: exact. ``make_config`` must give the JAX values for every
attribute it sets, ``make_batch`` the same arrays from the same seed, and a
detector built from either config must give the same results on the same
weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from medicaldetectiontoolkit_tpu import testing as jtesting  # noqa: E402
from medicaldetectiontoolkit_torch import testing as ttesting  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402

torch.set_num_threads(2)

CASES = [
    dict(model="retina_net", dim=2),
    dict(model="retina_unet", dim=2, retina_scales=False),
    dict(model="retina_unet", dim=3),
    dict(model="retina_net", dim=3, patch_size=[32, 64, 16], start_filts=6, end_filts=12, batch_size=3),
    dict(model="mrcnn", dim=2, retina_scales=False),
    dict(model="mrcnn", dim=3, retina_scales=False),
    dict(model="ufrcnn", dim=3, retina_scales=False),
    dict(model="detection_unet", dim=2),
    dict(model="detection_unet", dim=3),
]


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("kwargs", CASES)
def test_make_config_matches_jax(kwargs):
    tcf, jcf = ttesting.make_config(**kwargs), jtesting.make_config(**kwargs)
    for name, value in vars(tcf).items():
        assert _equal(value, getattr(jcf, name)), name


def test_slice_config_is_the_bench_geometry():
    cf = ttesting.make_slice_config("bfloat16")
    assert (cf.model, cf.dim, cf.patch_size, cf.start_filts, cf.end_filts, cf.batch_size) == (
        "retina_unet", 3, [128, 128, 64], 18, 36, 8)
    assert (cf.n_rpn_features, cf.pre_nms_limit, cf.model_max_instances_per_batch_element) == (64, 50000, 30)
    assert cf.compute_dtype == "bfloat16" and cf.operate_stride1 and cf.n_anchors_per_pos == 9
    assert ttesting.make_slice_config().compute_dtype == "float32"


def test_train_slice_config_is_the_bench_workload():
    """``bench.py:161-177``: the slice geometry, 300 training anchors per
    image, batch 8 as 2 x 4 accumulated, remat by the 3D default."""
    from medicaldetectiontoolkit_torch.models.base import resolve_grad_accum, resolve_remat

    cf = ttesting.make_train_slice_config("bfloat16")
    base = ttesting.make_slice_config("bfloat16")
    for k, v in vars(base).items():
        if k not in ("rpn_train_anchors_per_image", "grad_accum_steps"):
            assert _equal(getattr(cf, k), v), k
    assert (cf.rpn_train_anchors_per_image, cf.batch_size, resolve_grad_accum(cf, cf.batch_size)) == (300, 8, 4)
    assert resolve_remat(cf) and cf.compute_dtype == "bfloat16"
    jcf = jtesting.make_config(model="retina_unet", dim=3, patch_size=[128, 128, 64], start_filts=18, end_filts=36,
                               batch_size=8)
    assert (jcf.anchor_matching_iou, jcf.shem_poolsize, jcf.max_gt_boxes, jcf.weight_decay) == (
        cf.anchor_matching_iou, cf.shem_poolsize, cf.max_gt_boxes, cf.weight_decay)


def test_mrcnn_slice_config_is_lidc_mrcnn_on_the_bench_geometry():
    """LIDC's 3D Mask R-CNN (``experiments/lidc_exp/configs.py:164-211``) on
    the bench patch: 74,880 positions x 3 anchors per patch."""
    from medicaldetectiontoolkit_torch.ops.anchors import generate_pyramid_anchors

    cf = ttesting.make_mrcnn_slice_config("bfloat16")
    assert (cf.model, cf.dim, cf.patch_size, cf.start_filts, cf.end_filts, cf.batch_size) == (
        "mrcnn", 3, [128, 128, 64], 18, 36, 8)
    assert (cf.n_rpn_features, cf.pre_nms_limit, cf.rpn_nms_threshold, cf.post_nms_rois_inference,
            cf.roi_chunk_size) == (128, 6000, 0.7, 500, 600)
    assert (cf.pool_size, cf.mask_pool_size, cf.mask_shape) == ((7, 7, 3), (14, 14, 5), (28, 28, 10))
    assert (cf.model_max_instances_per_batch_element, cf.detection_nms_threshold, cf.model_min_confidence,
            cf.head_classes) == (30, 1e-5, 0.1, 3)
    assert cf.compute_dtype == "bfloat16" and not cf.operate_stride1 and not cf.frcnn_mode
    assert cf.n_anchors_per_pos == len(cf.rpn_anchor_ratios) == 3
    assert generate_pyramid_anchors(cf).shape == (224640, 6)
    assert ttesting.make_mrcnn_slice_config().compute_dtype == "float32"


def test_det_unet_slice_config_is_lidc_width():
    """``experiments/lidc_exp/configs.py``'s 3D Detection U-Net: patch
    128x128x64, start_filts 18, end_filts 36, 30 RoI candidates; batch 8 as
    one microbatch, remat."""
    cf = ttesting.make_det_unet_slice_config("bfloat16")
    assert (cf.model, cf.dim, cf.patch_size, cf.start_filts, cf.end_filts, cf.batch_size) == (
        "detection_unet", 3, [128, 128, 64], 18, 36, 8)
    assert (cf.n_roi_candidates, cf.num_seg_classes, cf.grad_accum_steps, cf.use_remat) == (30, 3, 1, True)
    assert cf.compute_dtype == "bfloat16" and cf.operate_stride1 and cf.seg_loss_mode == "dice_wce"


@pytest.mark.parametrize("kwargs", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_matches_jax(kwargs, seed):
    tb = ttesting.make_batch(ttesting.make_config(**kwargs), seed=seed)
    jb = jtesting.make_batch(jtesting.make_config(**kwargs), seed=seed)
    for key, value in tb.items():
        assert _equal(value, jb[key]), key


class _Log:
    def info(self, *a, **k):
        pass


@pytest.mark.parametrize("model,dim", [("retina_unet", 2), ("retina_net", 3), ("mrcnn", 3), ("ufrcnn", 2)])
def test_detector_from_either_config_agrees(model, dim):
    kw = dict(model=model, dim=dim, retina_scales=model in ("retina_net", "retina_unet"))
    tcf, jcf = ttesting.make_config(**kw), jtesting.make_config(**kw)
    a, b = build_model(tcf, _Log(), device="cpu"), build_model(jcf, _Log(), device="cpu")
    a.initialize(seed=3)
    b.load_state_dict(a.state_dict())
    torch.testing.assert_close(a.anchors, b.anchors, rtol=0, atol=0)
    batch = ttesting.make_batch(tcf, seed=1)
    ra, rb = a.test_forward(batch), b.test_forward(batch)
    np.testing.assert_array_equal(ra["seg_preds"], rb["seg_preds"])
    assert _equal(ra["boxes"], rb["boxes"])
