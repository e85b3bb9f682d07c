"""Small synthetic configs and batches for the port's scripts and tests.

Counterpart of ``medicaldetectiontoolkit_tpu/testing.py``, cut to what the
ported inference path reads. ``make_config`` gives the same values as the JAX
package's ``make_config`` (``testing.py:10-95``) for every attribute it sets,
and ``make_batch`` draws the same arrays from the same seed
(``testing.py:98-131``); ``tests/test_torch_testing.py`` holds them equal.
The config is a plain attribute bag, so an experiment's own config object
(e.g. the JAX package's ``DefaultConfigs`` subclass) serves the port as well.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np


def make_config(model="retina_net", dim=2, patch_size=None, start_filts=4, end_filts=8, batch_size=2,
                retina_scales=True):
    """Small but complete inference config (toy-experiment geometry scaled down)."""
    if patch_size is None:
        patch_size = [64, 64] if dim == 2 else [64, 64, 8]
    ps = list(patch_size)
    cf = SimpleNamespace(
        model=model,
        dim=dim,
        seed=0,
        # DefaultConfigs defaults (``config.py:38-107``)
        relu="relu",
        norm=None,
        weight_init=None,
        sixth_pooling=False,
        compute_dtype="float32",
        test_aug=True,
        patch_size=ps,
        batch_size=batch_size,
        n_channels=1,
        start_filts=start_filts,
        end_filts=end_filts,
        res_architecture="resnet50",
        head_classes=3,
        num_seg_classes=2,
        n_rpn_features=8,
        rpn_anchor_ratios=[0.5, 1, 2],
        rpn_anchor_stride=1,
        backbone_strides={"xy": [4, 8, 16, 32], "z": [1, 2, 4, 8]},
        rpn_anchor_scales={"xy": [[8], [16], [32], [64]], "z": [[2], [4], [8], [16]]},
        pyramid_levels=[0, 1, 2, 3],
        pre_nms_limit=500,
        model_max_instances_per_batch_element=10,
        detection_nms_threshold=1e-5,
        model_min_confidence=0.1,
        operate_stride1=model in ("retina_unet", "ufrcnn", "detection_unet"),
    )
    if retina_scales:
        for ax in ("xy", "z"):
            cf.rpn_anchor_scales[ax] = [[s[0], s[0] * 2 ** (1 / 3), s[0] * 2 ** (2 / 3)]
                                        for s in cf.rpn_anchor_scales[ax]]
    cf.n_anchors_per_pos = 9 if retina_scales else 3
    strides_xy, strides_z = cf.backbone_strides["xy"], cf.backbone_strides["z"]
    if dim == 2:
        cf.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.2, 0.2])
        cf.window = np.array([0, 0, ps[0], ps[1]])
        cf.scale = np.array([ps[0], ps[1], ps[0], ps[1]])
        cf.backbone_shapes = np.array([[int(np.ceil(ps[0] / s)), int(np.ceil(ps[1] / s))] for s in strides_xy])
    else:
        cf.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        cf.window = np.array([0, 0, ps[0], ps[1], 0, ps[2]])
        cf.scale = np.array([ps[0], ps[1], ps[0], ps[1], ps[2], ps[2]])
        cf.backbone_shapes = np.array(
            [[int(np.ceil(ps[0] / s)), int(np.ceil(ps[1] / s)), int(np.ceil(ps[2] / sz))]
             for s, sz in zip(strides_xy, strides_z)]
        )
    cf.bbox_std_dev = cf.rpn_bbox_std_dev.copy()
    return cf


def make_slice_config(compute_dtype="float32"):
    """The port's served configuration: 3D Retina U-Net at LIDC width on the
    bench geometry (``bench.py:161-176``), 673,920 anchors per patch."""
    cf = make_config(model="retina_unet", dim=3, patch_size=[128, 128, 64], start_filts=18, end_filts=36,
                     batch_size=8)
    cf.n_rpn_features = 64
    cf.pre_nms_limit = 50000
    cf.model_max_instances_per_batch_element = 30
    cf.compute_dtype = compute_dtype
    return cf


def make_batch(cf, seed=42):
    """Synthetic batch dict in the framework's data contract: channel-first
    float32 ``data`` in [0, 1), one box-shaped lesion per element in ``seg``
    and ``bb_target``."""
    rng = np.random.RandomState(seed)
    bsz, ps = cf.batch_size, cf.patch_size
    data = rng.rand(bsz, cf.n_channels, *ps).astype(np.float32)
    seg = np.zeros((bsz, 1) + tuple(ps), dtype=np.uint8)
    boxes, labels = [], []
    for b in range(bsz):
        y1, x1 = rng.randint(2, ps[0] // 2, 2)
        y2 = y1 + rng.randint(8, ps[0] // 2)
        x2 = x1 + rng.randint(8, ps[1] // 2)
        if cf.dim == 2:
            boxes.append(np.array([[y1, x1, y2, x2]], np.float32))
            seg[b, 0, y1:y2, x1:x2] = 1
        else:
            z1 = rng.randint(0, max(1, ps[2] // 2))
            z2 = min(z1 + rng.randint(2, max(3, ps[2] // 2 + 1)), ps[2])
            boxes.append(np.array([[y1, x1, y2, x2, z1, z2]], np.float32))
            seg[b, 0, y1:y2, x1:x2, z1:z2] = 1
        labels.append(np.array([rng.randint(1, cf.head_classes)]))
    return {
        "data": data,
        "seg": seg,
        "bb_target": boxes,
        "roi_labels": labels,
        "pid": [str(i) for i in range(bsz)],
        "class_target": np.array([[lab[0] - 1] for lab in labels]),
    }
