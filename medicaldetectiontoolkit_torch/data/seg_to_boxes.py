"""Segmentation -> bounding box conversion (post-augmentation box drawing).

Counterpart of ``medicaldetectiontoolkit_tpu/data/seg_to_boxes.py`` (the
port keeps its own copy; scipy only). Functional re-implementation of
batchgenerators' ``ConvertSegToBoundingBoxCoordinates`` as used by every
reference data loader
(``experiments/*/data_loader.py``): instance-labeled masks ride through the
augmentation pipeline, then boxes/labels are extracted here, so geometric
transforms never have to warp box coordinates.

Contract details preserved:
  * boxes are (min-1, ..., max+1) around the instance voxels — a 1-pixel
    halo, unclipped (coords may be -1 or == extent);
  * roi label = class_target + 1 (0 is background downstream);
  * instances that vanished under augmentation are dropped;
  * empty elements get ``bb_target=[]`` and ``roi_labels=[-1]``;
  * the output 'seg' is binarized fg/bg, or class-labeled when
    ``class_specific_seg_flag`` is set;
  * ``get_rois_from_seg_flag`` re-labels connected components when the seg is
    binary (one class_target per element).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def convert_seg_to_bounding_box_coordinates(
    batch: dict, dim: int, get_rois_from_seg_flag: bool = False, class_specific_seg_flag: bool = False
) -> dict:
    """Mutates/extends a batch dict with bb_target / roi_labels / roi_masks.

    batch['seg']: (b, 1, y, x, (z)) instance-labeled (ints 1..n per object) or
    binary if get_rois_from_seg_flag. batch['class_target']: per-element list
    of per-roi class ids (0-based).
    """
    bb_target, roi_masks, roi_labels = [], [], []
    out_seg = np.copy(batch["seg"])
    class_target = [list(np.atleast_1d(np.asarray(ct))) for ct in batch["class_target"]]

    for b in range(batch["seg"].shape[0]):
        p_coords, p_masks, p_labels = [], [], []
        seg_b = batch["seg"][b]
        if np.sum(seg_b != 0) > 0:
            if get_rois_from_seg_flag:
                clusters, n_cands = ndimage.label(seg_b)
                class_target[b] = list(class_target[b]) * n_cands
            else:
                n_cands = int(np.max(seg_b))
                clusters = seg_b
            for rix in range(n_cands):
                r = clusters == rix + 1
                if np.sum(r) > 0:  # roi survived augmentation
                    ixs = np.argwhere(r)  # (n, 1+dim): channel, y, x, (z)
                    coord_list = [
                        np.min(ixs[:, 1]) - 1,
                        np.min(ixs[:, 2]) - 1,
                        np.max(ixs[:, 1]) + 1,
                        np.max(ixs[:, 2]) + 1,
                    ]
                    if dim == 3:
                        coord_list.extend([np.min(ixs[:, 3]) - 1, np.max(ixs[:, 3]) + 1])
                    p_coords.append(coord_list)
                    p_masks.append(r.astype("uint8"))
                    p_labels.append(int(class_target[b][rix]) + 1)
                if class_specific_seg_flag:
                    out_seg[b][seg_b == rix + 1] = int(class_target[b][rix]) + 1
            if not class_specific_seg_flag:
                out_seg[b][seg_b > 0] = 1
            bb_target.append(np.array(p_coords))
            roi_masks.append(np.array(p_masks))
            roi_labels.append(np.array(p_labels))
        else:
            bb_target.append(np.array([]))
            roi_masks.append(np.zeros_like(seg_b, dtype="uint8")[None])
            roi_labels.append(np.array([-1]))

    batch["bb_target"] = bb_target
    batch["roi_masks"] = roi_masks
    batch["roi_labels"] = roi_labels
    batch["seg"] = out_seg
    return batch
