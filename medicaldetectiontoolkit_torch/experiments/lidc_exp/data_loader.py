"""LIDC data loader of the port: the test half.

Counterpart of ``experiments/lidc_exp/data_loader.py``, test-time entry
points only, with no pandas and no jax:
  * ``load_dataset`` reads the per-patient ``meta_info_{pid}.pickle`` dicts
    that the real preprocessing and the synthetic generator both write (not
    the pandas ``info_df.pickle`` aggregated from them). Patients come in the
    order ``os.listdir`` gives the ``meta_info`` files, which is the row order
    of ``info_df.pickle`` (``preprocessing.py::aggregate_meta_info`` lists
    the same directory); a fold's test subset is indexed into the sorted
    unique pids, as in JAX. Malignancy is binarized (>= 3 -> class 1);
  * ``get_test_generator`` reads the fold split from ``fold_ids.pickle`` (or
    takes every patient of ``cf.pp_test_data_path`` with
    ``cf.hold_out_test_set``);
  * ``PatientBatchIterator``: one whole patient per step, padded to patch
    size, with the 3D GT even for 2D models (merged 2D->3D evaluation), the
    overlapping patch grid stacked along the batch axis, z slices (with
    ``n_3D_context`` neighbours in channels) in 2D. This process iterates
    every patient: rank 0 of 1 until the port scales out.

Stored arrays are (z, y, x) and are transposed to (y, x, z) on load.
"""

from __future__ import annotations

import os
import pickle
import shutil
from collections import OrderedDict

import numpy as np

from medicaldetectiontoolkit_torch.data import dataloader_utils as dutils
from medicaldetectiontoolkit_torch.data.seg_to_boxes import convert_seg_to_bounding_box_coordinates


def get_test_generator(cf, logger):
    test_ix = None
    if not cf.hold_out_test_set:
        # the CV split a training run of this experiment wrote: per fold
        # [train_ix, val_ix, test_ix, fold], indices into the sorted pids
        with open(os.path.join(cf.exp_dir, "fold_ids.pickle"), "rb") as handle:
            test_ix = pickle.load(handle)[cf.fold][2]
    test_data = load_dataset(cf, logger, test_ix, pp_data_path=cf.pp_test_data_path)
    logger.info(f"data set loaded with: {len(test_data)} test patients")
    it = PatientBatchIterator(test_data, cf=cf)
    n = len(it.dataset_pids)
    return {"test": it, "n_test": n if cf.max_test_patients == "all" else min(cf.max_test_patients, n)}


def _meta_files(path):
    return [f for f in os.listdir(path) if "meta_info" in f]


def _stage_to_data_dest(cf, pp_data_path, logger):
    """Cluster staging: copy the patients' files to ``cf.data_dest`` once."""
    target_dir = os.path.join(cf.data_dest, cf.pp_name)
    if not os.path.isdir(target_dir) or not os.listdir(target_dir):
        os.makedirs(target_dir, exist_ok=True)
        for f in _meta_files(pp_data_path):
            with open(os.path.join(pp_data_path, f), "rb") as handle:
                pid = pickle.load(handle)["pid"]
            for name in (f, f"{pid}_img.npy", f"{pid}_rois.npy"):
                shutil.copy(os.path.join(pp_data_path, name), target_dir)
        logger.info(f"copied the data set to {target_dir}")
    return target_dir


def load_dataset(cf, logger, subset_ixs=None, pp_data_path=None):
    if pp_data_path is None:
        pp_data_path = cf.pp_data_path
    if getattr(cf, "server_env", False) and getattr(cf, "data_dest", None):
        pp_data_path = _stage_to_data_dest(cf, pp_data_path, logger)
    metas = []
    for f in _meta_files(pp_data_path):
        with open(os.path.join(pp_data_path, f), "rb") as handle:
            metas.append(pickle.load(handle))

    if cf.select_prototype_subset is not None:
        metas = metas[: cf.select_prototype_subset]
        logger.warning("WARNING: using prototyping data subset!!!")

    if subset_ixs is not None:
        unique_pids = np.unique([m["pid"] for m in metas])
        subset_pids = {unique_pids[ix] for ix in subset_ixs}
        metas = [m for m in metas if m["pid"] in subset_pids]
        logger.info(f"subset: selected {len(metas)} instances from df")

    data = OrderedDict()
    for m in metas:
        pid = m["pid"]
        data[pid] = {
            "data": os.path.join(pp_data_path, f"{pid}_img.npy"),
            "seg": os.path.join(pp_data_path, f"{pid}_rois.npy"),
            "pid": pid,
            # malignancy binarization: rater scores >= 3 are 'malignant' (class 1)
            "class_target": [1 if ii >= 3 else 0 for ii in m["class_target"]],
            "fg_slices": m["fg_slices"],
        }
    return data


class PatientBatchIterator:
    """Whole-patient iteration with patch-grid decomposition (test/val).

    Batch contract: yields one patient per step as channel-first arrays
    padded to patch size, with patient_bb_target / patient_roi_labels /
    original_img_shape describing the WHOLE patient (3D GT even for 2D
    models when merge_2D_to_3D_preds); oversized patients additionally carry
    patch_crop_coords and stack their overlapping patches (z-slices in 2D
    mode) along the batch axis.
    """

    def __init__(self, data, cf):
        self._data = data
        self.cf = cf
        self.patient_ix = 0
        self.dataset_pids = [v["pid"] for v in data.values()]
        # patch grid is always computed in 3D; 2D mode tiles z slice-wise
        self.patch_size = list(cf.patch_size) + ([1] if len(cf.patch_size) == 2 else [])

    def __iter__(self):
        return self

    def _load_padded(self, patient):
        """(c, y, x, z) float data + (y, x, z) uint8 seg, padded to patch size."""
        data = np.transpose(np.load(patient["data"], mmap_mode="r"), axes=(1, 2, 0))[np.newaxis].astype(np.float32)
        seg = np.transpose(np.load(patient["seg"], mmap_mode="r"), axes=(1, 2, 0)).astype("uint8")
        if any(data.shape[d + 1] < ps for d, ps in enumerate(self.patch_size)):
            grown = [max(data.shape[d + 1], self.patch_size[d]) for d in range(3)]
            data = dutils.pad_nd_image(data, [data.shape[0]] + grown)
            seg = dutils.pad_nd_image(seg, grown)
        return data, seg

    def _whole_patient_3d(self, data, seg, targets, pid):
        batch = {
            "data": data[np.newaxis],
            "seg": seg[np.newaxis, np.newaxis],
            "class_target": targets,
            "pid": pid,
        }
        batch = convert_seg_to_bounding_box_coordinates(
            batch, dim=3, class_specific_seg_flag=self.cf.class_specific_seg_flag
        )
        batch["patient_bb_target"] = batch["bb_target"]
        batch["patient_roi_labels"] = batch["roi_labels"]
        batch["original_img_shape"] = batch["data"].shape
        return batch

    def _slices_with_context(self, slice_major):
        """(z, c, y, x) -> each slice concatenated with its n_3D_context
        neighbors along channels (zero-padded at the ends)."""
        ctx = self.cf.n_3D_context
        padded = np.pad(slice_major, ((ctx, ctx), (0, 0), (0, 0), (0, 0)), "constant")
        n_z, c = slice_major.shape[:2]
        return np.array(
            [padded[z : z + 2 * ctx + 1].reshape((2 * ctx + 1) * c, *slice_major.shape[2:]) for z in range(n_z)]
        )

    def _whole_patient_2d(self, data, seg, targets, pid, gt_source_3d):
        out_data = np.transpose(data, axes=(3, 0, 1, 2))  # (z, c, y, x)
        out_seg = np.transpose(seg, axes=(2, 0, 1))[:, np.newaxis]
        if self.cf.n_3D_context is not None:
            out_data = self._slices_with_context(out_data)
        batch = {
            "data": out_data,
            "seg": out_seg,
            "class_target": np.repeat(targets, out_data.shape[0], axis=0),
            "pid": pid,
        }
        batch = convert_seg_to_bounding_box_coordinates(
            batch, dim=2, class_specific_seg_flag=self.cf.class_specific_seg_flag
        )
        if gt_source_3d is not None:  # merged 2D->3D eval scores against 3D GT
            batch["patient_bb_target"] = gt_source_3d["patient_bb_target"]
            batch["patient_roi_labels"] = gt_source_3d["patient_roi_labels"]
        else:
            batch["patient_bb_target"] = batch["bb_target"]
            batch["patient_roi_labels"] = batch["roi_labels"]
        batch["original_img_shape"] = out_data.shape
        return batch

    def _patch_batch(self, data, seg, targets, pid, patient_batch):
        cf = self.cf
        crops = dutils.get_patch_crop_coords(data[0], self.patch_size)
        ctx = cf.n_3D_context if (cf.dim == 2 and cf.n_3D_context is not None) else None
        img_source = (
            np.pad(data, ((0, 0), (0, 0), (0, 0), (ctx, ctx)), "constant") if ctx is not None else data
        )
        z_grow = 2 * ctx if ctx is not None else 0  # crop z coords live in padded space
        img_patches = np.array([img_source[:, c[0] : c[1], c[2] : c[3], c[4] : c[5] + z_grow] for c in crops])
        seg_patches = np.array([seg[c[0] : c[1], c[2] : c[3], c[4] : c[5]] for c in crops])[:, np.newaxis]

        if cf.dim == 2:
            seg_patches = seg_patches[..., 0]
            if ctx is not None:
                img_patches = np.transpose(img_patches[:, 0], axes=(0, 3, 1, 2))  # z window -> channels
            else:
                img_patches = img_patches[..., 0]

        batch = {
            "data": img_patches.astype(np.float32),
            "seg": seg_patches.astype("uint8"),
            "class_target": np.repeat(targets, len(crops), axis=0),
            "pid": pid,
            "patch_crop_coords": np.array(crops),
            "patient_bb_target": patient_batch["patient_bb_target"],
            "patient_roi_labels": patient_batch["patient_roi_labels"],
            "original_img_shape": patient_batch["original_img_shape"],
        }
        return convert_seg_to_bounding_box_coordinates(
            batch, cf.dim, class_specific_seg_flag=cf.class_specific_seg_flag
        )

    def __next__(self):
        cf = self.cf
        if not self.dataset_pids:
            raise StopIteration
        pid = self.dataset_pids[self.patient_ix]
        patient = self._data[pid]
        data, seg = self._load_padded(patient)
        targets = np.array([patient["class_target"]])

        batch_3d = (
            self._whole_patient_3d(data, seg, targets, pid)
            if (cf.dim == 3 or cf.merge_2D_to_3D_preds)
            else None
        )
        if cf.dim == 3:
            out_batch = batch_3d
        else:
            out_batch = self._whole_patient_2d(
                data, seg, targets, pid, batch_3d if cf.merge_2D_to_3D_preds else None
            )

        if any(data.shape[d + 1] > self.patch_size[d] for d in range(3)):
            out_batch = self._patch_batch(data, seg, targets, pid, out_batch)

        self.patient_ix = (self.patient_ix + 1) % len(self.dataset_pids)
        return out_batch

    next = __next__
