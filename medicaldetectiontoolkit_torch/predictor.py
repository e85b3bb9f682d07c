"""Inference pipeline of the port: tiling, mirror TTA, temporal ensembling,
consolidation.

Counterpart of ``medicaldetectiontoolkit_tpu/predictor.py``, whole, with the
same names and contracts:

  4-level nested pipeline
    predict_test_set (temporal ensembling over top-k epoch checkpoints)
      -> predict_patient
        -> data_aug_forward (identity + 3 xy-mirror TTA, coords un-mirrored)
          -> spatial_tiling_forward (patch -> whole-image coords; per-box
             patch_id, Gaussian box_patch_center_factor, box_n_overlaps;
             seg averaged over the patch-overlap map)
            -> batch_tiling_forward (chunk n_patches into batch_size chunks)

  plus the consolidation functions: weighted box clustering (WBC) and 2D->3D
  cube merging via hole-bounded slice clustering (``nms_2to3D``),
  raw-prediction pickles, and analysis-mode loading.

Chunks are padded to ``cf.batch_size``, and up to ``MDT_TILE_INFLIGHT``
(default 8) chunks are dispatched before the oldest is converted: the port's
``test_forward_dispatch`` only enqueues CUDA work (a pinned, non-blocking
upload), so the card computes the next chunks while the host walks one
chunk's boxes. Consolidation runs on the host in a thread pool: from 16 boxes
up, WBC and ``nms_2to3D`` go through the port's native host library
(``native.wbc_greedy`` / ``native.nms_2to3d``, the JAX package's cutover);
below that, or under ``MDT_NO_NATIVE=1``, their NumPy loops. ``Predictor.times``
sums host seconds per stage: ``forward`` (dispatch and convert, ending in the
device->host copies), ``patient`` (all of ``predict_patient``; the rest of it
beyond ``forward`` is stitching: mirroring, seg averaging, box offsets) and
``consolidation`` (WBC and 2D->3D merging), kept by the spans
``predictor.forward``, ``predictor.patient`` and ``predictor.consolidation``
(``utils/trace.py``), which add to them whether tracing is on or off.

In a data-parallel run (``parallel/mesh.py``) each rank predicts the whole
patients of its slice on its own card, with no collective (``Detector.
single_card``), so a patient's results are the single-card ones; the test
set's raw and consolidated results are gathered in the data set's order and
rank 0 writes the prediction pickle. Under spatial partitioning
(``cf.n_space_parallel > 1``, test mode; JAX ``predictor.py:57-60``) the
ranks of a space group take the same patients and chunks, each forward runs
on their Y slabs and gives every rank the single-process outputs; tiling,
mirror TTA and stitching run identically on each rank, and the results are
gathered over the data group (``mesh.Grid.data_group``).
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from medicaldetectiontoolkit_torch import native
from medicaldetectiontoolkit_torch.parallel import mesh
from medicaldetectiontoolkit_torch.utils import trace
from medicaldetectiontoolkit_torch.utils.exp_utils import load_checkpoint_state


class Predictor:
    def __init__(self, cf, net, logger, mode):
        self.cf = cf
        self.logger = logger
        self.mode = mode  # 'val' | 'test' | 'analysis'
        self.net = net
        self.rank_ix = "0"
        self.n_ens = 1
        self.patched_patient = False

        if self.mode == "test":
            try:
                self.epoch_ranking = np.load(os.path.join(self.cf.fold_dir, "epoch_ranking.npy"))[: cf.test_n_epochs]
            except FileNotFoundError:
                raise RuntimeError(
                    "no epoch ranking file in fold directory. "
                    "seems like you are trying to run testing without prior training..."
                )
            self.n_ens = cf.test_n_epochs
            if self.cf.test_aug:
                self.n_ens *= 4
            if (getattr(cf, "n_space_parallel", None) or 1) > 1 and net.space is None:
                net.enable_spatial_parallel_inference()
        self.times = {"forward": 0.0, "patient": 0.0, "consolidation": 0.0}

    # ------------------------------------------------------------------ #

    def predict_patient(self, batch):
        """Predict one patient; in val mode also adds 3D GT + consolidates."""
        self.logger.info(f"evaluating patient {batch['pid']} for fold {getattr(self.cf, 'fold', 0)}")
        self.patched_patient = "patch_crop_coords" in list(batch.keys())
        with trace.span("predictor.patient", into=self.times), self.net.single_card():  # whole on this rank's card
            results_dict = self.data_aug_forward(batch)

        if self.mode == "val":
            for b in range(len(batch["patient_bb_target"])):
                for t in range(len(batch["patient_bb_target"][b])):
                    results_dict["boxes"][b].append(
                        {
                            "box_coords": batch["patient_bb_target"][b][t],
                            "box_label": batch["patient_roi_labels"][b][t],
                            "box_type": "gt",
                        }
                    )
            with trace.span("predictor.consolidation", into=self.times):
                if self.patched_patient:
                    wcs_input = [results_dict["boxes"], "dummy_pid", self.cf.class_dict, self.cf.wcs_iou, self.n_ens]
                    results_dict["boxes"] = apply_wbc_to_patient(wcs_input)[0]
                if self.cf.merge_2D_to_3D_preds:
                    merge_dims_inputs = [results_dict["boxes"], "dummy_pid", self.cf.class_dict, self.cf.merge_3D_iou]
                    results_dict["boxes"] = merge_2D_to_3D_preds_per_patient(merge_dims_inputs)[0]

        return results_dict

    def predict_test_set(self, batch_gen, return_results=True):
        """Temporal ensembling over top-k checkpoints + full test set sweep."""
        dict_of_patient_results = OrderedDict()
        weight_paths = [os.path.join(self.cf.fold_dir, f"{epoch}_best_checkpoint") for epoch in self.epoch_ranking]

        for rank_ix, weight_path in enumerate(weight_paths):
            self.logger.info(f"tmp ensembling over rank_ix:{rank_ix} epoch:{weight_path}")
            self.net.load_params(load_checkpoint_state(weight_path)["params"])
            self.rank_ix = str(rank_ix)

            # restart patient iteration per rank: with max_test_patients <
            # dataset size, each rank must see the SAME patient subset (the
            # reference's iterator keeps cycling and crashes in that case)
            if hasattr(batch_gen["test"], "patient_ix"):
                batch_gen["test"].patient_ix = 0

            for _ in range(batch_gen["n_test"]):
                batch = next(batch_gen["test"])
                if rank_ix == 0:
                    dict_of_patient_results[batch["pid"]] = {
                        "results_list": [],
                        "patient_bb_target": batch["patient_bb_target"],
                        "patient_roi_labels": batch["patient_roi_labels"],
                    }
                results_dict = self.predict_patient(batch)
                dict_of_patient_results[batch["pid"]]["results_list"].append(results_dict["boxes"])

        self.logger.info("finished predicting test set. starting post-processing of predictions.")
        list_of_results_per_patient = []
        for pid, p_dict in dict_of_patient_results.items():
            tmp_ens_list = p_dict["results_list"]
            results_dict = {}
            results_dict["boxes"] = [
                [item for d in tmp_ens_list for item in d[batch_instance]]
                for batch_instance in range(len(tmp_ens_list[0]))
            ]
            for b in range(len(p_dict["patient_bb_target"])):
                for t in range(len(p_dict["patient_bb_target"][b])):
                    results_dict["boxes"][b].append(
                        {
                            "box_coords": p_dict["patient_bb_target"][b][t],
                            "box_label": p_dict["patient_roi_labels"][b][t],
                            "box_type": "gt",
                        }
                    )
            list_of_results_per_patient.append([results_dict["boxes"], pid])

        out_string = "raw_pred_boxes_hold_out_list" if self.cf.hold_out_test_set else "raw_pred_boxes_list"
        space = getattr(self.net, "space", None)
        group = None if space is None else space.grid.data_group
        every_patient = mesh.gather_interleaved(list_of_results_per_patient, group)  # the ranks' slices, in order
        if mesh.is_writer():
            with open(os.path.join(self.cf.fold_dir, f"{out_string}.pickle"), "wb") as handle:
                pickle.dump(every_patient, handle)

        if return_results:
            return mesh.gather_interleaved(self._consolidate(list_of_results_per_patient, self.n_ens), group)

    def _consolidate(self, list_of_results_per_patient, n_ens):
        with trace.span("predictor.consolidation", into=self.times):
            self.logger.info(f"applying wcs to test set predictions with iou = {self.cf.wcs_iou} and n_ens = {n_ens}.")
            mp_inputs = [[ii[0], ii[1], self.cf.class_dict, self.cf.wcs_iou, n_ens]
                         for ii in list_of_results_per_patient]
            with ThreadPoolExecutor(max_workers=6) as pool:
                out = list(pool.map(apply_wbc_to_patient, mp_inputs))

            if self.cf.merge_2D_to_3D_preds:
                self.logger.info(f"applying 2Dto3D merging to test set predictions with iou = {self.cf.merge_3D_iou}.")
                mp_inputs = [[ii[0], ii[1], self.cf.class_dict, self.cf.merge_3D_iou] for ii in out]
                with ThreadPoolExecutor(max_workers=6) as pool:
                    out = list(pool.map(merge_2D_to_3D_preds_per_patient, mp_inputs))
        return out

    def load_saved_predictions(self, apply_wbc=False):
        """Analysis mode: load raw prediction pickles, consolidate, return."""
        if not self.cf.hold_out_test_set:
            with open(os.path.join(self.cf.fold_dir, "raw_pred_boxes_list.pickle"), "rb") as handle:
                list_of_results_per_patient = pickle.load(handle)
            da_factor = 4 if self.cf.test_aug else 1
            n_ens = self.cf.test_n_epochs * da_factor
            self.logger.info(
                f"loaded raw test set predictions with n_patients = {len(list_of_results_per_patient)} and n_ens = {n_ens}"
            )
        else:
            boxes_list = []
            pids = []
            for fold in self.cf.folds:
                fold_dir = os.path.join(self.cf.exp_dir, f"fold_{fold}")
                with open(os.path.join(fold_dir, "raw_pred_boxes_hold_out_list.pickle"), "rb") as handle:
                    fold_list = pickle.load(handle)
                    pids = [ii[1] for ii in fold_list]
                    boxes_list.append([ii[0] for ii in fold_list])
            list_of_results_per_patient = [
                [[[box for fold_list in boxes_list for box in fold_list[pix][0] if box["box_type"] == "det"]], pid]
                for pix, pid in enumerate(pids)
            ]
            da_factor = 4 if self.cf.test_aug else 1
            n_ens = self.cf.test_n_epochs * da_factor * len(self.cf.folds)

        if apply_wbc:
            self.logger.info(f"applying wcs to test set predictions with iou = {self.cf.wcs_iou} and n_ens = {n_ens}.")
            mp_inputs = [
                [ii[0], ii[1], self.cf.class_dict, self.cf.wcs_iou, n_ens] for ii in list_of_results_per_patient
            ]
            with ThreadPoolExecutor(max_workers=6) as pool:
                list_of_results_per_patient = list(pool.map(apply_wbc_to_patient, mp_inputs))

        if self.cf.merge_2D_to_3D_preds:
            self.logger.info(f"applying 2Dto3D merging to test set predictions with iou = {self.cf.merge_3D_iou}.")
            mp_inputs = [[ii[0], ii[1], self.cf.class_dict, self.cf.merge_3D_iou] for ii in list_of_results_per_patient]
            with ThreadPoolExecutor(max_workers=6) as pool:
                list_of_results_per_patient = list(pool.map(merge_2D_to_3D_preds_per_patient, mp_inputs))

        return list_of_results_per_patient

    # ------------------------------------------------------------------ #

    # identity + 3 mirror variants; image axes to flip per variant (batch
    # dict layout is (b, c, y, x, (z)), so y=2 / x=3)
    _TTA_VARIANTS = (("1", (2,)), ("2", (3,)), ("3", (2, 3)))

    def data_aug_forward(self, batch):
        """Identity + 3 xy-mirror TTA; coords/segs un-mirrored afterwards."""
        patch_crops = batch["patch_crop_coords"] if self.patched_patient else None
        org_img_shape = batch["original_img_shape"]
        results_list = [self.spatial_tiling_forward(batch, patch_crops)]

        if self.mode == "test" and self.cf.test_aug:
            mirrored_crops = (
                get_mirrored_patch_crops(patch_crops, org_img_shape) if self.patched_patient else [None] * 3
            )
            original_img = batch["data"]
            for (n_aug, flip_axes), crops in zip(self._TTA_VARIANTS, mirrored_crops):
                batch["data"] = np.flip(original_img, axis=flip_axes).copy()
                variant = self.spatial_tiling_forward(batch, crops, n_aug=n_aug)
                self._unmirror_variant(variant, flip_axes, org_img_shape)
                results_list.append(variant)
            batch["data"] = original_img

        # concatenate all variants per batch element
        merged = {
            "boxes": [
                [box for d in results_list for box in d["boxes"][b]] for b in range(org_img_shape[0])
            ],
            "seg_preds": np.array(
                [
                    [ch for d in results_list for ch in d["seg_preds"][b]]
                    for b in range(org_img_shape[0])
                ]
            ),
        }
        if self.mode == "val":
            merged["monitor_values"] = results_list[0]["monitor_values"]
        return merged

    @staticmethod
    def _unmirror_variant(variant, flip_axes, org_img_shape):
        """Map a mirrored variant's boxes + seg back to original orientation.

        A flip along image axis a sends box interval [lo, hi] to
        [extent - hi, extent - lo]; axis 2 is box coords (0, 2), axis 3 is
        (1, 3); z (3D) is never flipped.
        """
        for element_boxes in variant["boxes"]:
            for box in element_boxes:
                c = np.array(box["box_coords"], dtype=float)
                for ax, (lo_ix, hi_ix) in ((2, (0, 2)), (3, (1, 3))):
                    if ax in flip_axes:
                        extent = org_img_shape[ax]
                        c[lo_ix], c[hi_ix] = extent - c[hi_ix], extent - c[lo_ix]
                assert c[2] >= c[0] and c[3] >= c[1], (c, box["box_coords"])
                box["box_coords"] = c
        variant["seg_preds"] = np.flip(variant["seg_preds"], axis=flip_axes).copy()

    def _center_trust_factor(self, box_coords):
        """Gaussian weighting of a patch-local box by its distance from the
        patch center: exp(-0.5 * ((center - patch_mid) / (0.8 * patch_mid))^2)
        averaged over spatial dims — border boxes are less trustworthy."""
        c = np.asarray(box_coords, dtype=float)
        centers = [(c[0] + c[2]) / 2, (c[1] + c[3]) / 2] + ([(c[4] + c[5]) / 2] if self.cf.dim == 3 else [])
        mids = np.asarray(self.cf.patch_size, dtype=float) / 2
        return float(np.mean(np.exp(-0.5 * ((np.asarray(centers) - mids) / (0.8 * mids)) ** 2)))

    @staticmethod
    def _outer_int_box(coords):
        """Integerize float box coords for overlap-map lookup: floor at even
        positions, ceil at odd ones (the reference's rounding convention,
        ``predictor.py:431-433`` — kept for behavioral parity)."""
        c = np.asarray(coords, dtype=float)
        out = np.empty(len(c), dtype=int)
        out[0::2] = np.floor(c[0::2])
        out[1::2] = np.ceil(c[1::2])
        return out

    def spatial_tiling_forward(self, batch, patch_crops=None, n_aug="0"):
        """Patch -> whole-image coords; overlap-averaged seg; WBC metadata.

        Contract (reference ``predictor.py:370-455``): patch boxes get a
        patch_id "{rank}_{aug}_{patch}", a Gaussian center-trust factor, and
        box_n_overlaps = mean patch-overlap count inside the box; seg maps
        are averaged where patches overlap. In 2D-on-3D mode (crop[4:] is a
        z-slice) boxes land in their slice's results list.
        """
        if patch_crops is None:
            results_dict = self.batch_tiling_forward(batch)
            for element_boxes in results_dict["boxes"]:
                for box in element_boxes:
                    box["box_patch_center_factor"] = 1
                    box["box_n_overlaps"] = 1
                    box["patch_id"] = f"{self.rank_ix}_{n_aug}"
            return results_dict

        patches_dict = self.batch_tiling_forward(batch)
        out_shape = list(batch["original_img_shape"])
        out_shape[1] = 1  # seg channel
        seg_sum = np.zeros(out_shape, dtype=np.float16)
        overlap_map = np.zeros(out_shape, dtype="uint8")

        is_3d = self.cf.dim == 3
        for pix, pc in enumerate(patch_crops):
            region = (
                (slice(None), slice(None), slice(pc[0], pc[1]), slice(pc[2], pc[3]), slice(pc[4], pc[5]))
                if is_3d
                else (slice(pc[4], pc[5]), slice(None), slice(pc[0], pc[1]), slice(pc[2], pc[3]))
            )
            seg_sum[region] += patches_dict["seg_preds"][pix][None] if is_3d else patches_dict["seg_preds"][pix]
            overlap_map[region] += 1
        covered = overlap_map > 0
        seg_sum[covered] /= overlap_map[covered]

        results_dict = {"boxes": [[] for _ in range(batch["original_img_shape"][0])], "seg_preds": seg_sum}
        for pix, pc in enumerate(patch_crops):
            # global-coord offset of this patch; z offset applies to both z
            # coords in 3D, and selects the target slice in 2D-on-3D mode
            offset = np.array([pc[0], pc[2], pc[0], pc[2]] + ([pc[4], pc[4]] if is_3d else []))
            for box in patches_dict["boxes"][pix]:
                box["patch_id"] = f"{self.rank_ix}_{n_aug}_{pix}"
                box["box_patch_center_factor"] = self._center_trust_factor(box["box_coords"])
                c = np.asarray(box["box_coords"], dtype=float) + offset
                ic = self._outer_int_box(c)
                if is_3d:
                    box["box_n_overlaps"] = np.mean(overlap_map[:, :, ic[1] : ic[3], ic[0] : ic[2], ic[4] : ic[5]])
                    target_element = 0
                else:
                    box["box_n_overlaps"] = np.mean(overlap_map[pc[4], :, ic[1] : ic[3], ic[0] : ic[2]])
                    target_element = pc[4]
                box["box_coords"] = c
                results_dict["boxes"][target_element].append(box)

        if self.mode == "val":
            results_dict["monitor_values"] = patches_dict["monitor_values"]
        return results_dict

    def batch_tiling_forward(self, batch):
        """Chunk oversized patch batches into batch_size chunks (padded so the
        device function compiles once per patient shape)."""
        self.logger.info(f"forwarding (patched) patient with shape: {batch['data'].shape}")
        with trace.span("predictor.forward", into=self.times):
            return self._batch_tiling_forward(batch)

    def _batch_tiling_forward(self, batch):
        img = batch["data"]

        if img.shape[0] <= self.cf.batch_size:
            if self.mode == "val":
                results_dict = self.net.train_forward(batch, is_validation=True)
                results_dict["boxes"] = [[box for box in b if box["box_type"] == "det"] for b in results_dict["boxes"]]
            else:
                results_dict = self.net.test_forward(batch, return_masks=self.cf.return_masks_in_test)
            return results_dict

        n = img.shape[0]
        bs = self.cf.batch_size
        chunk_dicts = []
        array_keys = [
            k for k in batch.keys() if isinstance(batch[k], np.ndarray) and batch[k].shape[0] == n
        ]
        list_keys = [
            k for k in ("bb_target", "roi_labels", "roi_masks", "class_target")
            if k in batch and not isinstance(batch[k], np.ndarray) and len(batch[k]) == n
        ]
        # two-phase pipeline: enqueue each chunk's device work (dispatch
        # returns before the card finishes), convert the oldest once the
        # window is full, so the card computes chunks i+1..k while the host
        # walks chunk i's boxes. The window bounds the device memory held by
        # queued chunk outputs.
        window = int(os.environ.get("MDT_TILE_INFLIGHT", 8))
        pending = []

        def _convert(entry):
            handles, b, pad, n_real = entry
            if self.mode == "val":
                d = self.net.train_forward_convert(handles, b)
            else:
                d = self.net.test_forward_convert(handles, b)
            if pad:
                d["boxes"] = d["boxes"][:n_real]
                d["seg_preds"] = d["seg_preds"][:n_real]
            chunk_dicts.append(d)

        for start in range(0, n, bs):
            ixs = np.arange(start, min(start + bs, n))
            pad = bs - len(ixs)
            b = {k: batch[k][ixs] for k in array_keys}
            for k in list_keys:
                b[k] = [batch[k][i] for i in ixs]
            if pad:  # pad chunk to batch_size with repeats; trimmed below
                b = {k: np.concatenate([v, v[-1:].repeat(pad, axis=0)]) for k, v in b.items() if isinstance(v, np.ndarray)}
                for k in list_keys:
                    b[k] = [batch[k][i] for i in ixs] + [batch[k][ixs[-1]]] * pad
            if self.mode == "val":
                handles = self.net.train_forward_dispatch(b, is_validation=True)
            else:
                handles = self.net.test_forward_dispatch(b, return_masks=self.cf.return_masks_in_test)
            pending.append((handles, b, pad, len(ixs)))
            if len(pending) >= window:
                _convert(pending.pop(0))
        for entry in pending:
            _convert(entry)

        results_dict = {}
        results_dict["boxes"] = [item for d in chunk_dicts for item in d["boxes"]]
        results_dict["seg_preds"] = np.array([item for d in chunk_dicts for item in d["seg_preds"]])
        if self.mode == "val":
            results_dict["monitor_values"] = {
                k: np.mean([d["monitor_values"][k] for d in chunk_dicts]) for k in chunk_dicts[0]["monitor_values"].keys()
            }
            results_dict["boxes"] = [[box for box in b if box["box_type"] == "det"] for b in results_dict["boxes"]]
        return results_dict


# ---------------------------------------------------------------------- #
#  consolidation functions (host NumPy)                                    #
# ---------------------------------------------------------------------- #


def apply_wbc_to_patient(inputs):
    """Weighted box clustering per (batch element, class) for one patient."""
    in_patient_results_list, pid, class_dict, wcs_iou, n_ens = inputs
    out_patient_results_list = [[] for _ in range(len(in_patient_results_list))]

    for bix, b in enumerate(in_patient_results_list):
        for cl in list(class_dict.keys()):
            boxes = [
                (ix, box) for ix, box in enumerate(b) if (box["box_type"] == "det" and box["box_pred_class_id"] == cl)
            ]
            box_coords = np.array([bb[1]["box_coords"] for bb in boxes])
            box_scores = np.array([bb[1]["box_score"] for bb in boxes])
            box_center_factor = np.array([bb[1]["box_patch_center_factor"] for bb in boxes])
            box_n_overlaps = np.array([bb[1]["box_n_overlaps"] for bb in boxes])
            box_patch_id = np.array([bb[1]["patch_id"] for bb in boxes])

            if 0 not in box_scores.shape:
                keep_scores, keep_coords = weighted_box_clustering(
                    np.concatenate(
                        (box_coords, box_scores[:, None], box_center_factor[:, None], box_n_overlaps[:, None]), axis=1
                    ),
                    box_patch_id,
                    wcs_iou,
                    n_ens,
                )
                for boxix in range(len(keep_scores)):
                    out_patient_results_list[bix].append(
                        {
                            "box_type": "det",
                            "box_coords": keep_coords[boxix],
                            "box_score": keep_scores[boxix],
                            "box_pred_class_id": cl,
                        }
                    )
        out_patient_results_list[bix].extend([box for box in b if box["box_type"] == "gt"])

    return [out_patient_results_list, pid]


def merge_2D_to_3D_preds_per_patient(inputs):
    """Cluster per-slice 2D detections into 3D cubes (one patient)."""
    in_patient_results_list, pid, class_dict, merge_3D_iou = inputs
    out_patient_results_list = []

    for cl in list(class_dict.keys()):
        boxes, slice_ids = [], []
        for bix, b in enumerate(in_patient_results_list):
            det_boxes = [
                (ix, box) for ix, box in enumerate(b) if (box["box_type"] == "det" and box["box_pred_class_id"] == cl)
            ]
            boxes += det_boxes
            slice_ids += [bix] * len(det_boxes)

        box_coords = np.array([bb[1]["box_coords"] for bb in boxes])
        box_scores = np.array([bb[1]["box_score"] for bb in boxes])
        slice_ids = np.array(slice_ids)

        if 0 not in box_scores.shape:
            keep_ix, keep_z = nms_2to3D(
                np.concatenate((box_coords, box_scores[:, None], slice_ids[:, None]), axis=1), merge_3D_iou
            )
        else:
            keep_ix, keep_z = [], []

        for kix, kz in zip(keep_ix, keep_z):
            out_patient_results_list.append(
                {
                    "box_type": "det",
                    "box_coords": list(box_coords[kix]) + kz,
                    "box_score": box_scores[kix],
                    "box_pred_class_id": cl,
                }
            )

    out_patient_results_list += [box for b in in_patient_results_list for box in b if box["box_type"] == "gt"]
    return [[out_patient_results_list], pid]


def _legacy_iou_row(coords, areas, seed, dim):
    """IoU of box ``seed`` vs all boxes, legacy +1-pixel extent convention.

    coords: (n, 2*dim) as (y1, x1, y2, x2, (z1, z2)); areas precomputed with
    +1 extents. The +1 convention is the reference consolidation contract
    (``predictor.py:617-648``). One O(n) row per cluster seed — test-time
    consolidation sees thousands of boxes per (patient, class), where a full
    (n, n) matrix plus broadcast temporaries costs O(n^2) host memory.
    """
    los = [coords[:, 0], coords[:, 1]] + ([coords[:, 4]] if dim == 3 else [])
    his = [coords[:, 2], coords[:, 3]] + ([coords[:, 5]] if dim == 3 else [])
    inter = np.ones(coords.shape[0])
    for lo, hi in zip(los, his):
        inter = inter * np.maximum(0.0, np.minimum(hi[seed], hi) - np.maximum(lo[seed], lo) + 1)
    return inter / (areas[seed] + areas - inter)


def weighted_box_clustering(dets, box_patch_id, thresh, n_ens):
    """WBC: greedy score-ordered clustering, one O(n) IoU row per seed.

    Contract (reference ``predictor.py:597-706``): clusters form at
    IoU > thresh around the highest-scoring unconsumed box; the cluster score
    is the weighted average of member scores (weights = overlap with seed *
    box area * patch-center factor) divided by the EXPECTED number of
    predictions at that position (n_ens * mean member overlap count), where
    missing predictions contribute the mean member weight — so detections
    missing from some ensemble members / overlapping patches get downweighted.
    Coords are the (weighted-score)-weighted average. Clusters with
    avg score <= 0.01 are dropped.
    """
    dim = 2 if dets.shape[1] == 7 else 3
    coords = dets[:, : 2 * dim]
    scores = dets[:, -3]
    center_factors = dets[:, -2]
    overlap_counts = dets[:, -1]

    order = scores.argsort()[::-1]
    if len(scores) >= 16:  # the greedy loop is the cost at scale -> native
        codes = np.unique(np.asarray(box_patch_id), return_inverse=True)[1]
        out = native.wbc_greedy(np.asarray(dets, np.float64), codes, order, thresh, n_ens)
        if out is not None:  # None: MDT_NO_NATIVE=1 -> NumPy loop below
            return list(out[0]), [list(c) for c in out[1]]

    extents = [coords[:, 2] - coords[:, 0] + 1, coords[:, 3] - coords[:, 1] + 1]
    if dim == 3:
        extents.append(coords[:, 5] - coords[:, 4] + 1)
    areas = np.prod(extents, axis=0)

    keep_scores, keep_coords = [], []
    consumed = np.zeros(len(scores), bool)
    for seed in order:
        if consumed[seed]:
            continue
        iou_row = _legacy_iou_row(coords, areas, seed, dim)
        members = ~consumed & (iou_row > thresh)
        consumed |= members

        weights = iou_row[members] * areas[members] * center_factors[members]
        weighted_scores = scores[members] * weights
        n_expected = n_ens * overlap_counts[members].mean()
        n_missing = max(0.0, n_expected - len(np.unique(box_patch_id[members])))
        avg_score = weighted_scores.sum() / (weights.sum() + n_missing * weights.mean())
        if avg_score > 0.01:
            keep_scores.append(avg_score)
            keep_coords.append(list((coords[members] * weighted_scores[:, None]).sum(0) / weighted_scores.sum()))

    return keep_scores, keep_coords


def _contiguous_slice_run(occupied_slices, core_slice):
    """(lo, hi) of the maximal run of consecutive occupied slices containing
    core_slice. occupied_slices: 1D float array (unsorted, may repeat)."""
    occ = np.unique(occupied_slices)
    pos = int(np.searchsorted(occ, core_slice))
    gaps = np.where(np.diff(occ) > 1)[0]  # run boundary after these positions
    run_starts = np.concatenate([[0], gaps + 1])
    run_ends = np.concatenate([gaps, [len(occ) - 1]])
    k = int(np.searchsorted(run_starts, pos, side="right")) - 1
    assert run_starts[k] <= pos <= run_ends[k]
    return occ[run_starts[k]], occ[run_ends[k]]


def nms_2to3D(dets, thresh):
    """Cluster 2D slice detections into 3D cubes.

    Contract (reference ``predictor.py:710-773``): greedy by score; a cube's
    members are the detections overlapping the seed (IoU > thresh, legacy +1
    convention) whose slices form a contiguous run with the seed's slice —
    the cube is cut at the first empty slice in either direction. The cube's
    z extent is [min member slice - 1, max member slice + 1]; members in the
    run are consumed, overlapping detections beyond the gap stay available.
    """
    coords = dets[:, :4]
    scores = dets[:, -2]
    slice_id = dets[:, -1]
    areas = (coords[:, 2] - coords[:, 0] + 1) * (coords[:, 3] - coords[:, 1] + 1)

    order = scores.argsort()[::-1]
    if len(scores) >= 16:  # native greedy loop (same cutover as WBC)
        out = native.nms_2to3d(np.asarray(dets, np.float64), order, thresh)
        if out is not None:
            return list(out[0]), [list(z) for z in out[1]]

    keep, keep_z = [], []
    consumed = np.zeros(len(scores), bool)
    for seed in order:
        if consumed[seed]:
            continue
        overlapping = ~consumed & (_legacy_iou_row(coords, areas, seed, dim=2) > thresh)
        lo, hi = _contiguous_slice_run(slice_id[overlapping], slice_id[seed])
        members = overlapping & (slice_id >= lo) & (slice_id <= hi)
        consumed |= members
        keep.append(seed)
        keep_z.append([slice_id[members].min() - 1, slice_id[members].max() + 1])

    return keep, keep_z


def get_mirrored_patch_crops(patch_crops, org_img_shape):
    """Patch-crop coords under the 3 mirror TTA transforms (y, x, y+x).

    A flip along image axis a maps an interval [lo, hi) to
    [extent - hi, extent - lo); z is never flipped.
    """
    y_ext, x_ext = org_img_shape[2], org_img_shape[3]

    def reflect(crop, flip_y, flip_x):
        y = [y_ext - crop[1], y_ext - crop[0]] if flip_y else [crop[0], crop[1]]
        x = [x_ext - crop[3], x_ext - crop[2]] if flip_x else [crop[2], crop[3]]
        return y + x + list(crop[4:])

    return [
        [reflect(crop, flip_y, flip_x) for crop in patch_crops]
        for flip_y, flip_x in ((True, False), (False, True), (True, True))
    ]
