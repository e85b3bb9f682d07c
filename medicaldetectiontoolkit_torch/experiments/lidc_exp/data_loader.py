"""LIDC data loader of the port: training generators and the test iterator.

Counterpart of ``experiments/lidc_exp/data_loader.py``, with no pandas and
no jax:
  * ``load_dataset`` reads the per-patient ``meta_info_{pid}.pickle`` dicts
    that the real preprocessing and the synthetic generator both write (not
    the pandas ``info_df.pickle`` aggregated from them). Patients come in the
    order ``os.listdir`` gives the ``meta_info`` files, which is the row order
    of ``info_df.pickle`` (``preprocessing.py::aggregate_meta_info`` lists
    the same directory); a fold's test subset is indexed into the sorted
    unique pids, as in JAX. Malignancy is binarized (>= 3 -> class 1). With
    ``cf.server_env`` and ``cf.data_dest`` the patients are first staged
    there (``.npz`` archives unpacked);
  * ``get_train_generators``: the fold's train and val patients (the CV split
    written once per experiment to ``fold_ids.pickle``), a train pipeline
    (``BatchGenerator`` -> mirror -> spatial augmentation -> boxes) and a
    ``val_sampling`` pipeline (center crop -> boxes), each a
    ``MultiThreadedGenerator`` of ``cf.n_workers`` threads seeded
    ``rank * n_workers + w`` and yielding this rank's ``cf.batch_size / W``
    rows of the global batch (``parallel/mesh.py::host_shard_info``; rank 0
    of 1 on one card), and a ``val_patient`` iterator in that mode;
  * ``BatchGenerator``: class-balanced patients, fg-biased slices in 2D (with
    ``n_3D_context`` neighbours in channels), fg-anchored pre-crops; the same
    ``RandomState`` gives the JAX package's batches, array for array;
  * ``get_test_generator`` reads the fold split from ``fold_ids.pickle`` (or
    takes every patient of ``cf.pp_test_data_path`` with
    ``cf.hold_out_test_set``);
  * ``PatientBatchIterator``: one whole patient per step, padded to patch
    size, with the 3D GT even for 2D models (merged 2D->3D evaluation), the
    overlapping patch grid stacked along the batch axis, z slices (with
    ``n_3D_context`` neighbours in channels) in 2D. Each rank iterates its
    slice ``pids[rank::world]``; ``n_test`` (and ``n_val`` of
    ``val_patient``) count that slice, capped by ``max_test_patients``.

Stored arrays are (z, y, x) and are transposed to (y, x, z) on load.
"""

from __future__ import annotations

import os
import pickle
import shutil
from collections import OrderedDict

import numpy as np

from medicaldetectiontoolkit_torch.data import dataloader_utils as dutils
from medicaldetectiontoolkit_torch.data.augmentation import center_crop_batch, mirror_batch, spatial_augment_batch
from medicaldetectiontoolkit_torch.data.loader import BatchGeneratorBase, MultiThreadedGenerator
from medicaldetectiontoolkit_torch.data.seg_to_boxes import convert_seg_to_bounding_box_coordinates
from medicaldetectiontoolkit_torch.parallel import mesh


def _fold_splits(cf, n_pids):
    """Per-experiment CV fold assignments, created once and reused.

    ``fold_ids.pickle`` in the exp dir is the cross-run source of truth: the
    first fold of a fresh experiment writes it, and every later fold and run
    of the same experiment reads the same split. In a data-parallel run
    rank 0 writes it; every rank draws the same split.
    """
    path = os.path.join(cf.exp_dir, "fold_ids.pickle")
    if cf.created_fold_id_pickle:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    splits = dutils.fold_generator(seed=cf.seed, n_splits=cf.n_cv_splits, len_data=n_pids).get_fold_names()
    if mesh.is_writer():
        with open(path, "wb") as fh:
            pickle.dump(splits, fh)
    cf.created_fold_id_pickle = True
    return splits


def get_train_generators(cf, logger):
    """Train/val batch-generator pipelines for one CV fold.

    One split validates, one is held out for testing, the rest train; with
    ``cf.hold_out_test_set`` the test split folds back into training and
    testing happens on the separate hold-out directory instead.
    """
    all_data = load_dataset(cf, logger)
    pids = np.unique([v["pid"] for v in all_data.values()])
    train_ix, val_ix, test_ix, _ = _fold_splits(cf, len(pids))[cf.fold]

    keep = {"train": {pids[i] for i in train_ix}, "val": {pids[i] for i in val_ix}}
    if cf.hold_out_test_set:
        keep["train"].update(pids[i] for i in test_ix)
    subset = {
        name: {k: v for k, v in all_data.items() if v["pid"] in wanted}
        for name, wanted in keep.items()
    }
    logger.info(f"data set loaded with: {len(train_ix)} train / {len(val_ix)} val / {len(test_ix)} test patients")

    gens = {
        "train": create_data_gen_pipeline(subset["train"], cf=cf, is_training=True),
        "val_sampling": create_data_gen_pipeline(subset["val"], cf=cf, is_training=False),
    }
    if cf.val_mode == "val_patient":
        gens["val_patient"] = PatientBatchIterator(subset["val"], cf=cf)
        n = len(gens["val_patient"].dataset_pids)
        gens["n_val"] = n if cf.max_val_patients is None else min(n, cf.max_val_patients)
    else:
        gens["n_val"] = cf.num_val_batches
    return gens


def create_data_gen_pipeline(patient_data, cf, is_training=True, generator_cls=None):
    """``generator_cls`` (default ``BatchGenerator``; an experiment's own
    subclass) + transforms in ``cf.n_workers`` threads: mirror and spatial
    augmentation to ``patch_size`` in training, a center crop otherwise, then
    seg -> boxes."""
    data_gen = (generator_cls or BatchGenerator)(patient_data, batch_size=mesh.local_batch_size(cf), cf=cf)
    transforms = []
    if is_training:
        def mirror_t(batch, rng):
            batch["data"], batch["seg"] = mirror_batch(batch["data"], batch["seg"], rng)
            return batch

        def spatial_t(batch, rng):
            batch["data"], batch["seg"] = spatial_augment_batch(
                batch["data"], batch["seg"], cf.patch_size[: cf.dim], cf.da_kwargs, rng
            )
            return batch

        transforms += [mirror_t, spatial_t]
    else:
        def crop_t(batch, rng):
            batch["data"], batch["seg"] = center_crop_batch(batch["data"], batch["seg"], cf.patch_size[: cf.dim])
            return batch

        transforms.append(crop_t)

    def convert_t(batch, rng):
        return convert_seg_to_bounding_box_coordinates(
            batch, cf.dim, get_rois_from_seg_flag=False, class_specific_seg_flag=cf.class_specific_seg_flag
        )

    transforms.append(convert_t)
    rank, _ = mesh.host_shard_info(cf)  # distinct sampling per rank
    seeds = [rank * cf.n_workers + w for w in range(cf.n_workers)]
    return MultiThreadedGenerator(data_gen, transforms, n_workers=cf.n_workers, seeds=seeds)


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
    """Cluster staging: copy the patients' files (``.npy``, or ``.npz``
    archives, then unpacked) to ``cf.data_dest`` once."""
    target_dir = os.path.join(cf.data_dest, cf.pp_name)
    if not os.path.isdir(target_dir) or not os.listdir(target_dir):
        os.makedirs(target_dir, exist_ok=True)
        for f in _meta_files(pp_data_path):
            with open(os.path.join(pp_data_path, f), "rb") as handle:
                pid = pickle.load(handle)["pid"]
            shutil.copy(os.path.join(pp_data_path, f), target_dir)
            for name in (f"{pid}_img", f"{pid}_rois"):
                for ext in (".npz", ".npy"):
                    if os.path.isfile(os.path.join(pp_data_path, name + ext)):
                        shutil.copy(os.path.join(pp_data_path, name + ext), target_dir)
        dutils.unpack_dataset(target_dir)
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


class BatchGenerator(BatchGeneratorBase):
    """Samples patients (class-balanced), fg-biased slices/crops to
    pre_crop_size; augmentation produces the final patch_size.

    Sampling contract (``experiments/lidc_exp/data_loader.py:223-334``, the
    reference's ``data_loader.py:119-244``): patients are
    drawn class-balanced when more than one fg class exists; in 2D a slice is
    drawn with total probability p_fg=0.5 on the patient's fg slices; crops
    to pre_crop_size are centered near a random fg pixel with probability
    p_fg, constrained so the ROI stays >= patch_size/8 from the final patch
    border, and uniformly otherwise.
    """

    def __init__(self, data, batch_size, cf):
        super().__init__(data, batch_size, cf)
        self.crop_margin = np.array(cf.patch_size) / 8.0  # min distance of ROI center to patch edge
        self.p_fg = 0.5

    def _sample_patient_ixs(self, rng):
        targets_per_patient = [v["class_target"] for v in self._data.values()]
        if self.cf.head_classes > 2:
            return dutils.get_class_balanced_patients(
                targets_per_patient, self.batch_size, self.cf.head_classes - 1,
                slack_factor=self.cf.batch_sample_slack, rng=rng,
            )
        return rng.choice(len(targets_per_patient), self.batch_size)

    def _choose_slice(self, n_z, fg_slices, rng):
        """Slice id with total probability p_fg on the fg slices."""
        fg = [s for s in fg_slices if 0 <= s < n_z]
        if fg and rng.rand() < self.p_fg:
            return int(rng.choice(fg))
        bg = np.setdiff1d(np.arange(n_z), fg)
        return int(rng.choice(bg if bg.size else n_z))

    @staticmethod
    def _z_context_window(volume, slice_id, n_ctx):
        """(1, y, x, z) -> (2*n_ctx+1, y, x): the slice and its z neighbors
        stacked into channels (zero-padded at the volume ends)."""
        padded = np.pad(volume[0], ((0, 0), (0, 0), (n_ctx, n_ctx)), "constant")
        return np.moveaxis(padded[..., slice_id : slice_id + 2 * n_ctx + 1], -1, 0)

    def _fg_anchor_center(self, data, seg, d, anchor, rng):
        """Crop-center range along axis d keeping the anchor pixel at least
        crop_margin away from the eventual patch border; uniform inside."""
        half = self.cf.pre_crop_size[d] // 2
        reach = self.cf.patch_size[d] // 2 - self.crop_margin[d]
        low = max(half, anchor[d] - reach)
        high = min(data.shape[d + 1] - half, anchor[d] + reach)
        if low >= high:  # lesion at the image edge: just keep the crop inside
            low, high = half, data.shape[d + 1] - half
        return rng.randint(int(low), int(high))

    def _pre_crop(self, data, seg, rng):
        """Pad up to, then crop down to pre_crop_size (fg-biased center)."""
        cf = self.cf
        if any(data.shape[d + 1] < ps for d, ps in enumerate(cf.pre_crop_size)):
            grown = [max(data.shape[d + 1], ps) for d, ps in enumerate(cf.pre_crop_size)]
            data = dutils.pad_nd_image(data, grown, mode="constant")
            seg = dutils.pad_nd_image(seg, grown, mode="constant")

        crop_dims = [d for d, ps in enumerate(cf.pre_crop_size) if data.shape[d + 1] > ps]
        if not crop_dims:
            return data, seg

        if rng.rand(1) < self.p_fg and seg.sum() > 0:
            instance = rng.choice(np.unique(seg)[1:], 1)
            fg_pixels = np.argwhere(seg == instance)
            anchor = fg_pixels[rng.choice(fg_pixels.shape[0], 1)][0]
            centers = {d: self._fg_anchor_center(data, seg, d, anchor, rng) for d in crop_dims}
        else:
            centers = {
                d: rng.randint(cf.pre_crop_size[d] // 2, data.shape[d + 1] - cf.pre_crop_size[d] // 2)
                for d in crop_dims
            }
        for d in crop_dims:
            lo = int(centers[d] - cf.pre_crop_size[d] // 2)
            hi = int(centers[d] + cf.pre_crop_size[d] // 2)
            data = data[(slice(None),) * (d + 1) + (slice(lo, hi),)]
            seg = seg[(slice(None),) * d + (slice(lo, hi),)]
        return data, seg

    def generate_train_batch(self, rng):
        cf = self.cf
        patients = list(self._data.values())
        batch_data, batch_segs, batch_pids, batch_targets = [], [], [], []
        for ix in self._sample_patient_ixs(rng):
            patient = patients[ix]
            # stored (z, y, x) -> channel-first (c, y, x, z)
            data = np.transpose(np.load(patient["data"], mmap_mode="r"), axes=(1, 2, 0))[np.newaxis]
            seg = np.transpose(np.load(patient["seg"], mmap_mode="r"), axes=(1, 2, 0))

            if cf.dim == 2:
                slice_id = self._choose_slice(data.shape[3], patient["fg_slices"], rng)
                if cf.n_3D_context is not None:
                    data = self._z_context_window(data, slice_id, cf.n_3D_context)
                else:
                    data = data[..., slice_id]
                seg = seg[..., slice_id]

            data, seg = self._pre_crop(data, seg, rng)
            batch_data.append(data)
            batch_segs.append(seg[np.newaxis])
            batch_pids.append(patient["pid"])
            batch_targets.append(patient["class_target"])

        ragged = len({len(t) for t in batch_targets}) > 1
        return {
            "data": np.array(batch_data).astype(np.float32),
            "seg": np.array(batch_segs).astype(np.uint8),
            "pid": batch_pids,
            "class_target": np.array(batch_targets, dtype=object) if ragged else np.array(batch_targets),
        }


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
        rank, world = mesh.host_shard_info(cf)  # this rank's patient slice
        self.dataset_pids = [v["pid"] for v in data.values()][rank::world]
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
