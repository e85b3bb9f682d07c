"""Toy experiment data loader of the port, with no pandas and no jax.

Counterpart of ``experiments/toy_exp/data_loader.py``, with the same entry
points and batch dicts: ``get_train_generators(cf, logger)`` (the first
``2 * n_train_val_data // 3`` of the sorted pids train, the rest up to
``n_train_val_data`` validate), ``get_test_generator(cf, logger)`` (the
hold-out test directory), ``BatchGenerator`` (class-balanced whole 320x320
images, no augmentation but the center crop, as the reference's
``do_aug=False``), boxes drawn from the segs after the transforms, and
``PatientBatchIterator`` (one whole image per batch, tiled when
``patch_size`` is smaller). ``load_dataset`` reads the per-image
``meta_info_{pid}.pickle`` files in ``os.listdir`` order, which is the row
order of the ``info_df.pickle`` that both generators aggregate from the same
directory; the same seed gives the JAX package's batches, array for array.
Each rank (``parallel/mesh.py::host_shard_info``; rank 0 of 1 on one card)
seeds its workers ``rank * n_workers + w``, samples ``cf.batch_size / W``
rows of the global batch and iterates the patient slice
``pids[rank::world]``, which ``n_test`` and ``n_val`` count.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from medicaldetectiontoolkit_torch.data import dataloader_utils as dutils
from medicaldetectiontoolkit_torch.data.augmentation import center_crop_batch, mirror_batch, spatial_augment_batch
from medicaldetectiontoolkit_torch.data.loader import BatchGeneratorBase, MultiThreadedGenerator
from medicaldetectiontoolkit_torch.data.seg_to_boxes import convert_seg_to_bounding_box_coordinates
from medicaldetectiontoolkit_torch.experiments.toy_exp.generate_toys import read_meta_info
from medicaldetectiontoolkit_torch.parallel import mesh


def get_train_generators(cf, logger):
    """Train/val generators with the reference's fixed split by count: the
    first two thirds of ``n_train_val_data`` sorted pids train, the rest
    validate."""
    all_data = load_dataset(cf, logger)
    all_pids_list = np.unique([v["pid"] for (k, v) in all_data.items()])

    assert cf.n_train_val_data <= len(all_pids_list), (
        f"requested {cf.n_train_val_data} train val samples, but dataset only has {len(all_pids_list)}"
    )
    train_pids = set(all_pids_list[: int(2 * cf.n_train_val_data // 3)])
    val_pids = set(all_pids_list[int(np.ceil(2 * cf.n_train_val_data // 3)) : cf.n_train_val_data])

    train_data = {k: v for (k, v) in all_data.items() if v["pid"] in train_pids}
    val_data = {k: v for (k, v) in all_data.items() if v["pid"] in val_pids}

    logger.info(f"data set loaded with: {len(train_pids)} train / {len(val_pids)} val patients")
    batch_gen = {}
    batch_gen["train"] = create_data_gen_pipeline(train_data, cf=cf, do_aug=False)
    batch_gen["val_sampling"] = create_data_gen_pipeline(val_data, cf=cf, do_aug=False)
    if cf.val_mode == "val_patient":
        batch_gen["val_patient"] = PatientBatchIterator(val_data, cf=cf)
        n = len(batch_gen["val_patient"].dataset_pids)
        batch_gen["n_val"] = n if cf.max_val_patients is None else min(n, cf.max_val_patients)
    else:
        batch_gen["n_val"] = cf.num_val_batches
    return batch_gen


def get_test_generator(cf, logger):
    """Hold-out test iterator (toy always uses a separate test dir)."""
    test_data = load_dataset(cf, logger, pp_data_path=cf.pp_test_data_path)
    logger.info(f"data set loaded with: {len(test_data)} test patients from {cf.pp_test_data_path}")
    it = PatientBatchIterator(test_data, cf=cf)
    n = len(it.dataset_pids)  # this rank's slice
    return {"test": it, "n_test": n if cf.max_test_patients == "all" else min(cf.max_test_patients, n)}


def load_dataset(cf, logger, subset_ixs=None, pp_data_path=None):
    """The directory's meta files -> OrderedDict of per-image meta (paths +
    class), in ``info_df.pickle``'s row order."""
    if pp_data_path is None:
        pp_data_path = cf.pp_data_path
    rows = read_meta_info(pp_data_path)
    if subset_ixs is not None:
        unique = np.unique([pid for _, _, pid in rows])
        subset_pids = {unique[ix] for ix in subset_ixs}
        rows = [r for r in rows if r[2] in subset_pids]
        logger.info(f"subset: selected {len(rows)} instances from df")

    data = OrderedDict()
    for _, class_id, pid in rows:
        path = os.path.join(pp_data_path, f"{pid}.npy")
        data[pid] = {"data": path, "seg": path, "pid": pid, "class_target": [class_id]}
    return data


class BatchGenerator(BatchGeneratorBase):
    """Class-balanced whole-image sampler; (b, 1, 320, 320) data + seg."""

    def generate_train_batch(self, rng):
        batch_data, batch_segs, batch_pids, batch_targets = [], [], [], []
        class_targets_list = [v["class_target"] for (k, v) in self._data.items()]
        batch_ixs = dutils.get_class_balanced_patients(
            class_targets_list, self.batch_size, self.cf.head_classes - 1, slack_factor=self.cf.batch_sample_slack, rng=rng
        )
        patients = list(self._data.items())
        for b in batch_ixs:
            patient = patients[b][1]
            all_data = np.load(patient["data"], mmap_mode="r")
            batch_data.append(all_data[0][np.newaxis].astype(np.float32))
            batch_segs.append(all_data[1][np.newaxis].astype("uint8"))
            batch_pids.append(patient["pid"])
            batch_targets.append(patient["class_target"])
        return {
            "data": np.array(batch_data),
            "seg": np.array(batch_segs).astype("uint8"),
            "pid": batch_pids,
            "class_target": np.array(batch_targets),
        }


def _make_transforms(cf, do_aug):
    """Transform chain: (aug or center-crop) then seg->boxes."""
    transforms = []
    if do_aug:
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
    return transforms


def create_data_gen_pipeline(patient_data, cf, do_aug=True):
    data_gen = BatchGenerator(patient_data, batch_size=mesh.local_batch_size(cf), cf=cf)
    transforms = _make_transforms(cf, do_aug)
    rank, _ = mesh.host_shard_info(cf)  # distinct sampling per rank
    seeds = [rank * cf.n_workers + w for w in range(cf.n_workers)]
    return MultiThreadedGenerator(data_gen, transforms, n_workers=cf.n_workers, seeds=seeds)


class PatientBatchIterator:
    """Iterates the dataset one whole patient per batch (test/val_patient).

    Adds the patient-level keys the predictor consumes: patient_bb_target,
    patient_roi_labels, original_img_shape.
    """

    def __init__(self, data, cf):
        self._data = data
        self.cf = cf
        self.patient_ix = 0
        rank, world = mesh.host_shard_info(cf)  # this rank's patient slice
        self.dataset_pids = [v["pid"] for (k, v) in data.items()][rank::world]

    def __iter__(self):
        return self

    def __next__(self):
        if not self.dataset_pids:
            # an empty data set iterates nothing
            raise StopIteration
        pid = self.dataset_pids[self.patient_ix]
        patient = self._data[pid]
        all_data = np.load(patient["data"], mmap_mode="r")
        data = all_data[0].astype(np.float32)
        seg = all_data[1].astype("uint8")
        batch = {
            "data": data[None, None],
            "seg": seg[None, None],
            "class_target": np.array([patient["class_target"]]),
            "pid": pid,
        }
        batch = convert_seg_to_bounding_box_coordinates(
            batch, dim=2, get_rois_from_seg_flag=False, class_specific_seg_flag=self.cf.class_specific_seg_flag
        )
        batch.update(
            {
                "patient_bb_target": batch["bb_target"],
                "patient_roi_labels": batch["roi_labels"],
                "original_img_shape": batch["data"].shape,
            }
        )
        if any(p < e for p, e in zip(self.cf.patch_size, data.shape)):
            # patch_size below the fixed 320 toy image (MDT_TOY_PATCH): tile
            # into the predictor's patched-patient contract like the LIDC
            # iterator — the whole-image forward would hit the model's
            # patch-geometry anchors. Crops carry a (0, 1) pseudo-z so the
            # 2D stitching path can index the batch element.
            crops = dutils.get_patch_crop_coords(data, self.cf.patch_size)
            crops = np.concatenate(
                [crops, np.zeros((len(crops), 1), int), np.ones((len(crops), 1), int)], axis=1
            )
            pbatch = {
                "data": np.array([data[c[0] : c[1], c[2] : c[3]] for c in crops])[:, None],
                "seg": np.array([seg[c[0] : c[1], c[2] : c[3]] for c in crops])[:, None],
                "class_target": np.repeat(np.array([patient["class_target"]]), len(crops), axis=0),
                "pid": pid,
                "patch_crop_coords": crops,
                "patient_bb_target": batch["patient_bb_target"],
                "patient_roi_labels": batch["patient_roi_labels"],
                "original_img_shape": batch["original_img_shape"],
            }
            batch = convert_seg_to_bounding_box_coordinates(
                pbatch, dim=2, get_rois_from_seg_flag=False,
                class_specific_seg_flag=self.cf.class_specific_seg_flag,
            )
        self.patient_ix += 1
        if self.patient_ix == len(self.dataset_pids):
            self.patient_ix = 0
        return batch

    next = __next__
