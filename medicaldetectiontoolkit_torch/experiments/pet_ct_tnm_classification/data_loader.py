"""PET/CT data loader of the port: training generators and the test iterator
for two-modality 3D volumes.

Counterpart of ``experiments/pet_ct_tnm_classification/data_loader.py``,
with no pandas and no jax; it is the port's LIDC loader with PET/CT's
volumes and sampling:
  * ``load_dataset`` reads the per-patient ``meta_info_{pid}.pickle`` dicts
    in ``os.listdir`` order, the row order of ``info_df.pickle``; class
    targets are kept as they are (one foreground class);
  * ``get_train_generators``: the fold's train and val patients (the CV split
    written once per experiment to ``fold_ids.pickle``; with
    ``cf.hold_out_test_set`` the fold's test patients train too), a train
    pipeline (``BatchGenerator`` -> mirror -> spatial augmentation -> boxes)
    and a ``val_sampling`` pipeline (center crop -> boxes), each a
    ``MultiThreadedGenerator`` of ``cf.n_workers`` threads seeded
    ``rank * n_workers + w``, each rank sampling ``cf.batch_size / W`` rows
    of the global batch (the LIDC pipeline's);
  * ``BatchGenerator``: patients drawn uniformly (``head_classes == 2``) or
    class-balanced, fg-anchored pre-crops; the same ``RandomState`` gives the
    JAX package's batches, array for array;
  * ``get_test_generator``: every patient of ``cf.pp_test_data_path`` (the
    hold-out set), one per step through ``PatientBatchIterator``: the whole
    patient padded to patch size and its overlapping patch grid; each rank
    iterates its slice ``pids[rank::world]``, which ``n_test`` counts.

Stored volumes are (c, z, y, x) and are transposed to (c, y, x, z) on load,
then ``cf.channels`` is selected (CT and PET); segs are (z, y, x).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from medicaldetectiontoolkit_torch.data import dataloader_utils as dutils
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as lidc
from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing import read_meta_info


def get_train_generators(cf, logger):
    """Train and val_sampling batch-generator pipelines for one CV fold."""
    all_data = load_dataset(cf, logger)
    pids = np.unique([v["pid"] for v in all_data.values()])
    train_ix, val_ix, test_ix, _ = lidc._fold_splits(cf, len(pids))[cf.fold]

    train_pids = {pids[i] for i in train_ix}
    val_pids = {pids[i] for i in val_ix}
    if cf.hold_out_test_set:
        train_pids.update(pids[i] for i in test_ix)
    train_data = {k: v for k, v in all_data.items() if v["pid"] in train_pids}
    val_data = {k: v for k, v in all_data.items() if v["pid"] in val_pids}
    logger.info(f"data set loaded with: {len(train_pids)} train / {len(val_pids)} val patients")

    gens = {
        "train": lidc.create_data_gen_pipeline(train_data, cf, True, BatchGenerator),
        "val_sampling": lidc.create_data_gen_pipeline(val_data, cf, False, BatchGenerator),
    }
    if cf.val_mode == "val_patient":
        gens["val_patient"] = PatientBatchIterator(val_data, cf=cf)
        n = len(gens["val_patient"].dataset_pids)
        gens["n_val"] = n if cf.max_val_patients is None else min(n, cf.max_val_patients)
    else:
        gens["n_val"] = cf.num_val_batches
    return gens


def get_test_generator(cf, logger):
    test_data = load_dataset(cf, logger, pp_data_path=cf.pp_test_data_path)
    logger.info(f"data set loaded with: {len(test_data)} test patients")
    it = PatientBatchIterator(test_data, cf=cf)
    n = len(it.dataset_pids)  # this rank's slice
    return {"test": it, "n_test": n if cf.max_test_patients == "all" else min(cf.max_test_patients, n)}


def load_dataset(cf, logger, subset_ixs=None, pp_data_path=None):
    if pp_data_path is None:
        pp_data_path = cf.pp_data_path
    metas = read_meta_info(pp_data_path)

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
            "class_target": [int(ii) for ii in np.atleast_1d(m["class_target"])],
            "fg_slices": m.get("fg_slices", []),
        }
    return data


def _load_volume(patient, channels):
    """(c, z, y, x) on disk -> (c, y, x, z) of ``channels``; seg (y, x, z)."""
    data = np.transpose(np.load(patient["data"], mmap_mode="r"), axes=(0, 2, 3, 1))[channels]
    seg = np.transpose(np.load(patient["seg"], mmap_mode="r"), axes=(1, 2, 0))
    return data, seg


class BatchGenerator(lidc.BatchGenerator):
    """Two-modality 3D volumes; uniform (one foreground class) or
    class-balanced patients; pre-crops to ``pre_crop_size`` centered near a
    random foreground voxel with probability p_fg (that voxel at least
    patch_size/8 from the final patch border), uniformly otherwise."""

    def _fg_anchor_center(self, data, seg, d, anchor, rng):
        half = self.cf.pre_crop_size[d] // 2
        reach = self.cf.patch_size[d] // 2 - self.crop_margin[d]
        low = max(half, anchor[d] - reach)
        high = min(data.shape[d + 1] - half, anchor[d] + reach)
        if low >= high:  # lesion at the image edge: the range about the middle (ends at 2 * (S // 2) - half)
            mid = data.shape[d + 1] // 2
            low, high = mid - (mid - half), mid + (mid - half)
        return rng.randint(int(low), int(high))

    def generate_train_batch(self, rng):
        patients = list(self._data.values())
        batch_data, batch_segs, batch_pids, batch_targets = [], [], [], []
        for ix in self._sample_patient_ixs(rng):
            patient = patients[ix]
            data, seg = _load_volume(patient, self.cf.channels)
            batch_pids.append(patient["pid"])
            batch_targets.append(patient["class_target"])
            data, seg = self._pre_crop(data, seg, rng)
            batch_data.append(data)
            batch_segs.append(seg[np.newaxis])

        ragged = len({len(t) for t in batch_targets}) > 1
        return {
            "data": np.array(batch_data).astype(np.float32),
            "seg": np.array(batch_segs).astype(np.uint8),
            "pid": batch_pids,
            "class_target": np.array(batch_targets, dtype=object) if ragged else np.array(batch_targets),
        }


class PatientBatchIterator(lidc.PatientBatchIterator):
    """Whole-patient iteration over two-modality 3D volumes: the LIDC
    iterator's batches with (c, y, x, z) data of ``cf.channels``."""

    def _load_padded(self, patient):
        data, seg = _load_volume(patient, self.cf.channels)
        data, seg = data.astype(np.float32), seg.astype("uint8")
        if any(data.shape[d + 1] < ps for d, ps in enumerate(self.patch_size)):
            grown = [max(data.shape[d + 1], self.patch_size[d]) for d in range(3)]
            data = dutils.pad_nd_image(data, [data.shape[0]] + grown)
            seg = dutils.pad_nd_image(seg, grown)
        return data, seg
