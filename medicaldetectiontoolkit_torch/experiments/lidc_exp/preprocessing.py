"""LIDC preprocessing of the port: the raw scans to normalized volumes, and
the synthetic generator.

Counterpart of ``experiments/lidc_exp/preprocessing.py``, without pandas:
  * ``pp_patient`` reads one raw patient directory (``{pid}_ct_scan.nrrd``
    and one ``.nii.gz`` mask per rater and nodule), resamples the CT to
    ``cf.target_spacing`` (order 1), clips it to [-1200, 600] HU and
    z-scores it; fuses each nodule's rater masks by a majority vote over
    four rater slots and its malignancy by the mean of the slots' scores
    above -1 (absent raters count as 0); suppresses a nodule whose fused
    mask is empty (logged to ``suppressed_rois.txt``); writes
    ``{pid}_img.npy`` (z, y, x) float32, ``{pid}_rois.npy`` (instance
    labels 1..n, uint8) and ``meta_info_{pid}.pickle`` ({pid, class_target,
    spacing, fg_slices}). The arithmetic is in ``normalize_ct`` and
    ``fuse_masks``, which take arrays; the scores come from
    ``characteristics.csv`` (``;``-separated, read with ``csv``);
  * ``aggregate_meta_info`` writes ``info_df.pickle``, the directory's
    index, its rows in ``os.listdir`` order of the meta files: a pandas
    ``DataFrame`` pickle (``dataloader_utils.dataframe_pickle``), so that
    the JAX loader reads a directory written here. The port's loader reads
    the meta files themselves, in the same order;
  * ``generate_synthetic_lidc`` writes, from the same seed, the same
    patients as the JAX package's generator, and the index.

SimpleITK reads the raw files. As in the JAX package it is imported only
where a file is read (``_require_sitk``), so the module imports without it.

    # every patient directory under cf.raw_data_dir into cf.pp_dir (MDT_LIDC_ROOT sets the root)
    python -m medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing
    # synthetic patients into --out_dir (default cf.pp_data_path)
    python -m medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing --synthetic [--out_dir DIR] \\
        [--n_patients N] [--shape Z Y X] [--seed S]
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy import ndimage

from medicaldetectiontoolkit_torch.data.dataloader_utils import dataframe_pickle

INDEX_COLUMNS = ["pid", "class_target", "spacing", "fg_slices"]


def _require_sitk():
    try:
        import SimpleITK as sitk

        return sitk
    except ImportError as e:
        raise ImportError(
            "SimpleITK is required to read raw LIDC NRRD/NIfTI files. Install it, or use "
            "generate_synthetic_lidc() / pre-converted npy data."
        ) from e


def resample_array(src_imgs, src_spacing, target_spacing):
    """Order-1 resample of a (z, y, x) array from ``src_spacing`` to
    ``target_spacing`` (both (x, y, z) mm; the source's rounded to 3
    decimals); the target shape truncates. Returns float32."""
    src_spacing = np.round(src_spacing, 3)
    target_shape = [
        int(src_imgs.shape[ix] * src_spacing[::-1][ix] / target_spacing[::-1][ix]) for ix in range(len(src_imgs.shape))
    ]
    for i in range(len(target_shape)):
        assert target_shape[i] > 0, ("AssertionError:", src_imgs.shape, src_spacing, target_spacing)
    img = src_imgs.astype(float)
    zoom = [t / s for t, s in zip(target_shape, img.shape)]
    return ndimage.zoom(img, zoom, order=1, mode="nearest").astype("float32")


def normalize_ct(arr, spacing, target_spacing):
    """The raw CT ``arr`` (z, y, x) in HU at ``spacing`` resampled to
    ``target_spacing``, clipped to [-1200, 600] and z-scored in float32."""
    arr = resample_array(arr, spacing, target_spacing)
    arr = np.clip(arr, -1200, 600).astype(np.float32)
    return (arr - arr.mean()) / arr.std()


def fuse_masks(masks, labels, target_spacing, img_shape):
    """Majority vote of one nodule's rater masks.

    ``masks`` are (array, spacing) pairs in file order, each resampled to
    ``target_spacing`` and summed; absent raters up to four vote 0 and
    score 0. Returns (the fused bool mask: a mean vote >= 0.5, the mean of
    the scores above -1)."""
    votes = np.zeros(img_shape, dtype=np.float32)
    for arr, spacing in masks:
        arr = resample_array(arr.astype(np.uint8), spacing, target_spacing)
        assert arr.shape == img_shape, [arr.shape, img_shape]
        votes += arr
    labels = list(labels) + [0] * (4 - len(labels))
    fused = (votes / 4.0) >= 0.5
    return fused, np.mean([lab for lab in labels if lab > -1])


def _number(text):
    """A csv field as pandas reads a number: anything that does not parse
    (an empty field included) is NaN."""
    try:
        return float(text)
    except (TypeError, ValueError):
        return float("nan")


def read_characteristics(csv_path, pid):
    """The rows of ``characteristics.csv`` (``;``-separated) whose
    ``PatientID`` is ``pid``, as text: dicts with ``NoduleID`` and
    ``Malignancy`` as numbers (NaN where empty)."""
    with open(csv_path, newline="") as handle:
        return [{"NoduleID": _number(row["NoduleID"]), "Malignancy": _number(row["Malignancy"])}
                for row in csv.DictReader(handle, delimiter=";") if row["PatientID"] == pid]


def _load_normalized_ct(path, pid, cf):
    """Read ``{pid}_ct_scan.nrrd`` and normalize it (``normalize_ct``);
    returns (the volume, the raw spacing)."""
    sitk = _require_sitk()
    img = sitk.ReadImage(os.path.join(path, f"{pid}_ct_scan.nrrd"))
    arr = sitk.GetArrayFromImage(img)
    print(f"processing {pid}", img.GetSpacing(), arr.shape)
    return normalize_ct(arr, img.GetSpacing(), cf.target_spacing), img.GetSpacing()


def _fuse_one_nodule(mask_files, char_rows, pid, cf, img_shape):
    """Read one nodule's rater masks (``cf.raw_data_dir/pid/``) and their
    scores (the ``Malignancy`` of the row of ``char_rows``, the patient's
    characteristics, whose ``NoduleID`` is the file name's third ``_``
    field), then ``fuse_masks``."""
    sitk = _require_sitk()
    masks, labels = [], []
    for mf in mask_files:
        roi = sitk.ReadImage(os.path.join(cf.raw_data_dir, pid, mf))
        masks.append((sitk.GetArrayFromImage(roi).astype(np.uint8), roi.GetSpacing()))
        nodule_id = int(mf.split("_")[2].lstrip("0"))
        labels.append([r["Malignancy"] for r in char_rows if r["NoduleID"] == nodule_id][0])
    return fuse_masks(masks, labels, cf.target_spacing, img_shape)


def pp_patient(inputs, cf):
    """Preprocess one raw patient: ``inputs`` is (index, its directory);
    writes ``{pid}_img.npy``, ``{pid}_rois.npy`` and
    ``meta_info_{pid}.pickle`` into ``cf.pp_dir``."""
    _, path = inputs
    pid = os.path.basename(path.rstrip("/"))
    img_arr, spacing = _load_normalized_ct(path, pid, cf)
    char_rows = read_characteristics(os.path.join(cf.root_dir, "characteristics.csv"), pid)

    # the rater masks ({...}_{noduleid}_{roiid}.nii.gz) by roi id, walked in sorted order
    masks_by_roi = {}
    for f in os.listdir(path):
        if ".nii.gz" in f:
            masks_by_roi.setdefault(f.split(".")[0].split("_")[-1], []).append(f)

    final_rois = np.zeros_like(img_arr, dtype=np.uint8)
    mal_labels = []
    for rid in sorted(masks_by_roi):
        fused, malignancy = _fuse_one_nodule(masks_by_roi[rid], char_rows, pid, cf, img_arr.shape)
        if fused.any():
            mal_labels.append(malignancy)
            final_rois[fused] = len(mal_labels)
        else:
            print("suppressed roi!", masks_by_roi[rid])
            with open(os.path.join(cf.pp_dir, "suppressed_rois.txt"), "a") as handle:
                handle.write(" ".join(masks_by_roi[rid]) + "\n")

    fg_slices = [int(z) for z in np.unique(np.nonzero(final_rois)[0])]
    mal_labels = np.array(mal_labels)
    assert len(mal_labels) + 1 == len(np.unique(final_rois)), [len(mal_labels), np.unique(final_rois), pid]

    np.save(os.path.join(cf.pp_dir, f"{pid}_rois.npy"), final_rois)
    np.save(os.path.join(cf.pp_dir, f"{pid}_img.npy"), img_arr)
    with open(os.path.join(cf.pp_dir, f"meta_info_{pid}.pickle"), "wb") as handle:
        pickle.dump({"pid": pid, "class_target": mal_labels, "spacing": spacing, "fg_slices": fg_slices}, handle)


def aggregate_meta_info(exp_dir):
    """Write ``exp_dir/info_df.pickle``; return its rows."""
    rows = []
    for f in os.listdir(exp_dir):
        if "meta_info" in f:
            with open(os.path.join(exp_dir, f), "rb") as handle:
                d = pickle.load(handle)
            rows.append([d["pid"], d["class_target"], d["spacing"], d["fg_slices"]])
    with open(os.path.join(exp_dir, "info_df.pickle"), "wb") as handle:
        handle.write(dataframe_pickle(rows, INDEX_COLUMNS))
    print("aggregated meta info to df with length", len(rows))
    return rows


def generate_synthetic_lidc(out_dir, n_patients=8, shape=(64, 96, 96), n_nodules=(1, 3), seed=0):
    """Write ``n_patients`` synthetic patients into ``out_dir``, then the
    index; return their meta-info dicts in generation order.

    Volumes are (z, y, x) noise with ellipsoidal 'nodules'; rois are instance
    labelled; class_target carries raw malignancy scores (2 or 4) so the
    loader's >= 3 binarization applies, alternating so that every small split
    holds both classes.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    metas = []
    for p in range(n_patients):
        pid = f"synth_{p:03d}"
        img = rng.randn(*shape).astype(np.float32) * 0.2
        rois = np.zeros(shape, np.uint8)
        n = rng.randint(n_nodules[0], n_nodules[1] + 1)
        mal = []
        for i in range(n):
            r = rng.randint(3, 7)
            cz = rng.randint(r, shape[0] - r)
            cy = rng.randint(r + 2, shape[1] - r - 2)
            cx = rng.randint(r + 2, shape[2] - r - 2)
            zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
            ball = ((zz - cz) ** 2 / (r / 2) ** 2 + (yy - cy) ** 2 / r**2 + (xx - cx) ** 2 / r**2) < 1
            img[ball] += 1.0
            rois[ball] = i + 1
            mal.append(2 if (p + i) % 2 == 0 else 4)
        fg_slices = [int(ii) for ii in np.unique(np.argwhere(rois != 0)[:, 0])]
        meta = {"pid": pid, "class_target": np.array(mal), "spacing": (0.7, 0.7, 1.25), "fg_slices": fg_slices}
        np.save(os.path.join(out_dir, f"{pid}_img.npy"), img)
        np.save(os.path.join(out_dir, f"{pid}_rois.npy"), rois)
        with open(os.path.join(out_dir, f"meta_info_{pid}.pickle"), "wb") as handle:
            pickle.dump(meta, handle)
        metas.append(meta)
    aggregate_meta_info(out_dir)
    return metas


if __name__ == "__main__":
    from medicaldetectiontoolkit_torch.experiments.lidc_exp.configs import configs

    ap = argparse.ArgumentParser(description="preprocess the raw LIDC scans, or write a synthetic LIDC-shaped set")
    ap.add_argument("--synthetic", action="store_true", help="generate a synthetic LIDC-shaped dataset instead")
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--n_patients", type=int, default=8)
    ap.add_argument("--shape", type=int, nargs=3, default=(64, 96, 96), help="z y x of each synthetic volume")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cf = configs()
    if args.synthetic:
        generate_synthetic_lidc(args.out_dir or cf.pp_data_path, n_patients=args.n_patients, shape=tuple(args.shape),
                                seed=args.seed)
    else:
        paths = [os.path.join(cf.raw_data_dir, ii) for ii in os.listdir(cf.raw_data_dir)]
        os.makedirs(cf.pp_dir, exist_ok=True)
        with ThreadPoolExecutor(max_workers=12) as pool:
            list(pool.map(lambda i: pp_patient(i, cf), enumerate(paths)))
        aggregate_meta_info(cf.pp_dir)
