"""PET/CT data of the port: the synthetic two-modality generator, the index,
and the scipy helpers of the raw preprocessing.

Counterpart of ``experiments/pet_ct_tnm_classification/preprocessing.py``,
without pandas:
  * ``generate_synthetic_petct`` writes, from the same seed, the same
    ``{pid}_img.npy`` (2, z, y, x) float32 volumes (CT and PET), binary
    ``{pid}_rois.npy`` and ``meta_info_{pid}.pickle`` dicts ({pid, raw_pid,
    class_target, fg_slices}), which is the per-patient contract of the raw
    preprocessing as well;
  * ``aggregate_meta_info`` writes ``info_df.pickle``, the index of the
    directory, with its rows in ``os.listdir`` order of the meta files: a
    pandas ``DataFrame`` pickle (``dataloader_utils.dataframe_pickle``), so
    that the JAX loader reads a directory written here. The port's loader
    reads the meta files themselves, in the same order;
  * ``get_z_crops`` (the lung's z range on a CT volume, by air components
    near the slice center) with ``_clear_border``, and ``collect_paths``
    (the raw patients' directories).

Resampling and normalizing the raw LungStage scans (``pp_patient``) needs
the raw data, SimpleITK and pynrrd, and is not ported.

    python -m medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing --out_dir DIR \\
        [--n_patients N] [--shape Z Y X] [--seed S]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from scipy import ndimage

from medicaldetectiontoolkit_torch.data.dataloader_utils import dataframe_pickle

INDEX_COLUMNS = ["pid", "raw_pid", "class_target", "fg_slices"]


def _clear_border(mask):
    """Remove the components of ``mask`` (y, x) that touch the image border."""
    labeled, n = ndimage.label(mask)
    if n == 0:
        return mask
    border_labels = np.unique(
        np.concatenate([labeled[0].ravel(), labeled[-1].ravel(), labeled[:, 0].ravel(), labeled[:, -1].ravel()])
    )
    out = mask.copy()
    for lab in border_labels:
        if lab != 0:
            out[labeled == lab] = 0
    return out


def get_z_crops(x, ix, min_pix=1500, n_comps=2, rad_crit=20000):
    """The lung's z range (z_min, z_max) on the CT volume ``x`` (z, y, x).

    A slice counts as lung when it holds at least ``n_comps`` air components
    (< -600 HU, border-cleared) of more than ``min_pix`` pixels whose
    centers of mass lie within ``rad_crit`` (squared distance) of the slice
    center. The range is the lung slices +- 7; one of 151 slices or more
    is retried with stricter parameters, one of 43 or fewer with one
    component allowed.
    """
    final_slices = []
    for six in range(x.shape[0]):
        tx = np.copy(x[six]) < -600
        img_center = np.array(tx.shape) / 2
        tx = _clear_border(tx)
        clusters, n_cands = ndimage.label(tx)
        count = np.unique(clusters, return_counts=True)
        keep_comps = np.array([int(ii) for ii in np.argwhere(count[1] > min_pix).ravel() if ii > 0])
        if len(keep_comps) > n_comps - 1:
            coms = ndimage.center_of_mass(tx, clusters, index=list(keep_comps))
            keep_com = [
                kix
                for kix, ii in enumerate(np.atleast_2d(coms))
                if ((ii[0] - img_center[0]) ** 2 + (ii[1] - img_center[1]) ** 2 < rad_crit)
            ]
            keep_comps = keep_comps[keep_com]
            if len(keep_comps) > n_comps - 1:
                final_slices.append(six)

    if not final_slices:
        return 0, x.shape[0]
    z_min = max(np.min(final_slices) - 7, 0)
    z_max = np.max(final_slices) + 7
    dist = z_max - z_min
    if dist >= 151:
        return get_z_crops(x, ix, min_pix=min_pix + 500, n_comps=n_comps, rad_crit=rad_crit - 500)
    if dist <= 43 and n_comps > 1:
        return get_z_crops(x, ix, n_comps=1, min_pix=min_pix - 100, rad_crit=rad_crit + 100)
    return z_min, z_max


def read_meta_info(pp_dir):
    """The ``meta_info`` dicts of ``pp_dir`` in ``os.listdir`` order: the
    row order of its ``info_df.pickle``."""
    metas = []
    for f in os.listdir(pp_dir):
        if "meta_info" in f:
            with open(os.path.join(pp_dir, f), "rb") as handle:
                metas.append(pickle.load(handle))
    return metas


def aggregate_meta_info(pp_dir):
    """Write ``pp_dir/info_df.pickle``; return its rows."""
    rows = [[d["pid"], d.get("raw_pid", str(d["pid"])), d["class_target"], d["fg_slices"]]
            for d in read_meta_info(pp_dir)]
    with open(os.path.join(pp_dir, "info_df.pickle"), "wb") as handle:
        handle.write(dataframe_pickle(rows, INDEX_COLUMNS))
    print("aggregated meta info to df with length", len(rows))
    return rows


def collect_paths(in_dir):
    """The raw patients' directories under ``in_dir``: those on a path with
    ``TNM`` that hold a PET file (``lsa_pet``)."""
    paths = []
    for path, dirs, files in os.walk(in_dir):
        pet_files = [f for f in files if "lsa_pet" in f]
        if len(files) > 0 and "TNM" in path and len(pet_files) > 0:
            paths.append(path)
    return paths


def generate_synthetic_petct(out_dir, n_patients=4, shape=(40, 96, 96), seed=0):
    """Write ``n_patients`` synthetic patients of ``shape`` (z, y, x) into
    ``out_dir``: CT and PET noise, each with one ellipsoidal lesion (+1 in
    CT, +2 in PET) that is the binary roi; then the index. Returns the
    index's rows."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for p in range(n_patients):
        pid = f"petct_{p:03d}"
        ct = rng.randn(*shape).astype(np.float32) * 0.3
        pet = rng.randn(*shape).astype(np.float32) * 0.3
        rois = np.zeros(shape, np.uint8)
        r = rng.randint(3, max(4, min(8, shape[0] // 3)))
        cz = rng.randint(r, shape[0] - r)
        cy = rng.randint(r + 2, shape[1] - r - 2)
        cx = rng.randint(r + 2, shape[2] - r - 2)
        zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
        ball = ((zz - cz) ** 2 / (r / 2) ** 2 + (yy - cy) ** 2 / r**2 + (xx - cx) ** 2 / r**2) < 1
        ct[ball] += 1.0
        pet[ball] += 2.0
        rois[ball] = 1
        img = np.stack([ct, pet])
        fg_slices = [int(ii) for ii in np.unique(np.argwhere(rois != 0)[:, 0])]
        np.save(os.path.join(out_dir, f"{pid}_img.npy"), img)
        np.save(os.path.join(out_dir, f"{pid}_rois.npy"), rois)
        with open(os.path.join(out_dir, f"meta_info_{pid}.pickle"), "wb") as handle:
            pickle.dump({"pid": pid, "raw_pid": pid, "class_target": [0], "fg_slices": fg_slices}, handle)
    return aggregate_meta_info(out_dir)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="write a synthetic PET/CT data set")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_patients", type=int, default=4)
    ap.add_argument("--shape", type=int, nargs=3, default=(40, 96, 96), help="z y x of each volume")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate_synthetic_petct(args.out_dir, n_patients=args.n_patients, shape=tuple(args.shape), seed=args.seed)
