"""Synthetic LIDC-shaped patients for the port's tests, smoke runs and timing.

Counterpart of ``generate_synthetic_lidc`` in
``experiments/lidc_exp/preprocessing.py``: from the same seed it writes the
same ``{pid}_img.npy`` (z, y, x) float32 volumes, instance-labelled
``{pid}_rois.npy`` and ``meta_info_{pid}.pickle`` dicts ({pid, class_target,
spacing, fg_slices}), which is the per-patient contract of the real LIDC
preprocessing as well. It writes no ``info_df.pickle``: the port's loader
reads the ``meta_info`` dicts themselves (no pandas). Preprocessing the raw
LIDC scans is not ported.

    python -m medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing --out_dir DIR [--n_patients N]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def generate_synthetic_lidc(out_dir, n_patients=8, shape=(64, 96, 96), n_nodules=(1, 3), seed=0):
    """Write ``n_patients`` synthetic patients into ``out_dir``; return their
    meta-info dicts in generation order.

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
    return metas


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="write a synthetic LIDC-shaped data set")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--n_patients", type=int, default=8)
    ap.add_argument("--shape", type=int, nargs=3, default=(64, 96, 96), help="z y x of each volume")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    generate_synthetic_lidc(args.out_dir, n_patients=args.n_patients, shape=tuple(args.shape), seed=args.seed)
