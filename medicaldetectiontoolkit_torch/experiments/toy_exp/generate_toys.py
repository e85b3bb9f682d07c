"""Synthetic toy data set of the port (320x320 circles / donuts), without pandas.

Counterpart of ``experiments/toy_exp/generate_toys.py``: the same three modes
(donuts_shape, donuts_pattern, circles_scale), the same seeds and the same
files. Each image ``{six}`` gets ``{six}.npy`` (image and seg stacked,
float64) and ``meta_info_{six}.pickle`` (``[npy path, class_id, pid]``);
each directory gets ``info_df.pickle``, the aggregated index, with its rows
in ``os.listdir`` order of the meta files, as JAX's ``aggregate_meta_info``
writes it. The index is a pandas ``DataFrame`` pickle, so that the JAX
loader reads a directory written here; it is written without importing
pandas (``dataloader_utils.dataframe_pickle``). The port's loader reads the meta files
themselves, in the same order, so it needs no pandas either.

Usage: python -m medicaldetectiontoolkit_torch.experiments.toy_exp.generate_toys [--root_dir DIR]
"""

from __future__ import annotations

import argparse
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from medicaldetectiontoolkit_torch.data.dataloader_utils import dataframe_pickle

IMG_SIZE = 320
INDEX_COLUMNS = ["path", "class_id", "pid"]


def create_image(out_dir, six, foreground_margin, class_diameters, mode, seed):
    """One image from ``RandomState(seed)``: noise, a +0.2 disc of the drawn
    class's diameter, for donuts of class 1 a 4-px hole (cut from the seg in
    donuts_shape)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(IMG_SIZE, IMG_SIZE)
    seg = np.zeros((IMG_SIZE, IMG_SIZE), dtype="uint8")
    center_x = rng.randint(foreground_margin, IMG_SIZE - foreground_margin)
    center_y = rng.randint(foreground_margin, IMG_SIZE - foreground_margin)
    class_id = rng.randint(0, 2)

    yy, xx = np.ogrid[:IMG_SIZE, :IMG_SIZE]
    dist2 = (xx - center_x) ** 2 + (yy - center_y) ** 2
    disc = dist2 < class_diameters[class_id] ** 2
    img[disc] += 0.2
    seg[disc] = 1

    if "donuts" in mode and class_id == 1:
        hole = dist2 < 4**2
        img[hole] -= 0.2
        if mode == "donuts_shape":
            seg[hole] = 0

    out_path = os.path.join(out_dir, f"{six}.npy")
    np.save(out_path, np.concatenate((img[None], seg[None])))
    with open(os.path.join(out_dir, f"meta_info_{six}.pickle"), "wb") as handle:
        pickle.dump([out_path, class_id, str(six)], handle)


def read_meta_info(data_dir):
    """The rows ``[path, class_id, pid]`` of the directory's meta files, in
    ``os.listdir`` order: the row order of its ``info_df.pickle``."""
    rows = []
    for f in os.listdir(data_dir):
        if "meta_info" in f:
            with open(os.path.join(data_dir, f), "rb") as handle:
                rows.append(pickle.load(handle))
    return rows


def aggregate_meta_info(data_dir):
    rows = read_meta_info(data_dir)
    with open(os.path.join(data_dir, "info_df.pickle"), "wb") as handle:
        handle.write(dataframe_pickle(rows, INDEX_COLUMNS))
    print(f"aggregated meta info to df with length {len(rows)}")


def generate_experiment(root_dir, exp_name, n_train_images, n_test_images, mode, class_diameters=(20, 20), seed0=0):
    """``root_dir/exp_name/{train,test}``: image ``six`` of train drawn from
    seed ``seed0 + six``, of test from ``seed0 + n_train_images + six``."""
    train_dir = os.path.join(root_dir, exp_name, "train")
    test_dir = os.path.join(root_dir, exp_name, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    foreground_margin = int(np.max(class_diameters) // 2)

    jobs = [(train_dir, six, foreground_margin, class_diameters, mode, seed0 + six) for six in range(n_train_images)]
    jobs += [
        (test_dir, six, foreground_margin, class_diameters, mode, seed0 + n_train_images + six)
        for six in range(n_test_images)
    ]
    with ThreadPoolExecutor(max_workers=12) as pool:
        list(pool.map(lambda a: create_image(*a), jobs))
    aggregate_meta_info(train_dir)
    aggregate_meta_info(test_dir)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--root_dir", default=os.environ.get("MDT_TOY_ROOT", "/tmp/toy_mdt"))
    ap.add_argument("--n_train", type=int, default=1500)
    ap.add_argument("--n_test", type=int, default=1000)
    ap.add_argument("--modes", nargs="+", default=["donuts_shape", "donuts_pattern", "circles_scale"])
    args = ap.parse_args()
    for mode in args.modes:
        diam = (19, 20) if mode == "circles_scale" else (20, 20)
        generate_experiment(args.root_dir, mode, args.n_train, args.n_test, mode, class_diameters=diam)
