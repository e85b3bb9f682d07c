"""Data-loading utilities of the port: balanced sampling, CV folds, patch
grids, padding, npz unpacking.

Counterpart of ``medicaldetectiontoolkit_tpu/data/dataloader_utils.py``
(same contracts, the port's own copy): ``get_class_balanced_patients``
(roi-level class-equilibrium patient sampling; the same RNG gives the same
picks), ``fold_generator`` (the same (seed, n_splits, len_data) give the
same fold memberships), ``get_patch_crop_coords`` with its
``_axis_intervals`` (overlapping patch grid with a minimum overlap, per-slice
z-tiling for patch z == 1), ``pad_nd_image``, the npy <-> npz packing of a
preprocessed data set (``pack_dataset``, ``unpack_dataset``, ``delete_npy``;
unpacking is what staging a packed data set to ``cf.data_dest`` uses), and
``dataframe_pickle``, the bytes of a pandas ``DataFrame`` pickle written
without pandas (the experiments' ``info_df.pickle``).
"""

from __future__ import annotations

import itertools
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def get_class_balanced_patients(class_targets, batch_size, num_classes, slack_factor=0.1, rng=None):
    """Sample patient indices toward roi-level class equilibrium.

    class_targets: list (per patient) of lists of roi class labels (0-based
    foreground classes). The first ``slack_factor * batch_size`` picks are
    unconstrained; afterwards a candidate is accepted only if it would boost
    the batch's currently scarcest class: it must contain that class, and the
    class must not also be the candidate's own scarcest one. Labels outside
    [0, num_classes) are ignored. If the scarcest class is in no patient,
    a candidate is accepted after ``100 * max(n_patients, batch_size)``
    attempts.

    The RNG call sequence (one ``choice(n, 1)`` per attempt) is part of the
    reproducibility contract and must not change.
    """
    rng = rng or np.random
    n_patients = len(class_targets)
    counts = np.zeros((n_patients, num_classes), dtype=np.int64)  # per-patient class histogram
    for p, targets in enumerate(class_targets):
        for t in targets:
            if 0 <= t < num_classes:
                counts[p, t] += 1

    n_slack = int(batch_size * slack_factor)
    max_tries = 100 * max(n_patients, batch_size)
    picks = []
    batch_counts = np.zeros(num_classes, dtype=np.int64)
    scarcest = 0
    for k in range(batch_size):
        for _ in range(max_tries):
            cand = rng.choice(n_patients, 1)[0]
            if k < n_slack:
                break
            if counts[cand, scarcest] > 0 and int(np.argmin(counts[cand])) != scarcest:
                break
        picks.append(cand)
        batch_counts += counts[cand]
        scarcest = int(np.argmin(batch_counts))
    return picks


def _rotation_splits(n_items, n_splits):
    """Yield (train, val, test) position lists for each of n_splits folds.

    The scheme is a block rotation over the (already shuffled) positions
    0..n_items-1: three leading chunks of size ceil(n/k) seed test/val/train;
    each fold then retires the test block into the train pool, promotes val to
    test, and draws a fresh val chunk off the train front. The first
    ``(-n) mod k`` drawn chunks are one element short so sizes balance, and
    when n mod k == 1 the second-to-last fold donates val's last element to
    the retiring block to even out the final fold.
    """
    size = int(np.ceil(n_items / n_splits))
    shortfall = (-n_items) % n_splits  # number of one-smaller val chunks
    positions = list(range(n_items))
    test, val, train = positions[:size], positions[size : 2 * size], positions[2 * size :]
    for fold in range(n_splits):
        yield train, val, test
        retired = list(test)
        if fold == n_splits - 2 and n_items % n_splits == 1:
            retired.append(val[-1])
            val = val[:-1]
        take = size - 1 if fold < shortfall else size
        test, val, train = val, train[:take], train[take:] + retired


class fold_generator:
    """n-fold CV splitter with inner-loop test set.

    Same (seed, n_splits, len_data) -> same fold memberships as the
    reference's splitter — that mapping is the compatibility contract for
    resuming / comparing experiments (pinned by exact parity tests).
    """

    def __init__(self, seed, n_splits, len_data):
        self.myseed = seed
        self.n_splits = n_splits
        self.len_data = len_data

    def get_fold_names(self):
        rgen = np.random.RandomState(self.myseed)
        names = np.arange(self.len_data)
        rgen.shuffle(names)
        return [
            [names[tr], names[val], names[te], fold]
            for fold, (tr, val, te) in enumerate(_rotation_splits(self.len_data, self.n_splits))
        ]


def _axis_intervals(extent, psize, min_overlap):
    """(start, end) float intervals tiling one axis with >= min_overlap."""
    n = int(np.ceil(extent / psize))
    if n == 1:
        return [(0, extent)]
    stride = (extent - psize) / (n - 1)
    if psize - stride < min_overlap:
        n += 1
        stride = (extent - psize) / (n - 1)
    centers = np.round(psize / 2 + stride * np.arange(n))
    half = psize / 2
    return [(c - half, c + half) for c in centers]


def get_patch_crop_coords(img, patch_size, min_overlap=30):
    """Overlapping patch grid over an image; (n_patches, 2*dim) int coords.

    Outer patches pinned at the borders, inner centers evenly spaced; an
    extra patch is inserted per axis when overlap would fall below
    ``min_overlap``. patch_size z == 1 emits one patch per slice
    (2D-on-3D mode). Order: y-major, then x, then z.
    """
    intervals = [_axis_intervals(e, p, min_overlap) for e, p in zip(img.shape, patch_size)]
    is_3d = len(intervals) == 3
    boxes = []
    for (y0, y1), (x0, x1) in itertools.product(intervals[0], intervals[1]):
        if not is_3d:
            boxes.append((y0, y1, x0, x1))
        elif patch_size[2] == 1:
            boxes.extend((y0, y1, x0, x1, z, z + 1) for z in range(img.shape[2]))
        else:
            boxes.extend((y0, y1, x0, x1, z0, z1) for z0, z1 in intervals[2])
    return np.array(boxes).astype(int)


def pad_nd_image(image, new_shape=None, mode="edge", kwargs=None, return_slicer=False, shape_must_be_divisible_by=None):
    """Pad trailing axes to a minimum shape and/or divisibility constraint.

    new_shape applies to the LAST len(new_shape) axes; axes are never cropped
    (new_shape is a minimum). Padding splits evenly, extra pixel above. With
    return_slicer, also returns slices that crop the result back to the
    original shape.
    """
    kwargs = kwargs or {}
    div = shape_must_be_divisible_by
    if new_shape is None:
        assert div is not None
        assert isinstance(div, (list, tuple, np.ndarray))
        new_shape = image.shape[-len(div) :]

    tail = np.asarray(image.shape[-len(new_shape) :], dtype=np.int64)
    target = np.maximum(np.asarray(new_shape, dtype=np.int64), tail)
    if div is not None:
        if not isinstance(div, (list, tuple, np.ndarray)):
            div = [div] * len(target)
        assert len(div) == len(target)
        div = np.asarray(div, dtype=np.int64)
        target = -(-target // div) * div  # round up; exact multiples unchanged

    lead = image.ndim - len(target)
    diff = target - tail
    below = diff // 2
    pad_widths = [(0, 0)] * lead + [(int(b), int(d - b)) for b, d in zip(below, diff)]
    padded = np.pad(image, pad_widths, mode, **kwargs)
    if not return_slicer:
        return padded
    slicer = [slice(lo, size - hi) for (lo, hi), size in zip(pad_widths, padded.shape)]
    return padded, slicer


def get_case_identifiers(folder):
    return [i[:-4] for i in os.listdir(folder) if i.endswith("npz")]


def convert_to_npy(npz_file):
    """``{id}.npz`` (holding the array under the key ``id``) -> ``{id}.npy``
    beside it, unless that exists."""
    identifier = os.path.split(npz_file)[1][:-4]
    if not os.path.isfile(npz_file[:-4] + ".npy"):
        a = np.load(npz_file)[identifier]
        np.save(npz_file[:-4] + ".npy", a)


def unpack_dataset(folder, threads=8):
    """Every ``.npz`` in ``folder`` unpacked to ``.npy``."""
    npz_files = [os.path.join(folder, i + ".npz") for i in get_case_identifiers(folder)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(convert_to_npy, npz_files))


def pack_dataset(folder, threads=8):
    """Every ``{id}.npy`` in ``folder`` packed to a compressed ``{id}.npz``
    beside it (the array under the key ``id``), unless that exists."""

    def pack_one(npy_file):
        identifier = os.path.split(npy_file)[1][:-4]
        npz_file = npy_file[:-4] + ".npz"
        if not os.path.isfile(npz_file):
            np.savez_compressed(npz_file, **{identifier: np.load(npy_file)})

    npy_files = [os.path.join(folder, i) for i in os.listdir(folder) if i.endswith(".npy")]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(pack_one, npy_files))


def delete_npy(folder):
    """Remove the ``.npy`` of every ``.npz`` in ``folder`` (after packing)."""
    for ident in get_case_identifiers(folder):
        f = os.path.join(folder, ident + ".npy")
        if os.path.isfile(f):
            os.remove(f)


def dataframe_pickle(rows, columns):
    """Pickle bytes that unpickle to ``pandas.DataFrame(rows, None,
    columns)``: a reference to the class, then the pickled arguments, then
    REDUCE (the call). Nothing of pandas is imported to write them."""
    args = pickle.dumps((rows, None, columns), protocol=2)  # PROTO 2 ... STOP
    return b"\x80\x02cpandas.core.frame\nDataFrame\n" + args[2:-1] + pickle.REDUCE + pickle.STOP
