"""The port's raw-scan preprocessing of LIDC and PET-CT against the JAX
package's, on the CPU. Exact throughout.

Neither SimpleITK nor pynrrd is installed, so this file defines one
stand-in for both: an image is an array with a spacing, an origin and a
direction, stored as ``.npz`` under the raw data's file names; ``Resample``
is nearest-neighbour on the physical grid, zero outside. Both packages'
modules import the two lazily, so the stand-in (installed in
``sys.modules``) serves the JAX code and the port alike, and the two run the
same reads:
  * ``resample_array`` on zoom factors above and below 1, a spacing whose
    rounding to 3 decimals changes the shape, int16 CT and uint8 masks;
  * LIDC ``pp_patient`` on four raw patients (nodules of 1, 2, 3 and 4
    raters, a rater scoring -1 and one with no score, nodules suppressed,
    a patient with no nodule): byte-equal ``.npy`` files, equal meta
    pickles and ``suppressed_rois.txt``; ``aggregate_meta_info``'s
    ``info_df.pickle`` equal to JAX's frame under pandas; each package's
    ``load_dataset`` reads the other's directory;
  * PET-CT ``pp_patient`` on three raw patients (the CT resampled or not,
    3D and 4D seg data, background categories, a lung crop that cuts z),
    likewise, and the loaders;
  * both CLIs' raw branches (``runpy``, the thread pools) give JAX's files;
  * without SimpleITK or pynrrd the port raises JAX's ``ImportError``.
"""

import collections
import os
import pickle
import runpy
import shutil
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.lidc_exp import data_loader as jax_lidc_dl  # noqa: E402
from experiments.lidc_exp import preprocessing as jax_lidc  # noqa: E402
from experiments.pet_ct_tnm_classification import data_loader as jax_petct_dl  # noqa: E402
from experiments.pet_ct_tnm_classification import preprocessing as jax_petct  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as port_lidc_dl  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import preprocessing as port_lidc  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import data_loader as port_petct_dl  # noqa: E402,E501
from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import preprocessing as port_petct  # noqa: E402,E501
from medicaldetectiontoolkit_torch.testing import assert_same  # noqa: E402

IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
PIXEL_IDS = {"uint8": 1, "int16": 2, "float32": 8, "float64": 9}


# ---------------------------------------------------------------------------
# the stand-in for SimpleITK and pynrrd


class _Image:
    """An array (z, y, x) with SimpleITK's (x, y, z) spacing, origin and
    direction."""

    def __init__(self, arr, spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0), direction=IDENTITY):
        self.arr = arr
        self.SetSpacing(spacing)
        self.SetOrigin(origin)
        self.SetDirection(direction)

    def GetSpacing(self):
        return self.spacing

    def SetSpacing(self, spacing):
        self.spacing = tuple(float(v) for v in spacing)

    def GetOrigin(self):
        return self.origin

    def SetOrigin(self, origin):
        self.origin = tuple(float(v) for v in origin)

    def GetDirection(self):
        return self.direction

    def SetDirection(self, direction):
        self.direction = tuple(float(v) for v in direction)

    def GetSize(self):
        return tuple(int(n) for n in self.arr.shape[::-1])

    def GetPixelIDValue(self):
        return PIXEL_IDS[self.arr.dtype.name]


def _resample(img, ref):
    """``img`` on ``ref``'s grid: nearest neighbour in physical space, 0
    outside ``img``."""
    assert img.direction == ref.direction == IDENTITY
    axes = []
    for a in range(3):  # x, y, z
        points = ref.origin[a] + ref.spacing[a] * np.arange(ref.GetSize()[a])
        ix = np.floor((points - img.origin[a]) / img.spacing[a] + 0.5).astype(np.int64)
        inside = (ix >= 0) & (ix < img.GetSize()[a])
        axes.append((ix, inside))
    (ix, vx), (iy, vy), (iz, vz) = axes
    out = np.zeros(ref.arr.shape, img.arr.dtype)
    out[np.ix_(vz, vy, vx)] = img.arr[np.ix_(iz[vz], iy[vy], ix[vx])]
    return _Image(out, ref.spacing, ref.origin, ref.direction)


class _ResampleImageFilter:
    def SetReferenceImage(self, ref):
        self.ref = ref

    def Execute(self, img):
        return _resample(img, self.ref)


def _read_image(path):
    with np.load(path) as z:
        return _Image(z["arr"], tuple(z["spacing"]), tuple(z["origin"]), tuple(z["direction"]))


def _write_image(path, arr, spacing, origin=(0.0, 0.0, 0.0)):
    with open(path, "wb") as handle:
        np.savez(handle, arr=arr, spacing=np.array(spacing, float), origin=np.array(origin, float),
                 direction=np.array(IDENTITY))


def _nrrd_read(path):
    """(data, header) of a stand-in ``.seg.nrrd``: the header's keys in
    their written order."""
    with np.load(path, allow_pickle=True) as z:
        header = collections.OrderedDict(z["header"].item())
        return z["data"], header


def _write_seg(path, data, space_directions, space_origin, names):
    header = [("type", "unsigned char"), ("dimension", data.ndim), ("space directions", space_directions),
              ("space origin", np.array(space_origin, float))]
    header += [(f"Segment{i}_Name", name) for i, name in enumerate(names)]
    with open(path, "wb") as handle:
        np.savez(handle, data=data, header=np.array(collections.OrderedDict(header), dtype=object))


def _stand_ins():
    sitk = types.ModuleType("SimpleITK")
    sitk.Image = lambda size, pixel_id: _Image(
        np.zeros(tuple(size)[::-1], {v: k for k, v in PIXEL_IDS.items()}[pixel_id]))
    sitk.ReadImage = _read_image
    sitk.GetArrayFromImage = lambda img: img.arr.copy()
    sitk.GetImageFromArray = lambda arr: _Image(np.array(arr))
    sitk.Resample = _resample
    sitk.ResampleImageFilter = _ResampleImageFilter
    nrrd = types.ModuleType("nrrd")
    nrrd.read = _nrrd_read
    return sitk, nrrd


@pytest.fixture
def readers(monkeypatch):
    sitk, nrrd = _stand_ins()
    monkeypatch.setitem(sys.modules, "SimpleITK", sitk)
    monkeypatch.setitem(sys.modules, "nrrd", nrrd)


# ---------------------------------------------------------------------------
# raw data


def _ball(shape, center, radii):
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    return sum((g - c) ** 2 / r**2 for g, c, r in zip((zz, yy, xx), center, radii)) < 1


# LIDC: pid -> (CT shape (z, y, x), spacing (x, y, z), nodules). A nodule:
# (roi id, center, radius in voxels, its raters' (nodule id, shift in x) pairs).
LIDC_PATIENTS = {
    "LIDC-IDRI-0001": ((10, 40, 40), (0.7, 0.7, 2.5), [
        ("1", (4, 14, 14), 3.0, [(11, 0), (21, 1), (31, 0), (41, -1)]),   # four raters, one scoring -1
        ("2", (6, 26, 27), 2.5, [(12, 0), (22, 0), (32, 1)]),             # three, one with no score
    ]),
    "LIDC-IDRI-0002": ((9, 36, 38), (0.6996, 0.6996, 2.2496), [
        ("1", (4, 12, 20), 3.0, [(13, 0), (23, 1)]),                      # two raters who agree
        ("2", (5, 26, 12), 2.5, [(14, 0)]),                               # one rater: suppressed
        ("3", (3, 27, 28), 2.0, [(15, -3), (25, 3)]),                     # two who disagree: suppressed
    ]),
    "LIDC-IDRI-0003": ((8, 32, 36), (0.75, 0.75, 2.5), []),               # no nodule
    "LIDC-IDRI-0004": ((11, 38, 34), (0.6836, 0.6836, 2.0), [
        ("7", (5, 18, 16), 3.5, [(16, 0), (26, 0), (36, 1), (46, 0)]),
    ]),
}
MALIGNANCY = {11: "4", 21: "5", 31: "3", 41: "-1", 12: "2", 22: "", 32: "3", 13: "4", 23: "3", 14: "5",
              15: "2", 25: "3", 16: "1", 26: "2", 36: "1", 46: "2"}


def _write_lidc_raw(root):
    """Raw LIDC patients under ``root/data_nrrd`` and ``root/characteristics.csv``."""
    rng = np.random.RandomState(3)
    rows = ["PatientID;NoduleID;Malignancy;Spiculation", "LIDC-IDRI-0009;11;1;1"]  # another patient's nodule 11
    for pid, (shape, spacing, nodules) in LIDC_PATIENTS.items():
        d = os.path.join(root, "data_nrrd", pid)
        os.makedirs(d)
        ct = (rng.randn(*shape) * 60 - 700).astype(np.int16)
        ct[:, :3] = -1400  # below the clip
        for roi, center, r, raters in nodules:
            ct[_ball(shape, center, (r / 2, r, r))] = 40
            for rater, (nid, shift) in enumerate(raters):
                mask = _ball(shape, (center[0], center[1], center[2] + shift), (r / 2, r, r)).astype(np.uint8)
                _write_image(os.path.join(d, f"{pid}_r{rater}_{nid:04d}_{roi}.nii.gz"), mask, spacing)
                rows.append(f"{pid};{nid};{MALIGNANCY[nid]};1")
        _write_image(os.path.join(d, f"{pid}_ct_scan.nrrd"), ct, spacing)
    with open(os.path.join(root, "characteristics.csv"), "w") as handle:
        handle.write("\n".join(rows) + "\n")


def _ct_hu(shape, rng, z_lungs):
    """A chest CT (z, y, x) in HU (int16): soft tissue, air above and below
    the body (border components), two lungs of air over ``z_lungs``."""
    nz, ny, nx = shape
    ct = (rng.randn(*shape) * 20 + 40).astype(np.int16)
    ct[:, :6] = ct[:, -6:] = -1000
    y0, y1 = ny // 4, 3 * ny // 4
    for x0, x1 in ((int(nx * 0.12), int(nx * 0.45)), (int(nx * 0.55), int(nx * 0.88))):
        ct[z_lungs[0]:z_lungs[1], y0:y1, x0:x1] = -1000 + (rng.randn(z_lungs[1] - z_lungs[0], y1 - y0, x1 - x0) * 30)
    return ct


# PET-CT: directory -> (CT shape, CT spacing, lung z range, PET spacing, PET origin shift (mm),
# seg spacing signs, seg names (a list of one: 3D data)).
PETCT_PATIENTS = {
    "TNM/a/lsa_0001": ((60, 128, 128), (0.8, 0.8, 2.5), (20, 40), (2.0, 2.0, 3.27), (0.0, 0.0, 0.0),
                       (-1, -1, 1), ["lesion=1", "other=T_benign", "node=2"]),
    "TNM/b/lsa_0002": ((50, 112, 112), (1.0, 1.0, 3.27), (15, 32), (2.5, 2.5, 3.27), (4.0, -3.0, 0.0),
                       (1, 1, 1), ["tumour=3"]),
    "TNM/c/lsa_0003": ((48, 100, 100), (1.2, 1.2, 2.0), (12, 36), (2.4, 2.4, 4.0), (0.0, 0.0, 6.0),
                       (1, -1, 1), ["N_inflammation"]),
}


def _write_petct_raw(raw_dir):
    rng = np.random.RandomState(5)
    for rel, (shape, spacing, z_lungs, pet_spacing, pet_shift, signs, names) in PETCT_PATIENTS.items():
        d = os.path.join(raw_dir, rel)
        os.makedirs(d)
        origin = (-shape[2] * spacing[0] / 2, -shape[1] * spacing[1] / 2, 0.0)
        ct = _ct_hu(shape, rng, z_lungs)
        _write_image(os.path.join(d, "lsa_ct.nii.gz"), ct, spacing, origin)
        extent = [n * s for n, s in zip(shape[::-1], spacing)]
        pet_size = [int(e / s) for e, s in zip(extent, pet_spacing)]
        pet = rng.rand(*pet_size[::-1]).astype(np.float32)
        pet[_ball(pet.shape, [n // 2 for n in pet.shape], [n / 6 for n in pet.shape])] += 5
        _write_image(os.path.join(d, "lsa_pet.nii.gz"), pet, pet_spacing,
                     [o + s for o, s in zip(origin, pet_shift)])
        # the seg on the CT's grid, (x, y, z) per layer as pynrrd reads it
        mid = (z_lungs[0] + z_lungs[1]) // 2
        layers = []
        for i in range(len(names)):
            center = (mid + 3 * i - 3, shape[1] // 2 + 4 * i, shape[2] // 3 + 20 * i)
            layers.append(np.transpose(_ball(shape, center, (3, 6, 6)), (2, 1, 0)).astype(np.uint8))
        directions = np.diag([sg * s for sg, s in zip(signs, spacing)])
        seg_origin = np.array(origin) * np.array(signs)
        if len(names) == 1:
            _write_seg(os.path.join(d, "lsa.seg.nrrd"), layers[0], directions, seg_origin, names)
        else:
            directions = np.concatenate([np.full((1, 3), np.nan), directions])
            _write_seg(os.path.join(d, "lsa.seg.nrrd"), np.stack(layers), directions, seg_origin, names)
        (open(os.path.join(d, "notes.txt"), "w")).close()
    os.makedirs(os.path.join(raw_dir, "other", "lsa_0009"))  # no TNM on the path: not collected
    _write_image(os.path.join(raw_dir, "other", "lsa_0009", "lsa_pet.nii.gz"), np.zeros((2, 2, 2), np.float32),
                 (1, 1, 1))


# ---------------------------------------------------------------------------
# comparisons


def _assert_same_dirs(port_dir, jax_dir):
    """The same files; ``.npy`` and text byte-equal, meta pickles equal;
    each index a frame whose rows are its directory's meta files in
    ``os.listdir`` order, and the two frames equal up to that order."""
    files = sorted(os.listdir(port_dir))
    assert files == sorted(os.listdir(jax_dir))
    for f in files:
        a, b = os.path.join(port_dir, f), os.path.join(jax_dir, f)
        if f.endswith(".npy") or f.endswith(".txt"):
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), f
        elif f.startswith("meta_info"):
            with open(a, "rb") as x, open(b, "rb") as y:
                assert_same(pickle.load(x), pickle.load(y), f)
    frames = []
    for d in (port_dir, jax_dir):
        df = pd.read_pickle(os.path.join(d, "info_df.pickle"))
        order = [f[len("meta_info_"):-len(".pickle")] for f in os.listdir(d) if "meta_info" in f]
        assert [str(p) for p in df.pid] == order
        frames.append(df.sort_values("pid", key=lambda s: s.astype(str)).reset_index(drop=True))
    pd.testing.assert_frame_equal(frames[0], frames[1])
    return files


def _cf(root, pp_dir, **kw):
    return SimpleNamespace(root_dir=root, raw_data_dir=os.path.join(root, "data_nrrd"), pp_dir=pp_dir,
                           target_spacing=(0.7, 0.7, 1.25), **kw)


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("shape,dtype,spacing,target", [
    ((6, 10, 12), np.int16, (0.7, 0.7, 2.5), (0.7, 0.7, 1.25)),      # z zoomed up 2x
    ((10, 20, 18), np.float32, (0.5, 0.6, 1.0), (0.7, 0.7, 1.25)),   # every axis zoomed down
    ((7, 30, 30), np.int16, (0.6996, 0.6996, 1.2496), (0.7, 0.7, 1.25)),  # rounding keeps 30 and 7
    ((8, 16, 16), np.uint8, (0.8, 0.8, 2.0), (0.7, 0.7, 1.25)),      # a binary mask
    ((5, 9, 11), np.uint8, (1.3, 0.9, 3.0), (0.7, 0.7, 1.25)),
])
def test_resample_array_matches_jax(shape, dtype, spacing, target):
    rng = np.random.RandomState(sum(shape))
    src = (rng.rand(*shape) > 0.6) if dtype == np.uint8 else rng.randn(*shape) * 300
    src = src.astype(dtype)
    got, want = port_lidc.resample_array(src, spacing, target), jax_lidc.resample_array(src, spacing, target)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes() and got.shape == want.shape
    if spacing[0] == 0.6996:
        assert got.shape == shape  # unrounded, int() would give 6 x 29 x 29
        assert int(30 * spacing[0] / target[0]) == 29


def test_normalize_ct_and_fuse_masks_on_arrays():
    """The array helpers give ``_load_normalized_ct``'s and
    ``_fuse_one_nodule``'s arithmetic: float32 z-scores of the clipped
    resample; a vote over four slots, scores above -1 averaged with the
    absent raters' zeros."""
    rng = np.random.RandomState(0)
    ct = (rng.randn(6, 12, 10) * 500).astype(np.int16)
    img = port_lidc.normalize_ct(ct, (0.7, 0.7, 2.5), (0.7, 0.7, 1.25))
    ref = np.clip(jax_lidc.resample_array(ct, (0.7, 0.7, 2.5), (0.7, 0.7, 1.25)), -1200, 600).astype(np.float32)
    assert img.dtype == np.float32 and img.tobytes() == ((ref - ref.mean()) / ref.std()).tobytes()
    mask = np.zeros((6, 12, 10), np.uint8)
    mask[2:4, 3:8, 3:8] = 1
    fused, mal = port_lidc.fuse_masks([(mask, (0.7, 0.7, 2.5))] * 2, [4, -1], (0.7, 0.7, 1.25), img.shape)
    assert fused.dtype == bool and fused.sum() > 0 and mal == np.mean([4, 0, 0])
    fused, _ = port_lidc.fuse_masks([(mask, (0.7, 0.7, 2.5))], [3], (0.7, 0.7, 1.25), img.shape)
    assert not fused.any()


@pytest.fixture
def lidc_dirs(tmp_path, readers):
    """Four raw patients preprocessed by each package, one by one in
    sorted order, then indexed."""
    root = str(tmp_path)
    _write_lidc_raw(root)
    out = {}
    for name, module in (("port", port_lidc), ("jax", jax_lidc)):
        cf = _cf(root, os.path.join(root, name))
        os.makedirs(cf.pp_dir)
        for ix, pid in enumerate(sorted(LIDC_PATIENTS)):
            module.pp_patient((ix, os.path.join(cf.raw_data_dir, pid)), cf)
        out[name] = (cf.pp_dir, module.aggregate_meta_info(cf.pp_dir))
    return out


def test_lidc_pp_patient_matches_jax(lidc_dirs):
    (port, rows), (jax, df) = lidc_dirs["port"], lidc_dirs["jax"]
    files = _assert_same_dirs(port, jax)
    assert len(files) == 3 * 4 + 2  # three files per patient, the index, suppressed_rois.txt
    # the index's rows are the ones returned
    assert_same([list(r) for r in pd.read_pickle(os.path.join(port, "info_df.pickle")).itertuples(index=False)],
                rows)
    pd.testing.assert_frame_equal(pd.read_pickle(os.path.join(jax, "info_df.pickle")), df)
    metas = {}
    for pid in LIDC_PATIENTS:
        with open(os.path.join(port, f"meta_info_{pid}.pickle"), "rb") as handle:
            metas[pid] = pickle.load(handle)
    # the cases: -1 and the empty score left out, the absent raters' zeros counted
    assert_same(metas["LIDC-IDRI-0001"]["class_target"], np.array([(4 + 5 + 3) / 3, (2 + 3 + 0) / 3]))
    assert_same(metas["LIDC-IDRI-0002"]["class_target"], np.array([(4 + 3 + 0 + 0) / 4]))
    assert_same(metas["LIDC-IDRI-0003"], {"pid": "LIDC-IDRI-0003", "class_target": np.array([]),
                                          "spacing": (0.75, 0.75, 2.5), "fg_slices": []})
    assert metas["LIDC-IDRI-0002"]["spacing"] == (0.6996, 0.6996, 2.2496)
    with open(os.path.join(port, "suppressed_rois.txt")) as handle:
        assert [sorted(line.split()) for line in handle] == [
            ["LIDC-IDRI-0002_r0_0014_2.nii.gz"], ["LIDC-IDRI-0002_r0_0015_3.nii.gz", "LIDC-IDRI-0002_r1_0025_3.nii.gz"]]
    rois = np.load(os.path.join(port, "LIDC-IDRI-0001_rois.npy"))
    img = np.load(os.path.join(port, "LIDC-IDRI-0001_img.npy"))
    assert rois.dtype == np.uint8 and sorted(np.unique(rois)) == [0, 1, 2] and img.shape == rois.shape == (20, 40, 40)
    assert metas["LIDC-IDRI-0001"]["fg_slices"] == [int(z) for z in np.unique(np.nonzero(rois)[0])]


@pytest.mark.parametrize("data", ["port", "jax"])
def test_lidc_loaders_read_either_directory(lidc_dirs, data):
    path = lidc_dirs[data][0]
    cf = SimpleNamespace(pp_data_path=path, input_df_name="info_df.pickle", select_prototype_subset=None,
                         server_env=False, data_dest=None)
    t, j = port_lidc_dl.load_dataset(cf, _Log()), jax_lidc_dl.load_dataset(cf, _Log())
    assert list(t.items()) == list(j.items()) and len(t) == 4
    assert list(t) == pd.read_pickle(os.path.join(path, "info_df.pickle")).pid.tolist()
    assert t["LIDC-IDRI-0001"]["class_target"] == [1, 0] and t["LIDC-IDRI-0003"]["class_target"] == []


@pytest.fixture
def petct_dirs(tmp_path, readers):
    raw = str(tmp_path / "raw")
    _write_petct_raw(raw)
    paths = port_petct.collect_paths(raw)
    assert paths == jax_petct.collect_paths(raw) and len(paths) == 3
    out = {}
    for name, module in (("port", port_petct), ("jax", jax_petct)):
        cf = SimpleNamespace(pp_dir=str(tmp_path / name))
        os.makedirs(cf.pp_dir)
        for inputs in enumerate(sorted(paths)):
            module.pp_patient(inputs, cf)
        out[name] = (cf.pp_dir, module.aggregate_meta_info(cf.pp_dir))
    return out


def test_petct_pp_patient_matches_jax(petct_dirs):
    port, jax = petct_dirs["port"][0], petct_dirs["jax"][0]
    assert len(_assert_same_dirs(port, jax)) == 3 * 3 + 1
    metas = port_petct.read_meta_info(port)
    by_pid = {m["pid"]: m for m in metas}
    assert_same(by_pid[0]["class_target"], ["1", "2"])  # T_benign dropped
    assert_same(by_pid[1]["class_target"], ["3"])
    assert_same(by_pid[2], {"pid": 2, "raw_pid": "lsa_0003", "class_target": [], "fg_slices": []})
    shapes = {}
    for pid in range(3):
        img, rois = np.load(os.path.join(port, f"{pid}_img.npy")), np.load(os.path.join(port, f"{pid}_rois.npy"))
        assert img.dtype == np.float32 and img.shape[0] == 2 and img.shape[1:] == rois.shape
        assert set(np.unique(rois)) <= {0, 1} and rois.dtype == np.uint8
        shapes[pid] = rois.shape
    # patient 0 resampled to (0.976562, 0.976562, 3.27) and cropped in z, patient 1 on its own grid and cropped,
    # patient 2 resampled (z spacing below 3)
    assert shapes[0][1:] == (104, 104) and shapes[0][0] < int(60 * 2.5 / 3.27)
    assert shapes[1][1:] == (112, 112) and shapes[1][0] < 50
    assert shapes[2][1:] == (122, 122)
    assert by_pid[0]["fg_slices"] and by_pid[1]["fg_slices"]


@pytest.mark.parametrize("data", ["port", "jax"])
def test_petct_loaders_read_either_directory(petct_dirs, tmp_path, data):
    path = petct_dirs[data][0]
    cf = SimpleNamespace(pp_data_path=path, input_df_name="info_df.pickle", select_prototype_subset=None)
    t, j = port_petct_dl.load_dataset(cf, _Log()), jax_petct_dl.load_dataset(cf, _Log())
    assert list(t.items()) == list(j.items()) and len(t) == 3
    assert list(t) == pd.read_pickle(os.path.join(path, "info_df.pickle")).pid.tolist()
    assert t[0]["class_target"] == [1, 2]


def _run_cli(path, env, monkeypatch, argv=()):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")


@pytest.mark.parametrize("exp", ["lidc", "petct"])
def test_cli_raw_branch_matches_jax(tmp_path, readers, monkeypatch, exp):
    """Each CLI without ``--synthetic`` preprocesses every raw patient of
    ``cf.raw_data_dir`` in a thread pool and indexes ``cf.pp_dir``: run
    JAX's, move its output aside, run the port's on the same raw data."""
    root = str(tmp_path)
    if exp == "lidc":
        _write_lidc_raw(root)
        env, n = {"MDT_LIDC_ROOT": root}, len(LIDC_PATIENTS)
        jax_cli, port_cli = os.path.join(REPO, "experiments", "lidc_exp", "preprocessing.py"), port_lidc.__file__
    else:
        _write_petct_raw(os.path.join(root, "LungStageData"))
        env, n = {"MDT_PETCT_ROOT": root}, len(PETCT_PATIENTS)
        jax_cli = os.path.join(REPO, "experiments", "pet_ct_tnm_classification", "preprocessing.py")
        port_cli = port_petct.__file__
    pp = os.path.join(root, "pp_norm")
    _run_cli(jax_cli, env, monkeypatch)
    shutil.move(pp, os.path.join(root, "jax"))
    _run_cli(port_cli, env, monkeypatch)
    files = _assert_same_dirs(pp, os.path.join(root, "jax"))
    assert sum(f.startswith("meta_info") for f in files) == n


@pytest.mark.parametrize("exp", ["lidc", "petct"])
def test_cli_synthetic_branch_matches_jax(tmp_path, monkeypatch, exp):
    """``--synthetic --out_dir DIR``: the JAX CLI's patients and index."""
    module = port_lidc if exp == "lidc" else port_petct
    jax_cli = os.path.join(REPO, "experiments", "lidc_exp" if exp == "lidc" else "pet_ct_tnm_classification",
                           "preprocessing.py")
    for name, cli in (("jax", jax_cli), ("port", module.__file__)):
        _run_cli(cli, {}, monkeypatch, ["--synthetic", "--out_dir", str(tmp_path / name), "--n_patients", "2"])
    _assert_same_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("missing,exp", [("SimpleITK", "lidc"), ("SimpleITK", "petct"), ("nrrd", "petct")])
def test_missing_readers_raise_jax_message(tmp_path, readers, monkeypatch, missing, exp):
    monkeypatch.setitem(sys.modules, missing, None)
    port, jax = (port_lidc, jax_lidc) if exp == "lidc" else (port_petct, jax_petct)
    cf = _cf(str(tmp_path), str(tmp_path))
    messages = []
    for module in (port, jax):
        with pytest.raises(ImportError) as err:
            module.pp_patient((0, str(tmp_path / "p")), cf)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and ("SimpleITK" if missing == "SimpleITK" else "pynrrd") in messages[0]
