"""The port's augmentation against the JAX package's, on the CPU.

``mirror_batch``, ``center_crop_batch`` and ``spatial_augment_batch`` (2D and
3D, elastic deformation on and off, a uint8 seg and one with labels above
255, which takes scipy's order-0 path) give the same arrays from the same
``RandomState``: with the native host library on both sides, and again with
it off on both sides (``MDT_NO_NATIVE=1`` for the port, JAX's ``get_lib``
patched to None). Exact: the same code on the same inputs, and the same
random draws in the same order (the RNG states are compared too).
"""

import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu import native as jnative  # noqa: E402
from medicaldetectiontoolkit_tpu.data import augmentation as jaug  # noqa: E402
from medicaldetectiontoolkit_torch import native  # noqa: E402
from medicaldetectiontoolkit_torch.data import augmentation as taug  # noqa: E402

# the LIDC configs' augmentation (experiments/lidc_exp/configs.py), 2D and 3D
DA_2D = {
    "do_elastic_deform": True, "alpha": (0.0, 1500.0), "sigma": (30.0, 50.0),
    "do_rotation": True, "angle_x": (0.0, 2 * np.pi), "angle_y": (0.0, 0), "angle_z": (0.0, 0),
    "do_scale": True, "scale": (0.8, 1.1), "random_crop": False, "border_mode_data": "constant",
    "border_cval_data": 0, "order_data": 1,
}
DA_3D = dict(DA_2D, do_elastic_deform=False, angle_x=(0, 0.0), angle_y=(0, 0.0), angle_z=(0.0, 2 * np.pi))


@pytest.fixture(params=["native", "no_native"])
def native_mode(request, monkeypatch):
    if request.param == "no_native":
        monkeypatch.setenv("MDT_NO_NATIVE", "1")
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None and jnative.get_lib() is not None
    return request.param


def _batch(seed, bsz, ch, spatial, seg_dtype=np.uint8, max_label=3):
    rng = np.random.RandomState(seed)
    data = rng.rand(bsz, ch, *spatial).astype(np.float32)
    seg = np.zeros((bsz, 1, *spatial), seg_dtype)
    for b in range(bsz):
        lo = [rng.randint(0, s // 2) for s in spatial]
        sl = tuple(slice(lo_d, lo_d + max(2, s // 3)) for lo_d, s in zip(lo, spatial))
        seg[(b, 0) + sl] = rng.randint(1, max_label + 1)
    return data, seg


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_rng(r1, r2):
    s1, s2 = r1.get_state(), r2.get_state()
    assert np.array_equal(s1[1], s2[1]) and s1[2:] == s2[2:]


@pytest.mark.parametrize("spatial", [(12, 10), (8, 10, 6)])
def test_mirror_batch_matches_jax(spatial):
    data, seg = _batch(0, 4, 2, spatial)
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    out_t = taug.mirror_batch(data.copy(), seg.copy(), r1)
    out_j = jaug.mirror_batch(data.copy(), seg.copy(), r2)
    for a, b in zip(out_t, out_j):
        _same(a, b)
    _same_rng(r1, r2)


@pytest.mark.parametrize("spatial,patch", [((12, 10), (8, 14)), ((9, 10, 6), (6, 12, 4)), ((8, 8, 8), (8, 8, 8))])
def test_center_crop_batch_matches_jax(spatial, patch):
    data, seg = _batch(1, 3, 1, spatial)
    for a, b in zip(taug.center_crop_batch(data, seg, patch), jaug.center_crop_batch(data, seg, patch)):
        _same(a, b)


@pytest.mark.parametrize("dim,elastic,seg_dtype,max_label", [
    (2, True, np.uint8, 3),
    (2, False, np.int32, 300),
    (3, False, np.uint8, 2),
    (3, True, np.int64, 1000),
])
def test_spatial_augment_batch_matches_jax(native_mode, dim, elastic, seg_dtype, max_label):
    pre_crop, patch = ((44, 40), (32, 32)) if dim == 2 else ((40, 38, 12), (32, 32, 8))
    da = dict(DA_2D if dim == 2 else DA_3D, do_elastic_deform=elastic)
    data, seg = _batch(10 * dim + elastic, 3, 2, pre_crop, seg_dtype, max_label)
    r1, r2 = np.random.RandomState(5), np.random.RandomState(5)
    out_d, out_s = taug.spatial_augment_batch(data, seg, patch, da, r1)
    ref_d, ref_s = jaug.spatial_augment_batch(data, seg, patch, da, r2)
    _same(out_d, ref_d)
    _same(out_s, ref_s)
    _same_rng(r1, r2)
    assert out_d.shape == (3, 2, *patch) and np.abs(out_d).sum() > 0
    assert (out_s > 0).any() and out_s.max() <= max_label


@pytest.mark.parametrize("dim", [2, 3])
def test_sample_coords_matches_jax(native_mode, dim):
    """The sampling grid alone, fused (native) or NumPy, with elastic on."""
    patch = [16, 12] if dim == 2 else [10, 12, 6]
    da = dict(DA_2D if dim == 2 else DA_3D, do_elastic_deform=True)
    center = [s / 2.0 + 2.5 for s in patch]
    r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
    _same(taug._sample_coords(patch, da, r1, center), jaug._sample_coords(patch, da, r2, center))
    _same_rng(r1, r2)
