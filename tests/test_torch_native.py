"""The port's native host library against the JAX package's copy, on the CPU.

Both libraries are built here from the same C++ code with the same flags, so
the six functions must agree array for array: ``map_coordinates_linear``,
``map_coordinates_nearest``, ``gaussian_filter_constant``, ``build_coords``,
``wbc_greedy`` and ``nms_2to3d``. The port's native WBC and ``nms_2to3D``
(through ``predictor.py``'s cutover at 16 boxes) agree with its NumPy loops
within JAX's own 1e-9 (``tests/test_native_wbc.py``). ``MDT_NO_NATIVE=1``
gives scipy / NumPy; a failed build raises with the compiler's output; the
library's file name depends on the host.
"""

import os
import sys

import numpy as np
import pytest
from scipy import ndimage

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu import native as jnative  # noqa: E402
from medicaldetectiontoolkit_torch import native  # noqa: E402
from medicaldetectiontoolkit_torch import predictor as tpred  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    assert jnative.get_lib() is not None, "the JAX package's native library did not build"
    assert native.get_lib() is not None


def _coords(rng, dim, shape, n=3000):
    # beyond the volume (constant border), exact integers and half-way ties
    c = np.stack([rng.uniform(-3.0, shape[d] + 2.0, size=n) for d in range(dim)])
    c[:, :60] = np.round(c[:, :60])
    c[:, 60:120] = np.floor(c[:, 60:120]) + 0.5
    return c


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("dim", [2, 3])
def test_linear_resample_matches_jax(dim):
    rng = np.random.RandomState(dim)
    shape = (13, 17) if dim == 2 else (9, 13, 11)
    src = rng.randn(*shape).astype(np.float32)
    coords = _coords(rng, dim, shape).reshape(dim, 60, 50)
    _same(native.map_coordinates_linear(src, coords, cval=0.7), jnative.map_coordinates_linear(src, coords, cval=0.7))


@pytest.mark.parametrize("dim", [2, 3])
def test_nearest_resample_matches_jax(dim):
    rng = np.random.RandomState(10 + dim)
    shape = (13, 17) if dim == 2 else (9, 13, 11)
    src = rng.randint(0, 255, size=shape).astype(np.uint8)
    coords = _coords(rng, dim, shape)
    out = native.map_coordinates_nearest(src, coords, cval=0)
    _same(out, jnative.map_coordinates_nearest(src, coords, cval=0))
    _same(out, ndimage.map_coordinates(src, coords, order=0, mode="constant", cval=0))


@pytest.mark.parametrize("dim,sigma,dtype", [(2, 3.0, np.float64), (3, 1.5, np.float64), (3, 11.0, np.float32),
                                             (3, 40.0, np.float64)])
def test_gaussian_matches_jax(dim, sigma, dtype):
    rng = np.random.RandomState(20 + dim)
    shape = (40, 36) if dim == 2 else (20, 24, 18)
    arr = rng.uniform(-1, 1, size=shape).astype(dtype)
    out = native.gaussian_filter_constant(arr, sigma)
    _same(out, jnative.gaussian_filter_constant(arr, sigma))
    ref = ndimage.gaussian_filter(arr, sigma, mode="constant", cval=0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 if dtype == np.float64 else 1e-6)


@pytest.mark.parametrize("dim,elastic", [(2, False), (2, True), (3, False), (3, True)])
def test_build_coords_matches_jax(dim, elastic):
    rng = np.random.RandomState(30 + dim)
    patch = [12, 10] if dim == 2 else [8, 10, 6]
    field = rng.uniform(-5, 5, (dim, *patch)) if elastic else None
    q, _ = np.linalg.qr(rng.randn(dim, dim))
    center = [s / 2.0 + 3.25 for s in patch]
    _same(native.build_coords(field, q, 0.9, patch, center), jnative.build_coords(field, q, 0.9, patch, center))


def _dets(rng, n, dim, img=320):
    lo = rng.uniform(0, img - 40, (n, dim))
    hi = np.minimum(lo + rng.uniform(8, 60, (n, dim)), img)
    cols = [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]] + ([lo[:, 2], hi[:, 2]] if dim == 3 else [])
    scores = np.round(rng.uniform(0.01, 1, (n, 1)), 2)  # ties in the greedy order
    return np.concatenate([np.stack(cols, 1), scores, rng.uniform(0.3, 1, (n, 1)), rng.uniform(1, 4, (n, 1))], 1)


@pytest.mark.parametrize("dim,n,thresh,n_ens", [(2, 200, 0.5, 4), (3, 500, 0.3, 8), (3, 37, 1e-5, 5),
                                               (2, 16, 1e-5, 1)])
def test_wbc_matches_jax_and_numpy(dim, n, thresh, n_ens, monkeypatch):
    rng = np.random.RandomState(dim * 100 + n)
    dets = _dets(rng, n, dim)
    pids = np.array([f"0_{rng.randint(4)}_{rng.randint(9)}" for _ in range(n)])
    codes = np.unique(pids, return_inverse=True)[1]
    order = dets[:, -3].argsort()[::-1]
    for a, b in zip(native.wbc_greedy(dets, codes, order, thresh, n_ens),
                    jnative.wbc_greedy(dets, codes, order, thresh, n_ens)):
        _same(a, b)

    native.reset_calls()
    scores, coords = tpred.weighted_box_clustering(dets, pids, thresh, n_ens)
    assert native.calls()["wbc_greedy"] == 1  # the cutover: 16 boxes or more
    monkeypatch.setenv("MDT_NO_NATIVE", "1")
    ref_scores, ref_coords = tpred.weighted_box_clustering(dets, pids, thresh, n_ens)
    assert native.calls()["wbc_greedy"] == 1
    assert len(scores) == len(ref_scores) > 0
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-9)
    np.testing.assert_allclose(coords, ref_coords, rtol=1e-9)


@pytest.mark.parametrize("n,thresh", [(300, 0.1), (1000, 0.35), (40, 1e-5), (16, 0.5)])
def test_nms_2to3d_matches_jax_and_numpy(n, thresh, monkeypatch):
    rng = np.random.RandomState(n)
    dets = np.concatenate([_dets(rng, n, 2)[:, :5], rng.randint(0, 30, (n, 1)).astype(float)], 1)
    order = dets[:, -2].argsort()[::-1]
    for a, b in zip(native.nms_2to3d(dets, order, thresh), jnative.nms_2to3d(dets, order, thresh)):
        _same(a, b)

    native.reset_calls()
    keep, keep_z = tpred.nms_2to3D(dets, thresh)
    assert native.calls()["nms_2to3d"] == 1
    monkeypatch.setenv("MDT_NO_NATIVE", "1")
    ref_keep, ref_z = tpred.nms_2to3D(dets, thresh)
    assert keep == ref_keep
    np.testing.assert_allclose(keep_z, ref_z, rtol=1e-9)


def test_below_cutover_runs_numpy():
    rng = np.random.RandomState(3)
    dets = _dets(rng, 15, 3)
    native.reset_calls()
    tpred.weighted_box_clustering(dets, np.array(["0_0_0"] * 15), 1e-5, 1)
    assert native.calls() == {"wbc_greedy": 0, "nms_2to3d": 0}


def test_no_native_env_runs_scipy(monkeypatch):
    monkeypatch.setenv("MDT_NO_NATIVE", "1")
    assert native.get_lib() is None and not native.enabled()
    rng = np.random.RandomState(5)
    src = rng.randn(9, 13, 11).astype(np.float32)
    coords = _coords(rng, 3, src.shape)
    ref = ndimage.map_coordinates(src.astype(np.float64), coords, order=1, mode="constant", cval=0.0)
    _same(native.map_coordinates_linear(src, coords, cval=0.0), ref.astype(np.float32))
    arr = rng.uniform(-1, 1, (20, 24, 18))
    _same(native.gaussian_filter_constant(arr, 3.0), ndimage.gaussian_filter(arr, 3.0, mode="constant", cval=0))
    assert native.build_coords(None, np.eye(3), 1.0, [4, 4, 4], [2, 2, 2]) is None
    assert native.wbc_greedy(_dets(rng, 20, 3), np.zeros(20, np.int64), np.arange(20), 0.1, 1) is None
    assert native.nms_2to3d(_dets(rng, 20, 2)[:, :6], np.arange(20), 0.1) is None


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "resample.cpp").write_text("int broken(void) { return undeclared_name; }\n")
    (src / "wbc.cpp").write_text("\n")
    monkeypatch.setattr(native, "_HERE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_is_keyed_on_the_host(monkeypatch):
    here = native.library_path()
    assert here == native.build() and here.exists()
    monkeypatch.setattr(native.platform, "node", lambda: "another-host")
    assert native.library_path() != here
    monkeypatch.setattr(native, "_host_target", lambda: "cc1 -march=another-cpu")
    assert native.library_path() != here
