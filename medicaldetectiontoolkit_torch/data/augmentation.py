"""Geometric data augmentation of the port: mirror, affine (rotation/scale),
elastic.

Counterpart of ``medicaldetectiontoolkit_tpu/data/augmentation.py``, whole,
with the same names, the same random draws in the same order and the same
arithmetic, through the port's native host library
(``medicaldetectiontoolkit_torch/native``). It replaces batchgenerators'
MirrorTransform + SpatialTransform + CenterCropTransform as the reference's
``cf.da_kwargs`` configure them: per-sample random elastic deformation
(gaussian-smoothed displacement fields, alpha/sigma), rotation (angle_x in
2D; angle_x/y/z in 3D) and scaling, applied through ONE ``map_coordinates``
resample (order 1 for data, order 0 for seg, constant 0 border) onto a
center-placed output patch of ``patch_size``, so masks warp with the image
and boxes are drawn afterwards (``seg_to_boxes.py``). Under
``MDT_NO_NATIVE=1`` the resamples and the gaussian run on scipy and the grid
in NumPy.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from medicaldetectiontoolkit_torch import native


def mirror_batch(data: np.ndarray, seg: np.ndarray, rng: np.random.RandomState):
    """Random per-sample, per-axis flips with p=0.5 (batchgenerators Mirror).

    data: (b, c, *spatial); seg: (b, 1, *spatial).
    """
    dim = data.ndim - 2
    for b in range(data.shape[0]):
        for ax in range(dim):
            if rng.rand() < 0.5:
                data[b] = np.flip(data[b], axis=ax + 1)
                seg[b] = np.flip(seg[b], axis=ax + 1)
    return data, seg


def center_crop_batch(data: np.ndarray, seg: np.ndarray, patch_size):
    """Center crop (pad if smaller) to patch_size; (b, c, *sp) -> (b, c, *ps)."""
    out_d = []
    out_s = []
    for b in range(data.shape[0]):
        out_d.append(center_crop(data[b], patch_size))
        out_s.append(center_crop(seg[b], patch_size))
    return np.stack(out_d), np.stack(out_s)


def center_crop(arr: np.ndarray, patch_size):
    """Center crop/pad one (c, *spatial) array to patch_size."""
    spatial = arr.shape[1:]
    slices = [slice(None)]
    pads = [(0, 0)]
    for s, p in zip(spatial, patch_size):
        if s >= p:
            lo = (s - p) // 2
            slices.append(slice(lo, lo + p))
            pads.append((0, 0))
        else:
            slices.append(slice(None))
            lo = (p - s) // 2
            pads.append((lo, p - s - lo))
    out = arr[tuple(slices)]
    if any(p != (0, 0) for p in pads):
        out = np.pad(out, pads, mode="constant")
    return out


def _rotation_matrix_2d(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


def _rotation_matrix_3d(ax_angle, ay_angle, az_angle):
    cx, sx = np.cos(ax_angle), np.sin(ax_angle)
    cy, sy = np.cos(ay_angle), np.sin(ay_angle)
    cz, sz = np.cos(az_angle), np.sin(az_angle)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _sample_transform(patch_size, da_kwargs, rng):
    """Draw one sample's (elastic field, rotation, scale). RNG draw order is
    fixed (alpha, sigma, per-axis noise, angles, scale) so the fused-native
    and NumPy sampling grids see identical transforms."""
    dim = len(patch_size)
    elastic = None
    if da_kwargs.get("do_elastic_deform", False):
        alpha = rng.uniform(*da_kwargs["alpha"])
        sigma = rng.uniform(*da_kwargs["sigma"])
        elastic = np.empty((dim,) + tuple(patch_size), np.float64)
        for d in range(dim):
            noise = rng.uniform(-1, 1, patch_size)
            # native C++ separable FIR (scipy-exact, see native/): the
            # ~100-tap smoothing of a full-patch noise field is the hottest
            # host op of the training input pipeline
            elastic[d] = native.gaussian_filter_constant(noise, sigma) * alpha

    if da_kwargs.get("do_rotation", False):
        if dim == 2:
            rot = _rotation_matrix_2d(rng.uniform(*da_kwargs["angle_x"]))
        else:
            rot = _rotation_matrix_3d(
                rng.uniform(*da_kwargs["angle_x"]),
                rng.uniform(*da_kwargs["angle_y"]),
                rng.uniform(*da_kwargs["angle_z"]),
            )
    else:
        rot = np.eye(dim)

    scale = rng.uniform(*da_kwargs["scale"]) if da_kwargs.get("do_scale", False) else 1.0
    return elastic, rot, scale


def _sample_coords(patch_size, da_kwargs, rng, center_in):
    """Sampling grid for one sample: center-placed output patch transformed
    by elastic + rotation + scale; (dim, *patch) float64 input coords."""
    dim = len(patch_size)
    elastic, rot, scale = _sample_transform(patch_size, da_kwargs, rng)

    fused = native.build_coords(elastic, rot, scale, patch_size, center_in)
    if fused is not None:
        return fused

    # NumPy fallback: same math as the fused C pass
    grids = np.meshgrid(*[np.arange(p, dtype=np.float64) for p in patch_size], indexing="ij")
    coords = np.stack(grids)  # (dim, *patch)
    for d in range(dim):
        coords[d] -= (patch_size[d] - 1) / 2.0
    if elastic is not None:
        coords += elastic
    flat = coords.reshape(dim, -1)
    coords = (rot @ flat).reshape(coords.shape) * scale
    for d in range(dim):
        coords[d] += center_in[d]
    return coords


def spatial_augment_batch(data: np.ndarray, seg: np.ndarray, patch_size, da_kwargs, rng: np.random.RandomState):
    """Elastic/rotation/scale + center placement, one resample per sample.

    data: (b, c, *pre_crop); seg: (b, 1, *pre_crop) ->
    (b, c, *patch_size), (b, 1, *patch_size).
    random_crop=False semantics: output grid centered on the input center.
    """
    bsz, ch = data.shape[:2]
    dim = len(patch_size)
    order_data = da_kwargs.get("order_data", 1)
    cval = da_kwargs.get("border_cval_data", 0)
    out_d = np.zeros((bsz, ch) + tuple(patch_size), dtype=np.float32)
    out_s = np.zeros((bsz, seg.shape[1]) + tuple(patch_size), dtype=seg.dtype)
    center_in = [(data.shape[2 + d] - 1) / 2.0 for d in range(dim)]  # center placement
    for b in range(bsz):
        coords = _sample_coords(patch_size, da_kwargs, rng, center_in)
        for c in range(ch):
            if order_data == 1:
                out_d[b, c] = native.map_coordinates_linear(data[b, c], coords, cval=cval)
            else:  # non-default orders stay on scipy
                out_d[b, c] = ndimage.map_coordinates(
                    data[b, c].astype(np.float64), coords, order=order_data,
                    mode="constant", cval=cval,
                )
        for c in range(seg.shape[1]):
            sl = seg[b, c]
            # the native nearest kernel is uint8-only; labels outside [0, 255]
            # (negative ignore labels, >255 instance ids) would silently wrap
            # through the cast, so such segs stay on the scipy order-0 path
            if sl.dtype == np.uint8 or (
                np.issubdtype(sl.dtype, np.integer) and sl.min() >= 0 and sl.max() <= 255
            ):
                out_s[b, c] = native.map_coordinates_nearest(
                    sl.astype(np.uint8), coords, cval=0
                ).astype(seg.dtype)
            else:
                out_s[b, c] = ndimage.map_coordinates(
                    sl.astype(np.float64), coords, order=0, mode="constant", cval=0
                ).astype(seg.dtype)
    return out_d, out_s
