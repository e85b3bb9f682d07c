"""Hold the pyramid RoIAlign kernel K2 bit for bit against the plain PyTorch
pyramid RoIAlign on one CUDA card, and time it at the main path's shapes.

    python3 medicaldetectiontoolkit_torch/tools/time_roi_align.py

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it. To compare two commits on one card, unpack the other one
into a directory, copy this script and ``tools/common.py`` into its
``medicaldetectiontoolkit_torch/tools/``, and run the two copies in turns.

First a probe of how PyTorch divides a float32 tensor by a Python number on
the card (the plain version's ``scale = (hi - lo) * S / crop``): as a
division, or as a product with the float32 reciprocal. Then every case's
float32 crops must equal the plain version's (exit 1 if not): 2D and 3D,
every level, crop 1, clamped and zero-size boxes, bf16 and f16 maps, ragged
RoI counts, boxes on which the two forms of ``scale`` differ and boxes whose
coordinates land on integers and on ``S - 1``, level indices outside the
pyramid, strided maps (a channels-last view, a sliced map), 20,000 RoIs, and
the Mask R-CNN slice's shapes on the LIDC pyramid. For each timed case
(600 RoIs to (7,7,3) x 36 channels, the classify-all pass's launch shape;
4,000 RoIs in float32 and bfloat16; the mask pass's 240 RoIs to (14,14,5))
it prints the CUDA-event time of the launch alone (``prepare`` once, then
``launch``), of the whole wrapper, the host's time per wrapper call, the
plain version's time and the bound, and after all of them the kernel's
device time per launch from ``torch.profiler``; the last line is a JSON
object of them. ``chip_smoke.py`` phase 3b runs the same probe and cases
through ``division_probe`` and ``check_cases``, without the profiler.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

# (lo, hi) box columns of each axis in the (y1, x1, y2, x2, z1, z2) layout
AXIS_COLS = ((0, 2), (1, 3), (4, 5))
# the plain version is run on at most this many RoIs at a time: its
# intermediates grow with R times a level's full rows
PLAIN_CHUNK = 2000


def roi_cases(torch):
    """(name, dim, B, C, level sizes, map dtype, R, crop, timed, variant).
    The variant selects how ``case_inputs`` builds the boxes, levels and
    maps: "" random boxes spanning every level, levels by FPN assignment;
    "adversarial" forced levels, boxes on which the card's and the CPU's
    ``scale`` differ, and boxes on the integer lattice; "bad_levels" some
    level indices -1 and n_levels; "strided" level 0 a channels-last view,
    level 1 a slice of a larger map."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    lidc = [(32, 32, 64), (16, 16, 32), (8, 8, 16), (4, 4, 8)]  # P2..P5 of the 128x128x64 patch
    small3 = [(16, 16, 8), (8, 8, 4), (4, 4, 2), (2, 2, 1)]
    small2 = [(32, 32), (16, 16), (8, 8), (4, 4)]
    return [
        ("2d_every_level", 2, 2, 5, small2, f32, 53, (7, 7), False, ""),
        ("2d_crop1", 2, 2, 5, small2, f32, 37, (1, 1), False, ""),
        ("2d_bf16", 2, 2, 5, small2, bf16, 41, (7, 7), False, ""),
        ("3d_every_level", 3, 3, 6, small3, f32, 61, (7, 7, 3), False, ""),
        ("3d_crop1", 3, 3, 6, small3, f32, 29, (1, 1, 1), False, ""),
        ("3d_crop_z1", 3, 3, 6, small3, f32, 29, (4, 4, 1), False, ""),
        ("3d_bf16", 3, 3, 6, small3, bf16, 67, (14, 14, 5), False, ""),
        ("3d_f16", 3, 3, 6, small3, f16, 67, (7, 7, 3), False, ""),
        ("3d_r1", 3, 3, 6, small3, f32, 1, (7, 7, 3), False, ""),
        ("lidc_classify_4000_f32", 3, 8, 36, lidc, f32, 4000, (7, 7, 3), True, ""),
        ("lidc_mask_240_f32", 3, 8, 36, lidc, f32, 240, (14, 14, 5), True, ""),
        ("lidc_classify_4000_bf16", 3, 8, 36, lidc, bf16, 4000, (7, 7, 3), True, ""),
        ("lidc_mask_240_bf16", 3, 8, 36, lidc, bf16, 240, (14, 14, 5), False, ""),
        # the classify-all pass's launch shape: one chunk of 600 RoIs
        ("lidc_classify_600_f32", 3, 8, 36, lidc, f32, 600, (7, 7, 3), True, ""),
        ("3d_div_adversarial", 3, 8, 36, lidc, f32, 600, (7, 7, 3), False, "adversarial"),
        ("3d_div_adversarial_mask", 3, 8, 36, lidc, bf16, 240, (14, 14, 5), False, "adversarial"),
        ("2d_div_adversarial", 2, 2, 5, small2, f32, 300, (7, 7), False, "adversarial"),
        ("3d_levels_out_of_range", 3, 3, 6, small3, f32, 61, (7, 7, 3), False, "bad_levels"),
        ("3d_strided_maps", 3, 3, 6, small3, f32, 67, (7, 7, 3), False, "strided"),
        ("lidc_strided_maps_bf16", 3, 8, 36, lidc, bf16, 600, (7, 7, 3), False, "strided"),
        # past one wave of blocks (4 per SM on 132 SMs)
        ("lidc_classify_20000_f32", 3, 8, 36, lidc, f32, 20000, (7, 7, 3), False, ""),
    ]


def random_boxes(np, rng, dim, R, edge=True):
    """R normalised boxes whose sizes span every FPN level, plus clamped
    (beyond [0, 1]) and zero-size boxes."""
    side = np.exp(rng.uniform(np.log(0.02), np.log(0.9), (R, dim)))
    lo = rng.rand(R, dim) * (1 - side)
    hi = lo + side
    cols = [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]] + ([lo[:, 2], hi[:, 2]] if dim == 3 else [])
    boxes = np.stack(cols, -1).astype(np.float32)
    if edge:
        rows = [[-0.2, -0.3, 1.4, 1.2], [0.9, 0.9, 1.1, 1.3], [0.5, 0.5, 0.5, 0.5], [0.3, 0.7, 0.3, 0.9]]
        z = [[-0.5, 1.5], [0.8, 1.2], [0.5, 0.5], [0.2, 0.2]]
        extra = np.array([r + zz for r, zz in zip(rows, z)] if dim == 3 else rows, np.float32)
        boxes = np.concatenate([boxes[: R - len(extra)], extra])
    return boxes


def adversarial_boxes(np, rng, dim, crop, sizes, levels):
    """Boxes for RoIs on the given levels (one outside the pyramid is given
    the nearest level's box). Three RoIs in four: on every axis whose crop
    is not a power of 2, ``((hi - lo) * S) / crop`` and ``((hi - lo) * S) *
    (1 / crop)`` differ in float32 on the RoI's level. Every fourth RoI (index
    3 mod 4): every axis on the integer lattice (lo = k / S, hi = (k + crop)
    / S, so each coordinate is an integer where S >= crop), ending on S - 1
    at indices 3 mod 8."""
    f32 = np.float32
    levels = np.clip(levels, 0, len(sizes) - 1)
    R = levels.shape[0]
    boxes = np.zeros((R, 2 * dim), f32)
    lattice = np.arange(R) % 4 == 3
    for ax, (lo_c, hi_c) in enumerate(AXIS_COLS[:dim]):
        n = crop[ax]
        S = np.array([s[ax] for s in sizes], np.int64)[levels]
        todo = np.flatnonzero(~lattice)
        while todo.size:
            side = rng.uniform(0.02, 0.6, todo.size)
            lo = (rng.rand(todo.size) * (1 - side)).astype(f32)
            hi = (lo + side).astype(f32)
            span = (hi - lo) * S[todo].astype(f32)
            differ = span / f32(n) != span * (f32(1.0) / f32(n)) if n & (n - 1) else np.ones(todo.size, bool)
            boxes[todo[differ], lo_c], boxes[todo[differ], hi_c] = lo[differ], hi[differ]
            todo = todo[~differ]
        idx = np.flatnonzero(lattice)
        span = np.minimum(n, S[idx]) if n > 1 else np.zeros(idx.size, np.int64)
        k = np.where(idx % 8 == 3, S[idx] - span, rng.randint(0, 1 << 20, idx.size) % (S[idx] - span + 1))
        boxes[idx, lo_c] = (k / S[idx]).astype(f32)
        boxes[idx, hi_c] = ((k + span) / S[idx]).astype(f32)
    return boxes


def case_inputs(torch, np, rng, roi_levels, case):
    """(feature maps, boxes, box indices, level indices) of one case on the
    card, from ``rng``."""
    _, dim, B, C, sizes, dtype, R, crop, _, variant = case
    sizes = [s[:dim] for s in sizes]
    fms = [torch.from_numpy(rng.randn(B, C, *s).astype(np.float32)).cuda().to(dtype) for s in sizes]
    if variant == "strided":
        s0, s1 = sizes[0], sizes[1]
        last = torch.from_numpy(rng.randn(B, *s0, C).astype(np.float32)).cuda().to(dtype)
        fms[0] = last.movedim(-1, 1)  # channels-last strides
        wide = torch.from_numpy(rng.randn(B, 2 * C, s1[0], s1[1] + 3, *s1[2:]).astype(np.float32)).cuda().to(dtype)
        fms[1] = wide[:, ::2, :, 1:s1[1] + 1]
    if variant == "adversarial":
        lvl = rng.randint(0, len(sizes), R).astype(np.int32)
        boxes = adversarial_boxes(np, rng, dim, crop, sizes, lvl)
        boxes, lvl = torch.from_numpy(boxes).cuda(), torch.from_numpy(lvl).cuda()
    else:
        boxes = torch.from_numpy(random_boxes(np, rng, dim, R, edge=R > 8)).cuda()
        lvl = roi_levels(boxes, tuple(range(len(sizes))))
    if variant == "bad_levels":
        lvl[::5] = -1
        lvl[1::5] = len(sizes)
    bix = torch.from_numpy(rng.randint(0, B, R).astype(np.int32)).cuda()
    return fms, boxes, bix, lvl


def plain_in_chunks(torch, roi_ops, fms, boxes, bix, lvl, crop):
    """The plain version, PLAIN_CHUNK RoIs at a time (its result for a RoI
    does not depend on the others)."""
    return torch.cat([roi_ops.pyramid_roi_align(fms, boxes[i:i + PLAIN_CHUNK], bix[i:i + PLAIN_CHUNK],
                                                lvl[i:i + PLAIN_CHUNK], crop)
                      for i in range(0, boxes.shape[0], PLAIN_CHUNK)])


def roi_work(torch, roi_ops, fms, boxes, bix, lvl, crop, out):
    """(bytes, float32 operations) of K2 on this call's data: the float32
    output written, the map voxels its corners touch read once (counted
    exactly from the plain version's index rows), the boxes and indices; three
    operations per lerp (7 lerps a 3D sample, 3 in 2D)."""
    dim = len(crop)
    B, C = fms[0].shape[:2]
    sizes = [fm.shape[2:] for fm in fms]
    grid = [max(s[ax] for s in sizes) for ax in range(dim)]
    key = (lvl.long() * B + bix.long()).view(-1, *([1] * (2 * dim)))
    for ax, ((lo, hi), c) in enumerate(zip(AXIS_COLS, crop)):
        i0, i1, _ = roi_ops._level_axis_indices(boxes, lvl, c, [s[ax] for s in sizes], lo, hi)
        corners = torch.stack([i0, i1], -1).long()  # (R, crop_ax, 2)
        shape = [corners.shape[0]] + [1] * dim + [1] * dim
        shape[1 + ax], shape[1 + dim + ax] = corners.shape[1], 2
        key = key * grid[ax] + corners.view(shape)
    voxels = torch.unique(key).numel()
    bytes_moved = out.numel() * 4 + voxels * C * fms[0].element_size() + boxes.shape[0] * (2 * dim * 4 + 8)
    return bytes_moved, out.numel() * (7 if dim == 3 else 3) * 3


def division_probe(torch, np, roi_ops, roi_align_cuda):
    """How the card computes ``t / crop`` for a float32 tensor and a Python
    int: "reciprocal" if it equals numpy's ``t * (1 / crop)`` in float32 on
    every value, "division" if it equals ``t / crop``, else "neither"; on
    values where the two differ. Where the tree has the kernel's row model
    (``roi_align_cuda.level_axis_rows``), also holds the plain version's rows
    on the card against the model in the kernel's form."""
    f32 = np.float32
    rng = np.random.RandomState(4)
    found = {}
    for crop in (3, 5, 7, 14):
        t = (rng.rand(200000) * 64).astype(f32)
        div, rcp = t / f32(crop), t * (f32(1.0) / f32(crop))
        t = t[div != rcp]
        card = (torch.from_numpy(t).cuda() / crop).cpu().numpy()
        form = ("reciprocal" if np.array_equal(card, t * (f32(1.0) / f32(crop)))
                else "division" if np.array_equal(card, t / f32(crop)) else "neither")
        found[crop] = form
        print(f"  t / {crop} on the card for {t.size} float32 values where the two forms differ: {form}")
    forms = set(found.values())
    form = forms.pop() if len(forms) == 1 else "neither"
    if hasattr(roi_align_cuda, "level_axis_rows"):
        sizes = [(32, 32, 64), (16, 16, 32), (8, 8, 16), (4, 4, 8)]
        crop = (7, 7, 3)
        lvl = rng.randint(0, len(sizes), 2000).astype(np.int32)
        boxes = adversarial_boxes(np, rng, 3, crop, sizes, lvl)
        tb, tl = torch.from_numpy(boxes).cuda(), torch.from_numpy(lvl).cuda()
        same = True
        for ax, ((lo, hi), c) in enumerate(zip(AXIS_COLS, crop)):
            card = [x.cpu().numpy() for x in roi_ops._level_axis_indices(tb, tl, c, [s[ax] for s in sizes], lo, hi)]
            model = roi_align_cuda.level_axis_rows(boxes, lvl, c, [s[ax] for s in sizes], lo, hi)
            same &= all(np.array_equal(a, b) for a, b in zip(card, model))
        print(f"  plain rows on the card == the kernel's row model (scale by reciprocal: "
              f"{roi_align_cuda.SCALE_BY_RECIPROCAL}) on 2,000 adversarial boxes: {same}")
        if not same:
            raise AssertionError("the kernel's row model disagrees with the plain version's rows on the card")
    return form


def check_cases(torch, np, common, roi_ops, roi_align_cuda, roi_levels, cases, iters=20):
    """Every case through the kernel and the plain version on the card; the
    float32 crops must be identical (AssertionError otherwise). For the timed
    cases returns {name: times and bound}: ``ms`` (the launch alone on
    arguments prepared once, CUDA events), ``wrapper_ms`` (the whole call,
    CUDA events), ``host_ms`` (the host's time per wrapper call),
    ``plain_ms``, ``bound_ms`` / ``bound_by``, ``max_abs_err``."""
    rng = np.random.RandomState(1)
    timings = {}
    for case in cases:
        name, dim, B, C, sizes, dtype, R, crop, timed, variant = case
        fms, boxes, bix, lvl = case_inputs(torch, np, rng, roi_levels, case)
        args = (fms, boxes, bix, lvl, crop)
        got = roi_align_cuda.pyramid_roi_align(*args)
        want = plain_in_chunks(torch, roi_ops, *args)
        torch.cuda.synchronize()
        counts = torch.bincount((lvl.long() + 1).clamp(0, len(sizes) + 1), minlength=len(sizes) + 2).tolist()
        same = got.dtype == want.dtype == torch.float32 and got.shape == want.shape and torch.equal(got, want)
        err = float((got - want).abs().max())
        print(f"  {name}: R={R} crop={crop} C={C} maps {str(dtype)[6:]} {variant or 'random'}; RoIs at level "
              f"-1, 0.., {len(sizes)}: {counts} max|err|={err:.3e} identical={same}")
        if not same:
            raise AssertionError(f"RoIAlign kernel disagrees with plain PyTorch on {name}")
        if timed:
            _, launch_args = roi_align_cuda.prepare(*args)
            t = {"max_abs_err": err,
                 "ms": common.cuda_ms(lambda: roi_align_cuda.launch(launch_args), iters),
                 "wrapper_ms": common.cuda_ms(lambda: roi_align_cuda.pyramid_roi_align(*args), iters),
                 "host_ms": common.host_ms(lambda: roi_align_cuda.pyramid_roi_align(*args), iters),
                 "plain_ms": common.cuda_ms(lambda: roi_ops.pyramid_roi_align(*args), 3, 1)}
            t["bound_ms"], t["bound_by"] = common.bound(*roi_work(torch, roi_ops, *args, got))
            print(f"  {name}: launch alone {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms (host "
                  f"{t['host_ms']:.4f} ms per call), plain PyTorch {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}) (CUDA events)")
            timings[name] = t
        del fms, got, want
        torch.cuda.empty_cache()
    return timings


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from medicaldetectiontoolkit_torch.models.mrcnn import roi_levels
    from medicaldetectiontoolkit_torch.ops import roi_align as roi_ops
    from medicaldetectiontoolkit_torch.ops import roi_align_cuda
    from medicaldetectiontoolkit_torch.tools import common

    if not Path(roi_align_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {roi_align_cuda.__file__}, not the package under {root}: run this script by "
                         f"its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = roi_align_cuda.build()
    log = lib.with_suffix(".log")
    if log.exists():
        print("  " + log.read_text().strip().replace("\n", "\n  "))
    cases = roi_cases(torch)
    try:
        form = division_probe(torch, np, roi_ops, roi_align_cuda)
        timings = check_cases(torch, np, common, roi_ops, roi_align_cuda, roi_levels, cases)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    # the profiler last, so that no CUDA-event or host time is taken in a
    # process whose launches it has traced
    rng = np.random.RandomState(1)
    for case in cases:
        args = case_inputs(torch, np, rng, roi_levels, case)
        if case[0] in timings:
            ms = common.profiled_kernel_ms(lambda: roi_align_cuda.pyramid_roi_align(*args, case[7]),
                                           "pyramid_roi_align_kernel")
            timings[case[0]]["profiled_ms"] = ms
            print(f"  {case[0]}: kernel in the profiler {'not measured' if ms is None else f'{ms:.4f} ms'}")
        del args
    print(json.dumps({"card": card, "package": str(root), "division_on_card": form, "cases": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
