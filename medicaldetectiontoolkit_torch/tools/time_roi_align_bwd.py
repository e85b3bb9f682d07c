"""Hold the backward of the pyramid RoIAlign kernel K2 against the plain
PyTorch backward on one CUDA card, and time it at the training path's
shapes.

    python3 medicaldetectiontoolkit_torch/tools/time_roi_align_bwd.py

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it. The cases (built as ``tools/time_roi_align.py`` builds
the forward's): 2D and 3D, every level, crop 1, clamped and zero-size
boxes, level indices -1 and n_levels, strided maps, bf16 and f16 maps, and
the two-stage training step's launches at LIDC width: 48 sampled RoIs (8
elements x 6) to (7,7,3) and to (14,14,5) on the 36-channel P2-P5 pyramid of
a 128x128x64 patch, in float32 and bfloat16. Each case runs the kernel twice
and the plain backward (``pyramid_roi_align_backward_plain``, the autograd
of the plain forward) once, on the same cotangent.

Tolerances, per level, relative to the max |gradient| of the plain version:
  * float32 maps: 1e-5 against the plain backward (float32 atomics add the
    same products in another order), and the two kernel runs within 1e-5 of
    each other, the same tolerance (only the order of the adds differs);
  * bf16 / f16 maps: the kernel sums in float32 and rounds once, so it is
    held elementwise against the plain backward of the float32-cast maps,
    rounded to the maps' dtype, within one unit in the last place of that
    dtype (2^-7 relative for bf16, 2^-10 for f16) plus 1e-6 of the level's
    max (the float32 sums' own order, which decides values near zero), and
    against the plain backward in the maps' own dtype within 3e-2 of the
    max: that version rounds each crop row's partial gradient to the maps'
    dtype and adds the rows into the level in that dtype, each add rounding
    again.
For the timed cases it prints the CUDA-event time of the launch alone
(``prepare_backward`` once, then ``launch_backward``: the zeroing and the
scatter), of the whole wrapper (with the casts of bf16 gradients), the
host's time per wrapper call, the plain backward's time and the bound: the
float32 level gradients written once and ``grad_out`` read once, over the
card's memory rate. No single PyTorch call computes this scatter, so there
is no library time. The last line is a JSON object of the timings.
``chip_smoke.py`` phase 3d runs the same cases through ``check_cases``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path


def bwd_cases(torch):
    """(name, dim, B, C, level sizes, map dtype, R, crop, timed, variant), as
    ``time_roi_align.roi_cases``."""
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
        ("3d_levels_out_of_range", 3, 3, 6, small3, f32, 61, (7, 7, 3), False, "bad_levels"),
        ("3d_strided_maps", 3, 3, 6, small3, f32, 67, (7, 7, 3), False, "strided"),
        ("3d_bf16", 3, 3, 6, small3, bf16, 67, (14, 14, 5), False, ""),
        ("3d_f16", 3, 3, 6, small3, f16, 67, (7, 7, 3), False, ""),
        # the training step's two launches per microbatch at LIDC width
        ("lidc_classify_48_f32", 3, 8, 36, lidc, f32, 48, (7, 7, 3), True, ""),
        ("lidc_mask_48_f32", 3, 8, 36, lidc, f32, 48, (14, 14, 5), True, ""),
        ("lidc_classify_48_bf16", 3, 8, 36, lidc, bf16, 48, (7, 7, 3), False, ""),
        ("lidc_mask_48_bf16", 3, 8, 36, lidc, bf16, 48, (14, 14, 5), True, ""),
    ]


def bwd_work(shapes, grad_out, dim):
    """(bytes, float32 operations) of the backward: the float32 level
    gradients written once, ``grad_out`` read once; per element of
    ``grad_out`` the weight products and the adds into its 2^dim corners."""
    import math

    n_grad = sum(math.prod(s) for s in shapes)
    per = (2 + 4 + 8 + 8) if dim == 3 else (2 + 4 + 4)
    return (n_grad + grad_out.numel()) * 4, grad_out.numel() * per


def _level_errors(got, want):
    """Per level: max |got - want| over the max |want|."""
    return [float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
            for g, w in zip(got, want)]


def check_cases(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align, cases, iters=20):
    """Every case through the kernel (twice) and the plain backward on the
    card, within the tolerances of this module's note (AssertionError
    otherwise). Returns {name: times and bound} for the timed cases:
    ``ms`` (the launch alone), ``wrapper_ms``, ``host_ms``, ``plain_ms``,
    ``bound_ms`` / ``bound_by``, ``max_abs_err``."""
    rng = np.random.RandomState(3)
    timings = {}
    for case in cases:
        name, dim, _, C, sizes, dtype, R, crop, timed, variant = case
        fms, boxes, bix, lvl = time_roi_align.case_inputs(torch, np, rng, roi_levels, case)
        g = torch.from_numpy(rng.randn(R, C, *crop).astype(np.float32)).cuda()
        meta = [(tuple(f.shape), f.dtype) for f in fms]
        args = (g, meta, boxes, bix, lvl, crop)
        got = roi_align_cuda.pyramid_roi_align_backward(*args)
        again = roi_align_cuda.pyramid_roi_align_backward(*args)
        want = roi_ops.pyramid_roi_align_backward_plain(g, fms, boxes, bix, lvl, crop)
        torch.cuda.synchronize()
        if any(a.dtype != dtype or a.shape != f.shape for a, f in zip(got, fms)):
            raise AssertionError(f"{name}: gradients of the wrong dtype or shape")
        errs = _level_errors(got, want)
        rerun = _level_errors(again, got)
        identical = all(torch.equal(a, b) for a, b in zip(again, got))
        counts = torch.bincount((lvl.long() + 1).clamp(0, len(sizes) + 1), minlength=len(sizes) + 2).tolist()
        line = (f"  {name}: R={R} crop={crop} C={C} maps {str(dtype)[6:]} {variant or 'random'}; RoIs at level -1, "
                f"0.., {len(sizes)}: {counts}; max|err|/max per level {', '.join(f'{e:.2e}' for e in errs)}; "
                f"second run {max(rerun):.2e} of the max (identical {identical})")
        if dtype == torch.float32:
            ok = max(errs) <= 1e-5 and max(rerun) <= 1e-5
        else:
            ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
            want32 = roi_ops.pyramid_roi_align_backward_plain(g, [f.float() for f in fms], boxes, bix, lvl, crop)
            worst = max(float(((a.float() - w.to(dtype).float()).abs() - ulp * w.to(dtype).float().abs()
                               - 1e-6 * w.abs().max()).max())
                        for a, w in zip(got, want32))
            line += f"; against the float32 plain version rounded: excess over 1 ulp {max(worst, 0.0):.2e}"
            ok = worst <= 0.0 and max(errs) <= 3e-2 and max(_level_errors(again, got)) <= 2.0 ** -7
        print(line)
        if not ok:
            raise AssertionError(f"RoIAlign backward kernel disagrees with the plain backward on {name}")
        if timed:
            buf, shapes, launch_args = roi_align_cuda.prepare_backward(*args)
            t = {"max_abs_err": max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)),
                 "ms": common.cuda_ms(lambda: roi_align_cuda.launch_backward(launch_args), iters),
                 "wrapper_ms": common.cuda_ms(lambda: roi_align_cuda.pyramid_roi_align_backward(*args), iters),
                 "host_ms": common.host_ms(lambda: roi_align_cuda.pyramid_roi_align_backward(*args), iters),
                 "plain_ms": common.cuda_ms(
                     lambda: roi_ops.pyramid_roi_align_backward_plain(g, fms, boxes, bix, lvl, crop), 3, 1)}
            t["bound_ms"], t["bound_by"] = common.bound(*bwd_work(shapes, g, dim))
            print(f"  {name}: launch alone {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms (host "
                  f"{t['host_ms']:.4f} ms per call), plain PyTorch {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {bwd_work(shapes, g, dim)[0] / 1e6:.1f} MB) "
                  f"(CUDA events)")
            timings[name] = t
            del buf, launch_args
        del fms, got, again, want
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
    from medicaldetectiontoolkit_torch.tools import common, time_roi_align

    if not Path(roi_align_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {roi_align_cuda.__file__}, not the package under {root}: run this script by "
                         f"its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    roi_align_cuda.build()
    try:
        timings = check_cases(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align,
                              bwd_cases(torch))
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    print(json.dumps({"card": card, "roi_align_bwd": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
