"""Hold the NMS kernel K1 bit for bit against the plain PyTorch NMS on one
CUDA card, and time it at the main paths' shapes.

    python3 medicaldetectiontoolkit_torch/tools/time_nms.py

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it. To compare two commits on one card, unpack the other one
into a directory, copy this script and ``tools/common.py`` into its
``medicaldetectiontoolkit_torch/tools/``, and run the two copies in turns.

Every case's keep lists must equal the plain version's (exit 1 if not). For
each timed case it prints the wrapper's CUDA-event time over back-to-back
calls and the host's time per call, the CUDA-event time of the launch
alone where the wrapper has ``prepare`` / ``launch``, the plain version's
time and the bound, and after all of them the kernel's device time per
launch from ``torch.profiler``; the last line is a JSON object of them.
``chip_smoke.py`` phase 3 runs the same cases through ``check_cases``,
without the profiler.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

# one IoU test: 9 operations per axis (min, max, two adds, max, multiply for
# the intersection; two adds and a multiply for the area), 6 for the union,
# the division and the comparison
OPS_PER_IOU = {2: 9 * 2 + 6, 3: 9 * 3 + 6}


def nms_cases(np):
    """(name, boxes (L|1, N, 2d), scores (L|1, N), valid (L, N)|None, thresh,
    max_out, pixel_offset, broadcast lanes, timed) from numpy seeds."""
    rng = np.random.RandomState(0)

    def boxes(L, n, dim, integer=False, extent=80.0, size=30.0, r=rng):
        lo = r.rand(L, n, dim) * extent
        hi = lo + r.rand(L, n, dim) * size + 1.0
        if integer:
            lo, hi = np.round(lo), np.round(hi)
        cols = [lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]]
        if dim == 3:
            cols += [lo[..., 2], hi[..., 2]]
        return np.stack(cols, -1).astype(np.float32)

    def desc(x):
        return -np.sort(-x, axis=-1)

    cases = []
    cases.append(("random_2d", boxes(3, 1000, 2), rng.rand(3, 1000).astype(np.float32),
                  rng.rand(3, 1000) < 0.8, 0.4, 50, 1.0, False, False))
    cases.append(("random_3d", boxes(4, 3000, 3), rng.rand(4, 3000).astype(np.float32), None, 0.3, 40, 0.0, False,
                  False))
    tie_scores = (rng.randint(0, 10, (2, 2000)) / 10.0).astype(np.float32)
    cases.append(("ties_int_3d_off1", boxes(2, 2000, 3, integer=True, extent=20, size=5), tie_scores,
                  None, 0.1, 100, 1.0, False, False))
    cases.append(("ties_int_2d_off0", boxes(2, 2000, 2, integer=True, extent=20, size=5), tie_scores,
                  None, 0.1, 100, 0.0, False, False))
    valid = rng.rand(3, 500) < 0.5
    valid[1] = False
    cases.append(("all_invalid_lane", boxes(3, 500, 3), rng.rand(3, 500).astype(np.float32), valid, 0.5, 20, 1.0,
                  False, False))
    cases.append(("n37", boxes(2, 37, 2), rng.rand(2, 37).astype(np.float32), None, 0.5, 10, 1.0, False, False))
    cases.append(("max_output_gt_survivors", boxes(2, 20, 3, extent=5), rng.rand(2, 20).astype(np.float32), None,
                  0.0, 64, 1.0, False, False))
    # Mask R-CNN's proposal shape: 8 lanes of 6,000 unrounded pixel boxes
    # each (not broadcast), descending scores, IoU 0.7, 500 keep slots
    prop_scores = desc(rng.rand(8, 6000)).astype(np.float32)
    cases.append(("proposals_8x6000_3d", boxes(8, 6000, 3, extent=120, size=24), prop_scores, None, 0.7, 500, 1.0,
                  False, True))
    # Retina U-Net's refine shape: 16 lanes (8 elements x 2 fg classes) over
    # one broadcast array of 50,000 rounded boxes, descending scores with ties
    n, lanes = 50000, 16
    scores = np.sort((rng.rand(n) * 1000).round() / 1000.0)[::-1].astype(np.float32)
    lane_of = rng.randint(0, lanes, n)
    cases.append(("slice_16x50000_3d", boxes(1, n, 3, integer=True, extent=120, size=20), scores[None],
                  lane_of[None, :] == np.arange(lanes)[:, None], 1e-5, 30, 1.0, True, True))

    r = np.random.RandomState(3)
    # Mask R-CNN's refinement shape (models/mrcnn.py::refine_detections): 8
    # elements x 500 RoIs x 2 fg classes = 8,000 candidates, class-major per
    # RoI, broadcast to 16 (element, class) lanes; class scores unsorted,
    # those below model_min_confidence 0.1 invalid; rounded boxes, IoU 1e-5
    n_roi, n_fg, bsz = 4000, 2, 8
    cand_scores = r.rand(n_roi * n_fg).astype(np.float32)
    cand_class = np.tile(np.arange(1, n_fg + 1), n_roi)
    cand_batch = np.repeat(np.arange(n_roi) // (n_roi // bsz), n_fg)
    lane_elem, lane_class = np.repeat(np.arange(bsz), n_fg), np.tile(np.arange(1, n_fg + 1), bsz)
    refine_valid = ((cand_scores >= 0.1)[None] & (cand_batch[None] == lane_elem[:, None])
                    & (cand_class[None] == lane_class[:, None]))
    cases.append(("refine_16x8000_3d", boxes(1, n_roi * n_fg, 3, integer=True, extent=120, size=20, r=r),
                  cand_scores[None], refine_valid, 1e-5, 30, 1.0, True, True))
    # sorted lanes with tie runs of ~500 across the walk's 256-candidate
    # tiles, behind a valid mask; 3D with the +1 offset and 2D without
    tie_desc = desc(r.randint(0, 6, (3, 3000)) / 6.0).astype(np.float32)
    cases.append(("sorted_ties_tiles_3d", boxes(3, 3000, 3, integer=True, extent=20, size=5, r=r), tie_desc,
                  r.rand(3, 3000) < 0.9, 0.1, 200, 1.0, False, False))
    cases.append(("sorted_ties_tiles_2d", boxes(3, 3000, 2, integer=True, extent=30, size=5, r=r), tie_desc,
                  None, 0.1, 200, 0.0, False, False))
    # lanes whose candidates exceed the shared-memory capacity (about 6,900
    # 3D or 9,200 2D entries): the global scratch. Overlapping boxes walked
    # to the end, unsorted argmax steps over 16,000, and a sorted lane that
    # keeps more boxes than the capacity (kept slots in the scratch)
    cases.append(("overcap_sorted_3d", boxes(2, 16000, 3, extent=10, size=40, r=r),
                  desc(r.rand(2, 16000)).astype(np.float32), None, 0.2, 500, 1.0, False, False))
    cases.append(("overcap_unsorted_3d", boxes(2, 16000, 3, extent=40, size=30, r=r),
                  r.rand(2, 16000).astype(np.float32), r.rand(2, 16000) < 0.95, 0.3, 100, 1.0, False, False))
    cases.append(("overcap_sorted_2d", boxes(1, 12000, 2, extent=20, size=40, r=r),
                  desc(r.rand(1, 12000)).astype(np.float32), None, 0.3, 300, 0.0, False, False))
    cases.append(("overcap_keep_many_3d", boxes(1, 7500, 3, extent=2000, size=2, r=r),
                  desc(r.rand(1, 7500)).astype(np.float32), None, 0.5, 7200, 1.0, False, False))
    return cases


def case_tensors(torch, case, dev):
    """The case's kernel arguments on ``dev``: (boxes, scores, thresh,
    max_out), valid, pixel_offset; broadcast lanes expanded (stride 0)."""
    _, b, s, v, thr, max_out, off, broadcast, _ = case
    L = v.shape[0] if v is not None else b.shape[0]
    tb, ts = torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev)
    if broadcast:
        tb, ts = tb.expand(L, *tb.shape[1:]), ts.expand(L, ts.shape[1])
    tv = torch.from_numpy(v).to(dev) if v is not None else None
    return (tb, ts, thr, max_out), tv, off


def nms_work(np, case, keep_idx, keep_mask):
    """(bytes, float32 operations) that one call needs on this case's data,
    given its keep lists (numpy).

    Bytes: the scores, valid flags and boxes read once (a broadcast array
    once for all lanes), the outputs written once. Operations: a compare per
    entry, and the IoU pairs the greedy result needs on this data: every
    kept box against each box kept before it, and every candidate that a
    walk in score order reaches and drops against at least one."""
    _, b, s, v, _, max_out, _, _, _ = case
    dim = b.shape[-1] // 2
    L = keep_mask.shape[0]
    pairs = 0
    for lane in range(L):
        sl = s[min(lane, s.shape[0] - 1)]
        ok = sl > -np.inf if v is None else v[lane] & (sl > -np.inf)
        cand = np.flatnonzero(ok)
        k = int(keep_mask[lane].sum())
        reached = cand.size
        if k == max_out and k:
            # the walk stops at the last kept box
            order = cand[np.lexsort((cand, -sl[cand]))]  # score order, ties to the lower index
            reached = int(np.flatnonzero(order == keep_idx[lane, k - 1])[0]) + 1
        pairs += k * (k - 1) // 2 + (reached - k)
    ops = pairs * OPS_PER_IOU[dim] + L * s.shape[-1]
    return b.nbytes + s.nbytes + (v.nbytes if v is not None else 0) + L * max_out * 5, ops


def check_cases(torch, np, common, nms_ops, nms_cuda, cases, iters=20):
    """Every case through the kernel and the plain version on the card; the
    keep lists must be identical (AssertionError otherwise). For the timed
    cases returns {name: times and bound}: ``wrapper_ms`` (the whole call,
    CUDA events), ``host_ms`` (the host's time per call), ``ms`` (the
    launch alone on prepared arguments, CUDA events; None for a wrapper
    without ``prepare``), ``plain_ms``, ``bound_ms`` / ``bound_by``."""
    dev = torch.device("cuda")
    timings = {}
    for case in cases:
        name, b, _, _, _, max_out, _, _, timed = case
        args, tv, off = case_tensors(torch, case, dev)
        k_idx, k_mask = nms_cuda.batched_nms(*args, valid=tv, pixel_offset=off)
        p_idx, p_mask = nms_ops.batched_nms(*args, valid=tv, pixel_offset=off)
        torch.cuda.synchronize()
        same = torch.equal(k_idx, p_idx) and torch.equal(k_mask, p_mask)
        L, N = args[1].shape
        print(f"  {name}: L={L} N={N} dim={b.shape[-1] // 2} max_out={max_out} off={off} "
              f"kept={int(k_mask.sum())} identical={same}")
        if not same:
            raise AssertionError(f"NMS kernel disagrees with plain PyTorch on {name}")
        if not timed:
            continue

        def call():
            return nms_cuda.batched_nms(*args, valid=tv, pixel_offset=off)

        t = {"max_abs_err": float((k_idx.long() - p_idx.long()).abs().max()),
             "wrapper_ms": common.cuda_ms(call, iters), "host_ms": common.host_ms(call, iters), "ms": None}
        if hasattr(nms_cuda, "prepare"):
            launch_args = nms_cuda.prepare(*args, valid=tv, pixel_offset=off)[2]
            t["ms"] = common.cuda_ms(lambda: nms_cuda.launch(launch_args), iters)
        t["plain_ms"] = common.cuda_ms(lambda: nms_ops.batched_nms(*args, valid=tv, pixel_offset=off), 3, 1)
        t["bound_ms"], t["bound_by"] = common.bound(*nms_work(np, case, p_idx.cpu().numpy(), p_mask.cpu().numpy()))

        def fmt(x):
            return "not measured" if x is None else f"{x:.4f} ms"

        print(f"  {name}: launch alone {fmt(t['ms'])}, wrapper {fmt(t['wrapper_ms'])} (host "
              f"{fmt(t['host_ms'])} per call), plain PyTorch {fmt(t['plain_ms'])}, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']})")
        timings[name] = t
    return timings


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from medicaldetectiontoolkit_torch.ops import nms as nms_ops
    from medicaldetectiontoolkit_torch.ops import nms_cuda
    from medicaldetectiontoolkit_torch.tools import common

    if not Path(nms_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {nms_cuda.__file__}, not the package under {root}: run this script by its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = nms_cuda.build()
    log = lib.with_suffix(".log")
    if log.exists():
        print("  " + log.read_text().strip().replace("\n", "\n  "))
    cases = nms_cases(np)
    try:
        timings = check_cases(torch, np, common, nms_ops, nms_cuda, cases)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    # the profiler last, so that no CUDA-event or host time is taken in a
    # process whose launches it has traced
    for case in cases:
        if case[0] in timings:
            args, tv, off = case_tensors(torch, case, torch.device("cuda"))
            ms = common.profiled_kernel_ms(lambda: nms_cuda.batched_nms(*args, valid=tv, pixel_offset=off),
                                           "nms_kernel")
            timings[case[0]]["profiled_ms"] = ms
            print(f"  {case[0]}: kernel in the profiler {'not measured' if ms is None else f'{ms:.4f} ms'}")
    print(json.dumps({"card": card, "package": str(root), "cases": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
