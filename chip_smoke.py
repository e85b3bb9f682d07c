#!/usr/bin/env python3
"""Drive the PyTorch port's inference path once on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. device: require CUDA, print the card (``nvidia-smi`` name and power
     limit) and the float32 precision switches (TF32 off for convs and
     matmuls);
  2. build the NMS kernel from ``medicaldetectiontoolkit_torch/csrc/nms.cu``;
  3. kernel vs plain PyTorch NMS on the card: bit-identical keep lists on
     random, tied, all-invalid, ragged and slice-shaped cases, with times;
  4. the slice: 3D Retina U-Net at LIDC width (patch 128x128x64,
     start_filts 18, end_filts 36, batch 8) through ``build_model`` ->
     ``test_forward_dispatch``/``convert``, three chunks dispatched before
     any is converted, in float32 and bfloat16; the NMS launch counter must
     rise once per chunk; outputs finite and shaped; refine_detections with
     the kernel equals refine_detections with the plain NMS; a small 3D
     input agrees with the CPU (plain PyTorch) run of the same weights.

The last lines are a JSON object with one entry per kernel of the path and
``{"ok": true, "device": {...}}``.

The script imports the PyTorch package only (configs and batches come from
``medicaldetectiontoolkit_torch.testing``): neither jax nor any module of the
JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nms_cases(np):
    """(name, boxes (L,N,2d), scores (L,N), valid (L,N)|None, thresh, max_out,
    pixel_offset, broadcast lanes) from a numpy seed."""
    rng = np.random.RandomState(0)

    def boxes(L, n, dim, integer=False, extent=80.0, size=30.0):
        lo = rng.rand(L, n, dim) * extent
        hi = lo + rng.rand(L, n, dim) * size + 1.0
        if integer:
            lo, hi = np.round(lo), np.round(hi)
        cols = [lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]]
        if dim == 3:
            cols += [lo[..., 2], hi[..., 2]]
        return np.stack(cols, -1).astype(np.float32)

    cases = []
    cases.append(("random_2d", boxes(3, 1000, 2), rng.rand(3, 1000).astype(np.float32),
                  rng.rand(3, 1000) < 0.8, 0.4, 50, 1.0, False))
    cases.append(("random_3d", boxes(4, 3000, 3), rng.rand(4, 3000).astype(np.float32), None, 0.3, 40, 0.0, False))
    tie_scores = (rng.randint(0, 10, (2, 2000)) / 10.0).astype(np.float32)
    cases.append(("ties_int_3d_off1", boxes(2, 2000, 3, integer=True, extent=20, size=5), tie_scores,
                  None, 0.1, 100, 1.0, False))
    cases.append(("ties_int_2d_off0", boxes(2, 2000, 2, integer=True, extent=20, size=5), tie_scores,
                  None, 0.1, 100, 0.0, False))
    valid = rng.rand(3, 500) < 0.5
    valid[1] = False
    cases.append(("all_invalid_lane", boxes(3, 500, 3), rng.rand(3, 500).astype(np.float32), valid, 0.5, 20, 1.0,
                  False))
    cases.append(("n37", boxes(2, 37, 2), rng.rand(2, 37).astype(np.float32), None, 0.5, 10, 1.0, False))
    cases.append(("max_output_gt_survivors", boxes(2, 20, 3, extent=5), rng.rand(2, 20).astype(np.float32), None,
                  0.0, 64, 1.0, False))
    # the slice's shape: 16 lanes (8 elements x 2 fg classes) over one
    # broadcast array of 50,000 rounded boxes, descending scores with ties
    n, lanes = 50000, 16
    scores = np.sort((rng.rand(n) * 1000).round() / 1000.0)[::-1].astype(np.float32)
    lane_of = rng.randint(0, lanes, n)
    cases.append(("slice_16x50000_3d", boxes(1, n, 3, integer=True, extent=120, size=20), scores[None],
                  lane_of[None, :] == np.arange(lanes)[:, None], 1e-5, 30, 1.0, True))
    return cases


def _check_nms(torch, np, nms_ops, nms_cuda):
    print("== phase 3: NMS kernel vs plain PyTorch (bit-identical idx and mask)")
    dev = torch.device("cuda")
    slice_entry = None
    for name, b, s, v, thr, max_out, off, broadcast in _nms_cases(np):
        L = v.shape[0] if v is not None else b.shape[0]
        tb, ts = torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev)
        if broadcast:
            tb, ts = tb.expand(L, *tb.shape[1:]), ts.expand(L, ts.shape[1])
        tv = torch.from_numpy(v).to(dev) if v is not None else None
        args = (tb, ts, thr, max_out)
        k_idx, k_mask = nms_cuda.batched_nms(*args, valid=tv, pixel_offset=off)
        p_idx, p_mask = nms_ops.batched_nms(*args, valid=tv, pixel_offset=off)
        torch.cuda.synchronize()
        same = torch.equal(k_idx, p_idx) and torch.equal(k_mask, p_mask)
        err = float((k_idx.long() - p_idx.long()).abs().max())
        kept = int(k_mask.sum())
        print(f"  {name}: L={L} N={tb.shape[1]} dim={tb.shape[-1] // 2} max_out={max_out} off={off} "
              f"kept={kept} identical={same}")
        if not same:
            raise AssertionError(f"NMS kernel disagrees with plain PyTorch on {name}")
        if broadcast:
            k_ms = _cuda_ms(torch, lambda: nms_cuda.batched_nms(*args, valid=tv, pixel_offset=off))
            p_ms = _cuda_ms(torch, lambda: nms_ops.batched_nms(*args, valid=tv, pixel_offset=off), iters=5)
            print(f"  {name}: kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms (CUDA events)")
            slice_entry = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
    return slice_entry


def _drive_slice(torch, np, dtype, batches, common, nms_cuda, refine_detections, nms_ops, card):
    print(f"== phase 4: retina_unet 3D 128x128x64 sf18 ef36 batch 8, {dtype}")
    net = common.slice_net(dtype, seed=0)
    cf = net.cf
    n_params = sum(p.numel() for p in net.module.parameters())
    print(f"  params {n_params}, anchors {net.anchors.shape[0]}")

    # warm-up chunk (cuDNN plans, kernel library load); not counted
    net.test_forward_convert(net.test_forward_dispatch(batches[0]), batches[0])
    torch.cuda.synchronize()

    nms_cuda.batched_nms.launches = 0
    handles, results, t_dispatch, wall = common.run_window(net, batches)
    launches = nms_cuda.batched_nms.launches
    print(f"  NMS kernel launches in the main-path run: {launches} (chunks: {len(batches)})")
    if launches != len(batches):
        raise AssertionError(f"expected {len(batches)} NMS kernel launches, counted {launches}")
    for det, mask, seg in handles:
        if not (det.is_cuda and mask.is_cuda and seg.is_cuda):
            raise AssertionError("a main-path output is not on the CUDA card")
    for r in results:
        if r["seg_preds"].shape != (8, 1, 128, 128, 64) or r["seg_preds"].dtype != np.uint8:
            raise AssertionError(f"seg_preds {r['seg_preds'].shape} {r['seg_preds'].dtype}")
        if len(r["boxes"]) != 8:
            raise AssertionError(f"boxes list of length {len(r['boxes'])}")
        for boxes in r["boxes"]:
            for box in boxes:
                if box["box_type"] != "det" or not np.all(np.isfinite(box["box_coords"])) \
                        or not np.isfinite(box["box_score"]):
                    raise AssertionError(f"bad box {box}")
    n_det = [sum(len(b) for b in r["boxes"]) for r in results]
    per_chunk = wall / len(batches)
    print(f"  {len(batches)} chunks: dispatch {t_dispatch * 1e3:.1f} ms, dispatch+convert {wall * 1e3:.1f} ms; "
          f"{per_chunk * 1e3:.1f} ms/chunk, {8 * len(batches) / wall:.2f} patches/s ({card}); "
          f"detections per chunk {n_det}")

    # head outputs of chunk 0: finite; kernel NMS == plain NMS on them
    with torch.inference_mode():
        from medicaldetectiontoolkit_torch.models.base import host_to_device

        heads = net._predict(host_to_device(batches[0]["data"], net.device))
        for name, t in zip(("class_logits", "bb_deltas", "seg_logits"), heads):
            if not t.is_cuda or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} not finite or not on the card")
        det_k, mask_k = refine_detections(net.anchors, heads[0], heads[1], cf)
        det_p, mask_p = refine_detections(net.anchors, heads[0], heads[1], cf, nms_fn=nms_ops.batched_nms)
        torch.cuda.synchronize()
    if not (torch.equal(det_k, det_p) and torch.equal(mask_k, mask_p)):
        raise AssertionError("refine_detections: kernel NMS and plain NMS give different detections")
    print(f"  refine_detections kernel == plain on chunk 0: {int(mask_k.sum())} detections identical")
    return {"launches": launches, "per_chunk_ms": per_chunk * 1e3, "heads": [h.float().cpu() for h in heads[:2]]}


def _small_reference(torch, np, make_config, make_batch, build_model, log):
    """A small 3D retina_unet: the card (kernel NMS, TF32 off) against the CPU
    run of the same weights (plain PyTorch everywhere)."""
    print("== phase 4b: small 3D retina_unet, card vs CPU plain path")
    cf = make_config(model="retina_unet", dim=3, batch_size=2)
    batch = make_batch(cf, seed=5)
    gpu = build_model(cf, log, device="cuda")
    cpu = build_model(cf, log, device="cpu")
    gpu.initialize(seed=1)
    cpu.load_state_dict(gpu.state_dict())
    with torch.inference_mode():
        hg = [h.cpu() for h in gpu._predict(torch.from_numpy(batch["data"]).cuda())]
        hc = cpu._predict(torch.from_numpy(batch["data"]))
    for name, a, b in zip(("class_logits", "bb_deltas", "seg_logits"), hg, hc):
        err, ref = float((a - b).abs().max()), float(b.abs().max())
        print(f"  {name}: max|gpu-cpu| {err:.3e} (max|cpu| {ref:.3e})")
        # float32 convs summed in another order: relative 1e-4
        if not err <= 1e-4 * ref:
            raise AssertionError(f"{name} differs from the CPU reference beyond 1e-4 relative")
    rg, rc = gpu.test_forward(batch), cpu.test_forward(batch)
    n_diff = int((rg["seg_preds"] != rc["seg_preds"]).sum())
    print(f"  seg_preds: {n_diff} of {rc['seg_preds'].size} voxels differ (argmax near-ties)")
    if n_diff > 1e-4 * rc["seg_preds"].size:
        raise AssertionError("small input: seg_preds differ from the CPU reference")
    for bg, bc in zip(rg["boxes"], rc["boxes"]):
        same = len(bg) == len(bc) and all(
            np.array_equal(g["box_coords"], c["box_coords"]) and g["box_pred_class_id"] == c["box_pred_class_id"]
            and abs(g["box_score"] - c["box_score"]) < 1e-5
            for g, c in zip(bg, bc)
        )
        if not same:
            raise AssertionError("small input: detections differ from the CPU reference")
    print(f"  detections equal: {sum(len(b) for b in rc['boxes'])} boxes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from medicaldetectiontoolkit_torch.testing import make_batch, make_config
    from medicaldetectiontoolkit_torch.tools import common
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.models.retina_net import refine_detections
    from medicaldetectiontoolkit_torch.ops import nms as nms_ops
    from medicaldetectiontoolkit_torch.ops import nms_cuda

    print("== phase 1: device")
    card = common.card_line()
    name = torch.cuda.get_device_name(0)
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {name}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    print("== phase 2: build")
    t0 = time.perf_counter()
    lib_path = nms_cuda.build()
    print(f"  {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        print("  " + log.read_text().strip().replace("\n", "\n  "))

    nms_entry = _check_nms(torch, np, nms_ops, nms_cuda)

    batches = common.slice_batches(3)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        runs[dtype] = _drive_slice(torch, np, dtype, batches, common, nms_cuda, refine_detections, nms_ops, card)
    h32, h16 = runs["float32"]["heads"], runs["bfloat16"]["heads"]
    for hname, a, b in zip(("class_logits", "bb_deltas"), h32, h16):
        print(f"  bfloat16 vs float32 {hname}: max abs diff {float((a - b).abs().max()):.3e}")
    _small_reference(torch, np, make_config, make_batch, build_model, common.QuietLog())

    print(f"== summary ({card})")
    for dtype, r in runs.items():
        print(f"  {dtype}: {r['per_chunk_ms']:.1f} ms per chunk of 8 patches")
    kernels = [{
        "name": "nms",
        "route": "cuda",
        "source": "medicaldetectiontoolkit_torch/csrc/nms.cu",
        "replaces": "medicaldetectiontoolkit_tpu/ops/nms_pallas.py:84",
        "launches": sum(r["launches"] for r in runs.values()),
        **nms_entry,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
