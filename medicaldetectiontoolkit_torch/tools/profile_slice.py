"""Where the time of a served slice goes on one CUDA card.

    python3 -m medicaldetectiontoolkit_torch.tools.profile_slice [--model retina_unet|mrcnn] [--out-dir DIR]

For float32 and bfloat16, on the 3D Retina U-Net slice (``make_slice_config``)
or the 3D Mask R-CNN slice (``make_mrcnn_slice_config``), batch 8, random
weights from seed 0:
  * stage times per chunk, CUDA-event means over the chunks. Retina U-Net:
    upload, ``_predict`` (FPN + heads), ``_finalize_outputs``
    (refine_detections + seg argmax), and the stable sort of the batch's
    foreground scores alone. Mask R-CNN: upload, FPN + RPN, proposal layer,
    classify-all, refine, mask pass; and the host time of converting one
    chunk (detections and the unmolded mask union);
  * peak device memory of one chunk;
  * a ``torch.profiler`` trace of one pipelined window (every chunk
    dispatched, then converted): host wall and dispatch time, device span,
    busy time (union of kernel, copy and set intervals), idle share, and
    device time per chunk by kernel class. With ``--out-dir`` the profiler's
    table of kernels goes to ``DIR/profile_<model>_<dtype>.txt``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from medicaldetectiontoolkit_torch.models.base import host_to_device
from medicaldetectiontoolkit_torch.models.mrcnn import _softmax, refine_detections
from medicaldetectiontoolkit_torch.tools.common import run_window, setup_card, slice_batches, slice_net

# kernel-name substrings -> class, first match wins
CLASSES = (
    ("nms", ("nms_kernel",)),
    ("roi_align", ("pyramid_roi_align_kernel",)),
    ("sort", ("sort", "Sort", "radix", "Radix")),
    ("conv", ("conv", "fprop", "implicit_gemm", "xmma", "cudnn", "Nhwc", "nhwc", "Nchw", "nchw")),
    ("upsample", ("upsample",)),
    ("pool", ("pool",)),
    ("copy", ("Memcpy", "Memset", "copy")),
    ("reduce", ("reduce", "Reduce")),
)
# CUDA-runtime entries the trace files on the device timeline; not device work
RUNTIME = ("cuda", "Command Buffer Full")


def kernel_class(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise/other"


def stage_times(net, batches):
    """Mean CUDA-event ms per chunk of each stage, and the sort alone."""
    sums = [0.0, 0.0, 0.0]
    with torch.inference_mode():
        for b in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            img = host_to_device(b["data"], net.device)
            ev[1].record()
            heads = net._predict(img)
            ev[2].record()
            net._finalize_outputs(*heads)
            ev[3].record()
            torch.cuda.synchronize()
            for i in range(3):
                sums[i] += ev[i].elapsed_time(ev[i + 1])
        n_fg = heads[0].shape[-1] - 1
        flat = torch.rand(heads[0].shape[0] * heads[0].shape[1] * n_fg, device=net.device)
        torch.sort(flat, descending=True, stable=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.sort(flat, descending=True, stable=True)
        ev[1].record()
        torch.cuda.synchronize()
    return [s / len(batches) for s in sums], ev[0].elapsed_time(ev[1]), flat.numel()


MRCNN_STAGES = ("upload", "FPN + RPN", "proposal layer", "classify-all", "refine", "mask pass")


def mrcnn_stage_times(net, batches):
    """Mean CUDA-event ms per chunk of each Mask R-CNN stage, and the mean
    host ms of converting one chunk's outputs."""
    sums = [0.0] * len(MRCNN_STAGES)
    convert = 0.0
    cf = net.cf
    with torch.inference_mode():
        for b in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(MRCNN_STAGES) + 1)]
            ev[0].record()
            img = host_to_device(b["data"], net.device)
            ev[1].record()
            maps, rpn_logits, rpn_deltas, _ = net.module.extract(img)
            ev[2].record()
            rois_norm, _, _ = net._proposals(rpn_logits, rpn_deltas)
            ev[3].record()
            logits, bbox, flat_rois, batch_ix = net._second_stage_all(maps, rois_norm)
            ev[4].record()
            det, det_mask = refine_detections(flat_rois, _softmax(logits), bbox, batch_ix, cf, img.shape[0])
            ev[5].record()
            masks = net._masks(maps, det)
            ev[6].record()
            torch.cuda.synchronize()
            for i in range(len(MRCNN_STAGES)):
                sums[i] += ev[i].elapsed_time(ev[i + 1])
            t0 = time.perf_counter()
            net.test_forward_convert((True, (det, det_mask, masks, None)), b)
            convert += time.perf_counter() - t0
    return [s / len(batches) for s in sums], convert * 1e3 / len(batches)


def peak_memory_gib(net, batch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    net.test_forward(batch)
    return torch.cuda.max_memory_allocated() / 2**30


def busy_union_us(intervals):
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_window(net, batches, table_path=None):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, t_dispatch, wall = run_window(net, batches)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(RUNTIME)]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = busy_union_us(spans)
    per_class = {}
    for e in dev:
        cls = kernel_class(e.name)
        per_class[cls] = per_class.get(cls, 0.0) + e.time_range.elapsed_us()
    if table_path:
        with open(table_path, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {"wall_ms": wall * 1e3, "dispatch_ms": t_dispatch * 1e3, "span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "n_events": len(dev), "per_class_ms": {k: v / 1e3 / len(batches) for k, v in per_class.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("retina_unet", "mrcnn"), default="retina_unet")
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--out-dir", default=None, help="where the profiler's kernel tables go")
    args = ap.parse_args()
    card = setup_card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off; model {args.model}")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    batches = slice_batches(args.chunks, args.model)
    for dtype in ("float32", "bfloat16"):
        net = slice_net(dtype, model=args.model)
        run_window(net, batches[:1])  # warm-up: cuDNN plans, kernel build and load
        if args.model == "mrcnn":
            stages, convert_ms = mrcnn_stage_times(net, batches)
            print(f"[{dtype}] CUDA-event stage ms per chunk of 8: "
                  + ", ".join(f"{n} {t:.2f}" for n, t in zip(MRCNN_STAGES, stages))
                  + f"; device total {sum(stages):.2f}; host convert (detections + mask union) {convert_ms:.1f}")
        else:
            (up, pred, fin), sort_ms, n_sort = stage_times(net, batches)
            print(f"[{dtype}] CUDA-event stage ms per chunk of 8: upload {up:.2f}, predict (FPN+heads) {pred:.2f}, "
                  f"finalize (refine+seg argmax) {fin:.2f}; stable sort of {n_sort} scores alone {sort_ms:.2f}")
        print(f"[{dtype}] peak device memory, one chunk: {peak_memory_gib(net, batches[0]):.2f} GiB")
        t0 = time.perf_counter()
        table = os.path.join(args.out_dir, f"profile_{args.model}_{dtype}.txt") if args.out_dir else None
        p = profile_window(net, batches, table)
        idle = 1 - p["busy_ms"] / p["span_ms"]
        print(f"[{dtype}] profiled {len(batches)}-chunk window: host wall {p['wall_ms']:.1f} ms "
              f"(dispatch {p['dispatch_ms']:.1f} ms), device span {p['span_ms']:.1f} ms, busy {p['busy_ms']:.1f} ms, "
              f"idle share {idle:.4f} (of host wall: {1 - p['busy_ms'] / p['wall_ms']:.4f}); "
              f"device events {p['n_events']}; profiling took {time.perf_counter() - t0:.1f} s")
        total = sum(p["per_class_ms"].values())
        for cls, ms in sorted(p["per_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"    {cls:<20} {ms:9.2f} ms/chunk {100 * ms / total:6.1f}%")
        del net
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
