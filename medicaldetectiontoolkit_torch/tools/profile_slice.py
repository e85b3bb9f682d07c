"""Where the time of a served slice, or of the training slice, goes on one
CUDA card.

    python3 -m medicaldetectiontoolkit_torch.tools.profile_slice [--model retina_unet|mrcnn] [--out-dir DIR]
    python3 -m medicaldetectiontoolkit_torch.tools.profile_slice --train [--model retina_unet|mrcnn|detection_unet]
        [--stem 0|1] [--out-dir DIR]

For float32 and bfloat16, on the 3D Retina U-Net slice (``make_slice_config``)
or the 3D Mask R-CNN slice (``make_mrcnn_slice_config``), batch 8, random
weights from seed 0:
  * stage times per chunk from the program's own spans (``utils/trace.py``)
    over one window of the public dispatch and convert: each stage's device
    ms from its CUDA-event pair (``forward``; ``refine``; Mask R-CNN's
    ``proposals`` and ``classify_all``), the host ms of ``upload``,
    ``convert`` and ``wait``, and the counters per chunk; for Retina U-Net
    also the stable sort of the batch's foreground scores alone;
  * peak device memory of one chunk;
  * a ``torch.profiler`` trace of one pipelined window (every chunk
    dispatched, then converted): host wall and dispatch time, device span,
    busy time (union of kernel, copy and set intervals), idle share, and
    device time per chunk by kernel class (each hand-written kernel a class
    of its own, K4's two launches apart). With ``--out-dir`` the profiler's
    table of kernels goes to ``DIR/profile_<model>_<dtype>.txt``.

With ``--train``, the training slice (``make_train_slice_config``: 3D Retina
U-Net at LIDC width, batch 2 x 4, remat; with ``--model mrcnn`` the Mask
R-CNN slice, ``make_mrcnn_slice_config``, batch 8 as one microbatch, remat;
with ``--model detection_unet`` the Detection U-Net slice,
``make_det_unet_slice_config``, the same layout, whose profiled steps
include the host's connected components in each convert) with
``MDT_STEM_PALLAS`` set to ``--stem`` (default 1: the stem kernels K3/K4):
per-step stage times from the spans (device ms of ``forward``, ``losses``,
``backward``, ``update``, ``refine`` and Mask R-CNN's ``proposals``,
``classify_all``, ``targets``; host ms of ``upload``), the peak device memory
of one step, and the profiler's view of three steps (host wall, device busy
and idle share, device time per step by kernel class).
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from medicaldetectiontoolkit_torch.tools.common import (run_window, setup_card, slice_batches, slice_net,
                                                         train_steps)
from medicaldetectiontoolkit_torch.utils import trace

# kernel-name substrings -> class, first match wins
CLASSES = (
    ("nms", ("nms_kernel",)),
    ("K3 stem_fwd", ("stem_fwd_kernel",)),
    ("K4 partial pass", ("stem_wgrad_partial_kernel",)),
    ("K4 reduce", ("stem_wgrad_reduce_kernel",)),
    ("roi_align", ("pyramid_roi_align_kernel",)),
    ("K2 backward", ("pyramid_roi_align_bwd_kernel",)),
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


def span_stages(run, n: int):
    """``run()`` with the program's tracing on, ending in a synchronise:
    per span name (device ms, host ms) per unit of ``n``, and the counters
    per unit."""
    trace.enable()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        trace.disable()
    s = trace.summary()
    stages = {name: (None if v["device_ms"] is None else v["device_ms"] / n, v["host_ms"] / n)
              for name, v in s["spans"].items()}
    return stages, {k: v / n for k, v in s["counters"].items()}


def print_stages(dtype, unit, stages, counters):
    timed = [(k, v[0]) for k, v in stages.items() if v[0] is not None]
    print(f"[{dtype}] span device ms per {unit}: " + ", ".join(f"{k} {ms:.2f}" for k, ms in timed))
    print(f"[{dtype}] span host ms per {unit}: " + ", ".join(f"{k} {v[1]:.2f}" for k, v in stages.items())
          + "; counters per " + unit + ": " + ", ".join(f"{k} {v:g}" for k, v in counters.items()))


def sort_alone_ms(net, n_scores: int):
    """CUDA-event ms of the stable sort of ``n_scores`` foreground scores
    alone (the refinement's batch top-k)."""
    flat = torch.rand(n_scores, device=net.device)
    torch.sort(flat, descending=True, stable=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.sort(flat, descending=True, stable=True)
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def train_peak_memory_gib(net, batch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_steps(net, [batch])
    return torch.cuda.max_memory_allocated() / 2**30


def profile_train(net, batches, table_path=None):
    """The profiler's view of one training step per batch."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_steps(net, batches)
        wall = time.perf_counter() - t0
    return _device_summary(prof, wall, len(batches), table_path)


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
    return dict(_device_summary(prof, wall, len(batches), table_path), dispatch_ms=t_dispatch * 1e3)


def _device_summary(prof, wall, n, table_path):
    """Device span, busy time (union of the device intervals), event count
    and device ms per unit of work by kernel class, from a finished trace."""
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
    return {"wall_ms": wall * 1e3, "span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "n_events": len(dev), "per_class_ms": {k: v / 1e3 / n for k, v in per_class.items()}}


def print_classes(per_class_ms, unit):
    total = sum(per_class_ms.values())
    for cls, ms in sorted(per_class_ms.items(), key=lambda kv: -kv[1]):
        print(f"    {cls:<20} {ms:9.2f} ms/{unit} {100 * ms / total:6.1f}%")


def main_train(args):
    os.environ["MDT_STEM_PALLAS"] = args.stem
    model = "retina_unet_train" if args.model == "retina_unet" else args.model
    batches = slice_batches(args.chunks, model)
    layout = "batch 2 x 4" if args.model == "retina_unet" else "batch 8 as one microbatch"
    print(f"training slice: {args.model} 3D 128x128x64 sf18 ef36, {layout}, remat, MDT_STEM_PALLAS={args.stem}")
    for dtype in ("float32", "bfloat16"):
        net = slice_net(dtype, model=model)
        net.current_lr = 1e-4
        train_steps(net, batches[:1])  # warm-up: cuDNN plans, kernel build and load
        print_stages(dtype, "step of 8", *span_stages(lambda: train_steps(net, batches), len(batches)))
        print(f"[{dtype}] peak device memory, one step: {train_peak_memory_gib(net, batches[0]):.2f} GiB")
        table = (os.path.join(args.out_dir, f"profile_train_{args.model}_stem{args.stem}_{dtype}.txt")
                 if args.out_dir else None)
        p = profile_train(net, batches, table)
        print(f"[{dtype}] profiled {len(batches)} steps: host wall {p['wall_ms']:.1f} ms, device span "
              f"{p['span_ms']:.1f} ms, busy {p['busy_ms']:.1f} ms, idle share {1 - p['busy_ms'] / p['span_ms']:.4f} "
              f"(of host wall: {1 - p['busy_ms'] / p['wall_ms']:.4f}); device events {p['n_events']}")
        print_classes(p["per_class_ms"], "step")
        del net
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("retina_unet", "mrcnn", "detection_unet"), default="retina_unet",
                    help="detection_unet with --train only")
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--out-dir", default=None, help="where the profiler's kernel tables go")
    ap.add_argument("--train", action="store_true", help="profile the training slice instead")
    ap.add_argument("--stem", choices=("0", "1"), default="1", help="MDT_STEM_PALLAS for --train")
    args = ap.parse_args()
    card = setup_card()
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    if args.train:
        print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
        return main_train(args)
    if args.model == "detection_unet":
        raise SystemExit("detection_unet is profiled with --train")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off; model {args.model}")
    batches = slice_batches(args.chunks, args.model)
    for dtype in ("float32", "bfloat16"):
        net = slice_net(dtype, model=args.model)
        run_window(net, batches[:1])  # warm-up: cuDNN plans, kernel build and load
        print_stages(dtype, "chunk of 8", *span_stages(lambda: run_window(net, batches), len(batches)))
        if args.model == "retina_unet":
            n_sort = len(net.anchors) * net.cf.batch_size * (net.cf.head_classes - 1)
            print(f"[{dtype}] stable sort of {n_sort} scores alone {sort_alone_ms(net, n_sort):.2f} ms")
        print(f"[{dtype}] peak device memory, one chunk: {peak_memory_gib(net, batches[0]):.2f} GiB")
        t0 = time.perf_counter()
        table = os.path.join(args.out_dir, f"profile_{args.model}_{dtype}.txt") if args.out_dir else None
        p = profile_window(net, batches, table)
        idle = 1 - p["busy_ms"] / p["span_ms"]
        print(f"[{dtype}] profiled {len(batches)}-chunk window: host wall {p['wall_ms']:.1f} ms "
              f"(dispatch {p['dispatch_ms']:.1f} ms), device span {p['span_ms']:.1f} ms, busy {p['busy_ms']:.1f} ms, "
              f"idle share {idle:.4f} (of host wall: {1 - p['busy_ms'] / p['wall_ms']:.4f}); "
              f"device events {p['n_events']}; profiling took {time.perf_counter() - t0:.1f} s")
        print_classes(p["per_class_ms"], "chunk")
        del net
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
