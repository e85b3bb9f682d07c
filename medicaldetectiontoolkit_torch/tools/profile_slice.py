"""Where the time of a served slice, or of the training slice, goes on one
CUDA card.

    python3 -m medicaldetectiontoolkit_torch.tools.profile_slice [--model retina_unet|mrcnn] [--out-dir DIR]
    python3 -m medicaldetectiontoolkit_torch.tools.profile_slice --train [--model retina_unet|mrcnn|detection_unet]
        [--stem 0|1] [--out-dir DIR]

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
    device time per chunk by kernel class (each hand-written kernel a class
    of its own, K4's two launches apart). With ``--out-dir`` the profiler's
    table of kernels goes to ``DIR/profile_<model>_<dtype>.txt``.

With ``--train``, the training slice (``make_train_slice_config``: 3D Retina
U-Net at LIDC width, batch 2 x 4, remat; with ``--model mrcnn`` the Mask
R-CNN slice, ``make_mrcnn_slice_config``, batch 8 as one microbatch, remat;
with ``--model detection_unet`` the Detection U-Net slice,
``make_det_unet_slice_config``, the same layout, whose "refine" stage is the
softmax's copy to the host, queued as its dispatch queues it, and whose
profiled steps include the host's connected components in each convert)
with ``MDT_STEM_PALLAS`` set to
``--stem`` (default 1: the stem kernels K3/K4): per-step CUDA-event stage
times (upload, forward + loss and backward summed over the microbatches,
optimizer, refine), the peak device memory of one step, and the profiler's
view of three steps (host wall, device busy and idle share, device time per
step by kernel class).
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from medicaldetectiontoolkit_torch.models.base import (host_to_device, merge_microbatch_aux, resolve_grad_accum,
                                                       start_host_copies)
from medicaldetectiontoolkit_torch.models.mrcnn import refine_detections
from medicaldetectiontoolkit_torch.ops.losses import softmax
from medicaldetectiontoolkit_torch.tools.common import (run_window, setup_card, slice_batches, slice_net,
                                                         train_steps)

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
            det, det_mask = refine_detections(flat_rois, softmax(logits), bbox, batch_ix, cf, img.shape[0])
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


TRAIN_STAGES = ("upload", "forward + loss", "backward", "optimizer", "refine")


def train_stage_times(net, batches):
    """Mean CUDA-event ms per step of each training stage: the composition of
    ``train_forward_dispatch`` with events between its parts (forward + loss
    and backward summed over the microbatches; for Mask R-CNN "refine" is
    the refinement per microbatch and the merge)."""
    two_stage = hasattr(net, "_merge")
    seg_only = not hasattr(net, "draws")  # Detection U-Net: no draws, no refinement
    sums = dict.fromkeys(TRAIN_STAGES, 0.0)
    params = list(net.module.parameters())
    for b in batches:
        marks = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        mark(None)
        inputs = net._prep(b)
        mark("upload")
        bsz = inputs[0].shape[0]
        n_micro = resolve_grad_accum(net.cf, bsz)
        m = bsz // n_micro
        draws = None if seg_only else net.draws(n_micro, m)
        for p in params:
            p.grad = None
        auxs = []
        for i in range(n_micro):
            part = [None if t is None else t[i * m:(i + 1) * m] for t in inputs]
            if seg_only:
                loss, aux = net._losses(*part)
            elif two_stage:
                loss, aux = net._losses(part, [d[i] for d in draws])
            else:
                loss, aux = net._losses_and_outputs(*part, *(d[i] for d in draws))
            mark("forward + loss")
            loss.backward()
            mark("backward")
            auxs.append(aux)
        for p in params:
            if p.grad is None:  # not reached by the loss: zero, as accum_backward gives it
                p.grad = torch.zeros_like(p)
            else:
                p.grad.div_(n_micro)
        net._update()
        mark("optimizer")
        with torch.no_grad():
            if seg_only:
                start_host_copies([loss.detach(), torch.cat(auxs)])
            elif two_stage:
                net._merge(auxs, m)
            else:
                net._finalize_outputs(*merge_microbatch_aux(auxs)["heads"])
        mark("refine")
        torch.cuda.synchronize()
        for (_, start), (stage, end) in zip(marks, marks[1:]):
            sums[stage] += start.elapsed_time(end)
    return {k: v / len(batches) for k, v in sums.items()}


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
        stages = train_stage_times(net, batches)
        print(f"[{dtype}] CUDA-event stage ms per step of 8: "
              + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()) + f"; device total {sum(stages.values()):.2f}")
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
        print_classes(p["per_class_ms"], "chunk")
        del net
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
