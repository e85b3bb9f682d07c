"""Closed-loop served chunks, as the program's Predictor drives them: each
chunk of ``batch_size`` patches is dispatched (``test_forward_dispatch``,
masks as the configuration's ``return_masks_in_test``), and once
``in_flight`` chunks are pending the oldest is converted
(``test_forward_convert``), over a pool of chunks made from the seed and
taken in turn. A request is one chunk, timed from its dispatch call to the
end of its convert. The window stops dispatching after ``--seconds`` and
closes when every chunk dispatched in it is converted.

Set-up makes the weights and the pool, builds the program and warms up
with ``warmup_chunks`` chunks through the window's own pipeline, so that
the window starts with the allocator and the queue as they stay (at least
two rounds of ``in_flight``). A sample of the pool's chunks is drawn from
the seed (``judged_chunks`` of them); every answer the window served for
them is kept. After the window closes and the program is freed, the
reference runs each sampled chunk and judges each distinct answer served
for it (``core/compare.py``): the detections (``det_gap``) and, where the
detector serves a seg head's argmax, the seg preds (``seg_gap``).

Parameters (the workload file's ``params``): ``pool_batches``,
``in_flight``, ``warmup_chunks``, ``judged_chunks``, the patches'
``noise_std``, the lesions' ``p_fg``, ``max_lesions``, ``lesion_min``,
``lesion_max``, ``lesion_contrast`` (``core/data.py``); ``limits``.

End-to-end metrics: ``infer_patches_per_s`` (patches of every chunk
converted in the window over the window's seconds), ``infer_p95_ms`` (the
95th percentile of all the window's requests), ``peak_device_gib`` and
``setup_s``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.core import compare, data, program


def run(ctx):
    p, cf = ctx.cell.params, ctx.cf

    ctx.mark("start of the driver")
    with torch.device("meta"):
        shapes = ctx.family.Module(ctx.ref_cf, remat=False)
    weights = data.make_weights(shapes, ctx.seed_for(1), ctx.device)
    pool = data.make_pool(cf, p, ctx.seed_for(2), p["pool_batches"], ctx.device, with_masks=False)
    judged = set(np.random.default_rng(ctx.seed_for(4)).choice(len(pool), p["judged_chunks"], replace=False).tolist())
    ctx.mark("weights and pool")
    net = program.build(ctx, weights, ctx.seed_for(3))
    ctx.mark("program built")
    masks = bool(cf.return_masks_in_test)
    spans = ctx.spans

    def serve(more, done):
        """The closed loop: dispatch the pool's chunks in turn while
        ``more(dispatched)``, converting the oldest once ``in_flight`` are
        pending, then convert the rest. ``done(chunk, answer, seconds)``
        for each. Returns the number dispatched."""
        pending, n = [], 0

        def convert():
            idx, handles, t_start = pending.pop(0)
            with spans.span("convert"):
                res = net.test_forward_convert(handles, pool[idx])
            done(idx, res, time.perf_counter() - t_start)

        while more(n):
            with spans.span("batch pick"):
                idx = n % len(pool)
            t_start = time.perf_counter()
            with spans.span("dispatch"):
                handles = net.test_forward_dispatch(pool[idx], return_masks=masks)
            pending.append((idx, handles, t_start))
            n += 1
            if len(pending) >= p["in_flight"]:
                convert()
        while pending:
            convert()
        return n

    # the warm-up runs the window's own pipeline, ``in_flight`` deep, for ``warmup_chunks``
    serve(lambda n: n < p["warmup_chunks"], lambda *_: None)

    served = {i: [] for i in judged}
    latencies = []

    def done(idx, res, seconds):
        latencies.append(seconds)
        if idx in served:
            served[idx].append(res)

    ctx.start_window()
    t_close = ctx.t0 + ctx.seconds
    i = serve(lambda n: time.perf_counter() < t_close, done)
    ctx.end_window()
    peak = ctx.peak_bytes()
    del net
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(ctx.cell.config["precision"]["tf32"])
    model = program.reference_model(ctx, weights)
    det_gap = seg_gap = 0.0
    for idx in sorted(served):
        answers = _distinct(served[idx])
        if not answers:
            continue
        cand, seg_logits = model.infer(torch.from_numpy(pool[idx]["data"]).to(ctx.device))
        cand = {k: v.cpu().numpy() for k, v in cand.items()}
        for res in answers:
            det_gap = max(det_gap, compare.detection_gap(ctx.ref_cf, compare.served_rows(res["boxes"]), cand))
            if seg_logits is not None:
                seg_gap = max(seg_gap, compare.seg_gap(res["seg_preds"], seg_logits))
        del seg_logits
    readings = {"det_gap": det_gap, "seg_gap": seg_gap}
    ctx.readings = readings
    correct, checks = compare.checks(readings, p["limits"])

    n = len(latencies)
    ctx.kind, ctx.requests = "infer", n
    ctx.flops_per_request = ctx.family.flops(ctx.ref_cf, train=False)
    p95 = float(np.percentile(np.asarray(latencies) * 1e3, 95))
    return {"correct": correct, "attempted": i, "failed": i - n, "checks": checks, "memory_peak_bytes": peak,
            "metrics": {"infer_patches_per_s": n * cf.batch_size / ctx.window_s, "infer_p95_ms": p95,
                        "peak_device_gib": peak / 2 ** 30, "setup_s": ctx.setup_s}}


def _distinct(results):
    """The distinct answers among a chunk's served results."""
    out = []
    for r in results:
        if not any(_same(r, o) for o in out):
            out.append(r)
    return out


def _same(a, b):
    rows_a, rows_b = compare.served_rows(a["boxes"]), compare.served_rows(b["boxes"])
    return (np.array_equal(a["seg_preds"], b["seg_preds"])
            and all(all(np.array_equal(x, y) for x, y in zip(ra, rb)) for ra, rb in zip(rows_a, rows_b)))
