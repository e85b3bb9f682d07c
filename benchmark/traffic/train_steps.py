"""Closed-loop training steps, as the program's trainer drives them: step
i + 1 is dispatched (``train_forward_dispatch``) before step i is converted
(``train_forward_convert``, without the full-volume seg copy), over a pool of
batches made from the seed and taken in turn.

Set-up makes the weights and the pool, builds the program and drives its
first steps (``first_steps``, at least two) through the same calls and the
same pipeline on distinct batches: they warm up every shape the window
uses, and they are what the reference follows. After the window closes and
the program is freed, the reference runs those steps from the same weights
and draws, and the losses, the first gradient (the program's, as its
optimizer holds it: Adam's first moment after one step over 1 - beta1) and
the parameters' change over the steps are compared (``core/compare.py``).

Parameters (the workload file's ``params``): ``pool_batches``,
``first_steps``, and the lesions' ``p_fg``, ``max_lesions``,
``lesion_min``, ``lesion_max``, ``lesion_contrast``, ``noise_std``
(``core/data.py``); ``limits``: the compared readings' limits.

End-to-end metrics: ``train_patches_per_s`` (patches of every step
converted in the window over the window's seconds: the window closes when
the last step dispatched in it is converted), ``peak_device_gib`` and
``setup_s``.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.core import compare, data, program


def run(ctx):
    p, cf = ctx.cell.params, ctx.cf
    with_masks = ctx.family.WITH_MASKS
    from benchmark.reference import models as ref

    ctx.mark("start of the driver")
    with torch.device("meta"):
        shapes = ctx.family.Module(ctx.ref_cf, remat=False)
    weights = data.make_weights(shapes, ctx.seed_for(1), ctx.device)
    pool = data.make_pool(cf, p, ctx.seed_for(2), p["pool_batches"], ctx.device, with_masks)
    draw_seed = ctx.seed_for(3)
    ctx.mark("weights and pool")
    net = program.build(ctx, weights, draw_seed)
    ctx.mark("program built")
    params = dict(net.module.named_parameters())
    n_first = p["first_steps"]
    spans = ctx.spans

    losses, first_grad, after = [], None, None
    pending = None
    for i in range(n_first):
        handles = net.train_forward_dispatch(pool[i])
        if i == 0:
            state, beta1 = net.optimizer.state, net.optimizer.param_groups[0]["betas"][0]
            # a tensor the optimizer holds no moment for has not been given a gradient: it reads as zero
            first_grad = {k: state[v]["exp_avg"].detach().clone() / (1.0 - beta1) if "exp_avg" in state.get(v, {})
                          else torch.zeros_like(v) for k, v in params.items()}
        if i == n_first - 1:
            after = {k: v.detach().clone() for k, v in params.items()}
        if pending is not None:
            losses.append(net.train_forward_convert(*pending, need_seg_preds=False)["loss"])
        pending = (handles, pool[i])
    losses.append(net.train_forward_convert(*pending, need_seg_preds=False)["loss"])

    steps, i, pending = 0, n_first, None
    ctx.start_window()
    t_close = ctx.t0 + ctx.seconds
    while True:
        with spans.span("batch pick"):
            batch = pool[i % len(pool)]
        with spans.span("dispatch"):
            handles = net.train_forward_dispatch(batch)
        steps += 1
        i += 1
        if pending is not None:
            with spans.span("convert"):
                net.train_forward_convert(*pending, need_seg_preds=False)
        pending = (handles, batch)
        if time.perf_counter() >= t_close:
            break
    with spans.span("convert"):
        net.train_forward_convert(*pending, need_seg_preds=False)
    ctx.end_window()
    peak = ctx.peak_bytes()
    del net, handles, pending, params
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(ctx.cell.config["precision"]["tf32"])
    model = program.reference_model(ctx, weights)
    gen = torch.Generator(device=ctx.device).manual_seed(draw_seed)
    batches = [data.device_batch(b, ctx.device, p["max_lesions"], with_masks) for b in pool[:n_first]]
    ref_losses, ref_grad, ref_after = ref.train_steps(model, batches, gen, ctx.ref_cf.learning_rate,
                                                      ctx.ref_cf.weight_decay, n_first)
    readings = compare.train_gaps(losses, ref_losses, first_grad, ref_grad,
                                  {k: after[k] - weights[k] for k in after},
                                  {k: ref_after[k] - weights[k] for k in ref_after})
    readings["losses"], readings["ref_losses"] = losses, ref_losses
    ctx.readings = readings
    correct, checks = compare.checks(readings, p["limits"])

    ctx.kind, ctx.requests = "train", steps
    ctx.flops_per_request = ctx.family.flops(ctx.ref_cf, train=True)
    patches_per_s = steps * cf.batch_size / ctx.window_s
    return {"correct": correct, "attempted": steps, "failed": 0, "checks": checks, "memory_peak_bytes": peak,
            "metrics": {"train_patches_per_s": patches_per_s, "peak_device_gib": peak / 2 ** 30,
                        "setup_s": ctx.setup_s}}
