"""Losses and SHEM negative mining of the one-stage detectors, fixed-shape
and masked (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/losses.py``: the anchor
class loss is CE over the positives plus CE over SHEM-sampled negatives (the
reference's choice, not focal loss), the box loss smooth-L1 over the
positives, the Retina U-Net seg loss soft batch dice plus CE. JAX ``vmap``s
the anchor losses over the batch; here the batch is the leading axis of
every argument, and ``masked_mean`` reduces each element on its own.

Random draws are arguments (``shem_select``'s ``rand``), so a test can feed
JAX's own draws. Every top-k breaks ties toward the lower index, as
``lax.top_k`` does: fg scores tie often once the softmax saturates.
"""

from __future__ import annotations

import torch

from medicaldetectiontoolkit_torch.ops.topk import top_k
from medicaldetectiontoolkit_torch.parallel import mesh


def softmax(logits):
    """Softmax over the last axis in ``jax.nn.softmax``'s operation order:
    ``exp(x - max) / sum``."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def masked_mean(values, mask, default=0.0):
    """Mean of ``values`` where ``mask``, per element of the leading axis
    over all other axes; ``default`` for an element whose mask is empty."""
    mask = mask.to(values.dtype)
    dims = tuple(range(1, values.dim()))
    count = mask.sum(dims)
    return torch.where(count > 0, (values * mask).sum(dims) / count.clamp_min(1.0), default)


def softmax_ce(logits, labels):
    """Softmax cross entropy with integer labels over the last axis; labels
    outside ``[0, n_classes)`` give 0, as JAX's one-hot sum does."""
    n = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    inside = (labels >= 0) & (labels < n)
    picked = torch.gather(logp, -1, labels.clamp(0, n - 1)[..., None])[..., 0]
    return -torch.where(inside, picked, 0.0)


def smooth_l1(pred, target):
    """Elementwise smooth-L1 (beta 1), as ``F.smooth_l1_loss`` per element."""
    diff = torch.abs(pred - target)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def shem_select(rand, fg_scores, neg_mask, n_pos, max_count: int, poolsize: int):
    """Stochastic hard example mining (``losses.py:59-102``).

    Per element: ``count = min(clip(n_pos, 1, max_count), #negatives)``;
    the pool is the top ``poolsize * count`` negatives by fg score (of a
    static top-``k_pool``, ``k_pool = min(poolsize * max_count, N)``), and
    ``count`` of them are drawn by the lowest uniform draws.

    rand (b, k_pool) uniform draws; fg_scores (b, N); neg_mask (b, N) bool;
    n_pos (b,) int. Returns the sampled negatives as a (b, N) bool mask.
    """
    bsz, N = fg_scores.shape
    count = torch.minimum(n_pos.clamp(1, max_count), neg_mask.sum(-1))[:, None]
    k_pool = min(poolsize * max_count, N)
    pool_vals, pool_idx = top_k(torch.where(neg_mask, fg_scores, float("-inf")), k_pool)
    ranks = torch.arange(k_pool, device=fg_scores.device)
    in_pool = (ranks < poolsize * count) & (pool_vals > float("-inf"))

    neg_draw, draw_pos = top_k(-torch.where(in_pool, rand, float("inf")), min(max_count, k_pool))
    take = (ranks[: draw_pos.shape[1]] < count) & torch.isfinite(neg_draw)
    # not taken -> the spare column N, dropped
    sel = torch.zeros((bsz, N + 1), dtype=torch.bool, device=fg_scores.device)
    sel.scatter_(1, torch.where(take, torch.gather(pool_idx, 1, draw_pos), N), True)
    return sel[:, :N]


def anchor_class_loss(rand, matches, class_logits, shem_poolsize: int, max_neg: int):
    """(positive CE + SHEM-negative CE) / 2 per element (``losses.py:105-125``).

    rand (b, k_pool) SHEM draws; matches (b, A) int; class_logits (b, A, C).
    Returns (losses (b,), sampled-negative mask (b, A)).
    """
    pos_mask = matches > 0
    pos_loss = masked_mean(softmax_ce(class_logits, matches.clamp_min(0)), pos_mask)
    fg_scores = softmax(class_logits)[..., 1:].amax(dim=-1)
    neg_sel = shem_select(rand, fg_scores, matches == -1, pos_mask.sum(-1), max_neg, shem_poolsize)
    neg_loss = masked_mean(softmax_ce(class_logits, torch.zeros_like(matches)), neg_sel)
    return (pos_loss + neg_loss) / 2.0, neg_sel


def anchor_bbox_loss(target_deltas, pred_deltas, matches):
    """Smooth-L1 over the positives' deltas, per element (``losses.py:128-132``)."""
    per_elem = smooth_l1(pred_deltas, target_deltas)
    return masked_mean(per_elem, (matches > 0)[..., None].expand_as(per_elem))


def fused_seg_loss(seg_logits, seg, n_classes: int, false_positive_weight: float = 1.0, class_weights=None,
                   space=None):
    """Soft batch dice over the foreground classes + CE (``losses.py:155-212``).

    seg_logits (b, C, *spatial), seg (b, 1, *spatial) int labels. The dice
    sums run over the whole batch, as the reference's batch dice does (the
    global batch in a data-parallel step: ``parallel/mesh.py::batch_sum``);
    ``false_positive_weight`` weights the predictions in the dice
    denominator. ``class_weights`` (C,) make the CE a weighted mean,
    normalised by the weights applied (``F.cross_entropy``'s ``weight=``).

    ``space``: the SpaceGroup whose ranks each hold one Y slab of
    ``seg_logits`` and ``seg`` (the detectors pass theirs where the seg path
    runs on slabs). The per-class sums, the CE's numerator and (weighted)
    its denominator are then taken on the slab and added over the group by
    one ``mesh.space_sum`` given the group, since the loss runs after the
    spatial forward, where ``mesh.space()`` is None. The sum's backward
    all-reduces, so each slab's logits get S times their gradient
    (``parallel/mesh.py``, Gradients).

    Every sum accumulates in float64 (one process, data-parallel ranks and
    slabs alike), and the dice and CE are formed in float64, then rounded to
    the logits' dtype (at least float32): the slabs' or ranks' partial sums
    then add up to the whole image's to far below float32's last bit, so a
    split step gives the one-process loss and gradient bit for bit where the
    forward does, as GroupNorm's float64 statistics do
    (``models/backbone.py``). Returns (1 - mean foreground dice, CE).
    """
    lab = seg[:, 0]
    dtype = torch.promote_types(seg_logits.dtype, torch.float32)
    acc = torch.float64
    chans = [seg_logits[:, c].to(dtype) for c in range(n_classes)]
    mx = chans[0]
    for c in range(1, n_classes):
        mx = torch.maximum(mx, chans[c])
    lse = mx + torch.log(sum(torch.exp(ch - mx) for ch in chans))
    intersect, psum, count, lp_y = [], [], [], 0.0
    for c in range(n_classes):
        m = (lab == c).to(dtype)
        logp_c = chans[c] - lse
        probs_c = torch.exp(logp_c)
        intersect.append((probs_c * m).sum(dtype=acc))
        psum.append(probs_c.sum(dtype=acc))
        count.append(m.sum(dtype=acc))
        lp_y = lp_y + logp_c * m
    sums = [*intersect, *psum, *count]
    if class_weights is None:
        sums.append(lp_y.sum(dtype=acc))
    else:
        w_vox = torch.as_tensor(class_weights, dtype=acc, device=lp_y.device)[lab.long()]
        sums += [(lp_y * w_vox).sum(), w_vox.sum()]
    total = torch.stack(sums)
    if space is not None:
        total = mesh.space_sum(total, space)
    total = mesh.batch_sum(total)
    intersect, psum, count = total[:3 * n_classes].reshape(3, n_classes)
    if class_weights is None:
        dp = mesh.current()
        n_voxels = lp_y.numel() * (1 if space is None else space.size) * (1 if dp is None else dp.world)
        ce = -total[-1] / n_voxels
    else:
        ce = -total[-2] / torch.clamp_min(total[-1], 1e-8)
    dice = (2.0 * intersect + 1e-6) / (false_positive_weight * psum + count + 1e-6)
    return (1.0 - dice[1:].mean()).to(dtype), ce.to(dtype)
