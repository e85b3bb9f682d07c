"""Plain PyTorch operations of the reference detectors: exact top-k, box
arithmetic, pyramid anchors, greedy NMS, RoIAlign, the anchor and seg
losses, SHEM and anchor matching.

A frozen copy of the measured package's plain operations (the versions its
CPU tests hold against the original toolkit's JAX port), cut to one process:
no data-parallel or spatial collectives, no CUDA kernel. It imports nothing
of the measured package, so a change there cannot move the yardstick.
"""

from __future__ import annotations

import math

import torch


def top_k(x, k: int, dim: int = -1):
    """The ``k`` largest values along ``dim`` and their indices, ties toward
    the lower index as ``lax.top_k`` breaks them: a stable descending sort,
    sliced. ``torch.topk`` promises no tie order."""
    vals, idx = x.sort(dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def box_dim(boxes) -> int:
    """Spatial rank (2 or 3) of a (..., 4|6) box tensor."""
    n = boxes.shape[-1]
    if n == 4:
        return 2
    if n == 6:
        return 3
    raise ValueError(f"box array must have 4 or 6 trailing coords, got {n}")


def _split_corners(boxes):
    """Return per-axis (lo, hi) corner lists ordered (y, x, (z))."""
    dim = box_dim(boxes)
    lo = [boxes[..., 0], boxes[..., 1]]
    hi = [boxes[..., 2], boxes[..., 3]]
    if dim == 3:
        lo.append(boxes[..., 4])
        hi.append(boxes[..., 5])
    return lo, hi


def box_area(boxes, pixel_offset: float = 0.0):
    """Area (2D) or volume (3D) of boxes; (...,) result (``boxes.py:42-51``)."""
    lo, hi = _split_corners(boxes)
    area = torch.ones(boxes.shape[:-1], dtype=boxes.dtype, device=boxes.device)
    for l, h in zip(lo, hi):
        area = area * (h - l + pixel_offset)
    return area


def pairwise_iou(boxes1, boxes2, pixel_offset: float = 0.0):
    """IoU matrix between two box sets: (..., N, 2*dim), (..., M, 2*dim) ->
    (..., N, M), leading dims broadcast (anchors (A, 2*dim) against a batch
    of GTs (b, G, 2*dim) gives (b, A, G)).

    Degenerate boxes give IoU 0 via the max(., 0) clamps; a 0/0 union is
    guarded to avoid NaN (``boxes.py:54-73``).
    """
    lo1, hi1 = _split_corners(boxes1)
    lo2, hi2 = _split_corners(boxes2)
    inter = None
    for l1, h1, l2, h2 in zip(lo1, hi1, lo2, hi2):
        seg = torch.clamp_min(
            torch.minimum(h1[..., :, None], h2[..., None, :]) - torch.maximum(l1[..., :, None], l2[..., None, :])
            + pixel_offset,
            0.0,
        )
        inter = seg if inter is None else inter * seg
    area1 = box_area(boxes1, pixel_offset)
    area2 = box_area(boxes2, pixel_offset)
    union = area1[..., :, None] + area2[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def apply_box_deltas(boxes, deltas):
    """Decode (dy, dx, (dz), log dh, log dw, (log dd)) deltas onto boxes.

    center += delta * size; size *= exp(log-delta). Output order
    (y1, x1, y2, x2, (z1, z2)); any leading dims (``boxes.py:76-102``).
    """
    dim = box_dim(boxes)
    lo, hi = _split_corners(boxes)
    new_lo, new_hi = [], []
    for ax in range(dim):
        size = hi[ax] - lo[ax]
        center = lo[ax] + 0.5 * size
        center = center + deltas[..., ax] * size
        size = size * torch.exp(deltas[..., dim + ax])
        l = center - 0.5 * size
        new_lo.append(l)
        new_hi.append(l + size)
    cols = [new_lo[0], new_lo[1], new_hi[0], new_hi[1]]
    if dim == 3:
        cols += [new_lo[2], new_hi[2]]
    return torch.stack(cols, dim=-1)


def box_refinement(boxes, gt_boxes):
    """Encode the delta taking ``boxes`` onto ``gt_boxes``; inverse of
    ``apply_box_deltas`` (``boxes.py:105-123``)."""
    dim = box_dim(boxes)
    lo, hi = _split_corners(boxes)
    glo, ghi = _split_corners(gt_boxes)
    centers, logs = [], []
    for ax in range(dim):
        size = hi[ax] - lo[ax]
        center = lo[ax] + 0.5 * size
        gsize = ghi[ax] - glo[ax]
        gcenter = glo[ax] + 0.5 * gsize
        centers.append((gcenter - center) / size)
        logs.append(torch.log(gsize / size))
    return torch.stack(centers + logs, dim=-1)


def clip_boxes(boxes, window):
    """Clip box corners to a window (y1, x1, y2, x2, (z1, z2))
    (``boxes.py:126-143``)."""
    window = torch.as_tensor(window, dtype=boxes.dtype, device=boxes.device)
    dim = box_dim(boxes)
    cols = [
        torch.clamp(boxes[..., 0], window[0], window[2]),
        torch.clamp(boxes[..., 1], window[1], window[3]),
        torch.clamp(boxes[..., 2], window[0], window[2]),
        torch.clamp(boxes[..., 3], window[1], window[3]),
    ]
    if dim == 3:
        cols.append(torch.clamp(boxes[..., 4], window[4], window[5]))
        cols.append(torch.clamp(boxes[..., 5], window[4], window[5]))
    return torch.stack(cols, dim=-1)


def generate_anchors(scales_xy, ratios, feature_shape, feature_stride_xy, anchor_stride=1,
                     scales_z=None, feature_stride_z=None):
    """All anchors of one pyramid level: (P*A, 2*dim) float64,
    (y1, x1, y2, x2, (z1, z2)).

    ``scales_*`` in pixels, ``ratios`` = width/height, ``feature_shape`` the
    level's (y, x, (z)) extent, ``feature_stride_*`` pixels per feature cell.
    2D when ``scales_z`` is None (``anchors.py:21-48``), 3D otherwise
    (``anchors.py:51-98``).
    """
    f64 = dict(dtype=torch.float64)
    # per-position anchor order: ratio-major, scale-minor. The A extents are
    # host floats: math.sqrt is correctly rounded like np.sqrt, while
    # torch.sqrt on the CPU can differ in the last bit
    pairs = [(float(s), math.sqrt(float(r))) for r in ratios for s in scales_xy]
    extents = [[s / q for s, q in pairs], [s * q for s, q in pairs]]  # heights, widths
    strides = [feature_stride_xy, feature_stride_xy]
    if scales_z is not None:
        extents.append([float(z) for z in scales_z] * (len(pairs) // len(scales_z)))
        strides.append(feature_stride_z)
    extents = [torch.tensor(e, **f64) for e in extents]  # (A,) each

    axes = [torch.arange(0, n, anchor_stride, **f64) * s for n, s in zip(feature_shape, strides)]
    centers = [c.reshape(-1, 1) for c in torch.meshgrid(*axes, indexing="ij")]  # (P, 1) each, row-major
    lo = [c - 0.5 * e for c, e in zip(centers, extents)]  # (P, A) per axis
    hi = [c + 0.5 * e for c, e in zip(centers, extents)]
    cols = [lo[0], lo[1], hi[0], hi[1]] + ([lo[2], hi[2]] if scales_z is not None else [])
    return torch.stack(cols, dim=-1).reshape(-1, len(cols))


def generate_pyramid_anchors(cf, logger=None):
    """Anchors of every configured pyramid level, concatenated: (N, 2*dim)
    float64 on the CPU (``anchors.py:102-135``).

    Reads ``rpn_anchor_scales`` {'xy': .., 'z': ..}, ``rpn_anchor_ratios``,
    ``backbone_shapes``, ``backbone_strides``, ``rpn_anchor_stride`` and
    ``pyramid_levels``.
    """
    anchors = []
    for level in cf.pyramid_levels:
        shape = [int(s) for s in cf.backbone_shapes[level]]
        is_3d = len(shape) == 3
        a = generate_anchors(
            cf.rpn_anchor_scales["xy"][level],
            cf.rpn_anchor_ratios,
            shape,
            cf.backbone_strides["xy"][level],
            cf.rpn_anchor_stride,
            scales_z=cf.rpn_anchor_scales["z"][level] if is_3d else None,
            feature_stride_z=cf.backbone_strides["z"][level] if is_3d else None,
        )
        if logger is not None:
            logger.info(f"level {level}: built anchors {tuple(a.shape)}")
        anchors.append(a)
    return torch.cat(anchors, dim=0)


def _iou_rows(win, boxes, pixel_offset: float):
    """IoU of each lane's winner (L, 2*dim) against its boxes (L, N, 2*dim).

    float32 operation order of ``nms.py:34-47`` / ``nms_pallas.py:45-59``:
    inter starts at 1 and takes max(min(hi) - max(lo) + off, 0) per axis in
    order y, x, z; areas are products of (hi - lo + off); union =
    area_winner + area_all - inter; iou = inter / union where union > 0.
    """
    dim = boxes.shape[-1] // 2
    L, N = boxes.shape[:2]
    inter = torch.ones((L, N), dtype=torch.float32, device=boxes.device)
    area_w = torch.ones((L, 1), dtype=torch.float32, device=boxes.device)
    area_all = torch.ones((L, N), dtype=torch.float32, device=boxes.device)
    for ax in range(dim):
        lo_i, hi_i = (0, 2) if ax == 0 else (1, 3) if ax == 1 else (4, 5)
        wlo, whi = win[:, lo_i, None], win[:, hi_i, None]
        lo, hi = boxes[..., lo_i], boxes[..., hi_i]
        seg = torch.minimum(whi, hi) - torch.maximum(wlo, lo) + pixel_offset
        inter = inter * torch.clamp_min(seg, 0.0)
        area_w = area_w * (whi - wlo + pixel_offset)
        area_all = area_all * (hi - lo + pixel_offset)
    union = area_w + area_all - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def batched_nms(boxes, scores, iou_threshold, max_output: int, valid=None, pixel_offset: float = 1.0):
    """Greedy NMS over L independent lanes, plain PyTorch.

    Args:
      boxes: (L, N, 4|6) corner boxes (need not be sorted; a stride-0 lane
        axis from ``expand`` is fine).
      scores: (L, N); higher wins, ties toward the lower index.
      iou_threshold: suppress where IoU > threshold (rounded to float32 once).
      max_output: number of keep slots per lane.
      valid: optional (L, N) bool; False entries are never selected.
      pixel_offset: 1.0 for the +1-pixel IoU convention, 0.0 for plain IoU.

    Returns:
      keep_idx (L, max_output) int32, -1 padded; keep_mask (L, max_output) bool.
    """
    L, N = scores.shape
    dev = scores.device
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    active = scores.to(torch.float32)
    if valid is not None:
        active = torch.where(valid, active, neg_inf)
    boxes = boxes.to(torch.float32)
    thresh = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    lanes = torch.arange(L, device=dev)
    cols = torch.arange(N, device=dev)
    keep_idx = torch.full((L, max_output), -1, dtype=torch.int32, device=dev)
    keep_mask = torch.zeros((L, max_output), dtype=torch.bool, device=dev)
    if N == 0:
        return keep_idx, keep_mask
    for i in range(max_output):
        best = torch.argmax(active, dim=1)  # first maximum: lower index wins ties
        ok = active[lanes, best] > neg_inf
        keep_idx[:, i] = torch.where(ok, best.to(torch.int32), torch.full_like(best, -1, dtype=torch.int32))
        keep_mask[:, i] = ok
        iou = _iou_rows(boxes[lanes, best], boxes, pixel_offset)
        kill = (iou > thresh) | (cols[None, :] == best[:, None])
        active = torch.where(ok[:, None] & kill, neg_inf, active)
    return keep_idx, keep_mask


def _axis_coords(lo, hi, crop: int, size: int):
    """Source coords for one axis; lo/hi (N,) normalised, returns (N, crop)."""
    if crop > 1:
        scale = (hi - lo) * size / crop
        cells = torch.arange(crop, dtype=lo.dtype, device=lo.device)
        coords = lo[:, None] * size + cells[None, :] * scale[:, None] + scale[:, None] / 2 - 0.5
    else:
        coords = (0.5 * (lo + hi) * size)[:, None]
    return torch.clamp(coords, 0.0, float(size - 1))


def _lerp_weights(coords, size: int):
    """floor index, +1-clamped index (int32) and lerp weight for linear interp."""
    idx0 = torch.floor(coords)
    lerp = coords - idx0
    idx0 = idx0.to(torch.int32)
    idx1 = torch.clamp_max(idx0 + 1, size - 1)
    return idx0, idx1, lerp


# (lo, hi) box columns of each axis in the (y1, x1, y2, x2, z1, z2) layout
_AXIS_COLS = ((0, 2), (1, 3), (4, 5))


def roi_axes(boxes, crop_size, sizes):
    """Per axis (y, x, (z)) of the crops of ``boxes`` (N, 2d) normalised:
    the floor index and the +1-clamped index (int32, (N, crop)) and the lerp
    weight (float32), from the whole map's extents ``sizes``."""
    boxes = boxes.to(torch.float32)
    return [_lerp_weights(_axis_coords(boxes[:, lo], boxes[:, hi], crop, int(size)), int(size))
            for (lo, hi), crop, size in zip(_AXIS_COLS, crop_size, sizes)]


def roi_lerp(top, bottom, axes, crop_size):
    """The lerps of ``roi_align`` after its y-gather: ``top`` / ``bottom``
    (N, ch, W, (Z,) C) are the map's rows ``axes[0][0]`` / ``axes[0][1]`` of
    each crop, channel-last; ``axes`` is ``roi_axes``'. Lerps y, then x,
    then z; returns (N, C, *crop_size)."""
    dim = len(crop_size)
    n = top.shape[0]
    dev = top.device
    (_, _, ly), (x0, x1, lx) = axes[0], axes[1]
    tail = (None,) * dim  # (W, (Z,) C) after the y-gather
    w_y = ly[(...,) + tail]
    out = top * (1 - w_y) + bottom * w_y  # (N, ch, W, (Z,) C)
    n_ix = torch.arange(n, device=dev)[:, None, None]
    h_ix = torch.arange(crop_size[0], device=dev)[None, :, None]
    w_x = lx[(slice(None), None, slice(None)) + tail[1:]]
    out = out[n_ix, h_ix, x0.long()[:, None, :]] * (1 - w_x) + out[n_ix, h_ix, x1.long()[:, None, :]] * w_x
    if dim == 3:
        z0, z1, lz = axes[2]
        n_ix3 = torch.arange(n, device=dev)[:, None, None, None]
        h_ix3 = torch.arange(crop_size[0], device=dev)[None, :, None, None]
        w_ix3 = torch.arange(crop_size[1], device=dev)[None, None, :, None]
        w_z = lz[:, None, None, :, None]
        front = out[n_ix3, h_ix3, w_ix3, z0.long()[:, None, None, :]]
        back = out[n_ix3, h_ix3, w_ix3, z1.long()[:, None, None, :]]
        out = front * (1 - w_z) + back * w_z
    return out.movedim(-1, 1)  # (N, C, *crop)


def roi_align(image, boxes, box_indices, crop_size):
    """Crop-and-resize RoIs out of one feature map: the rows each crop reads
    gathered (``roi_axes``), then lerped (``roi_lerp``).

    image (B, C, H, W) or (B, C, H, W, Z), any float dtype; boxes (N, 4|6)
    normalised; box_indices (N,) batch element of each box; crop_size
    (ch, cw) or (ch, cw, cz). Returns (N, C, *crop_size) in the promoted
    dtype of the image and float32 (float32 for bf16/f16 maps, as JAX).
    """
    dim = len(crop_size)
    if dim not in (2, 3) or image.dim() != dim + 2:
        raise ValueError(f"crop_size {crop_size} does not fit a map of shape {tuple(image.shape)}")
    axes = roi_axes(boxes, crop_size, image.shape[2:])
    # a channel-last view, so the gathers are those of the JAX code
    img = image.movedim(1, -1)
    b_ix = box_indices.long()[:, None]
    y0, y1, _ = axes[0]
    return roi_lerp(img[b_ix, y0.long()], img[b_ix, y1.long()], axes, crop_size)


def pyramid_roi_align(feature_maps, boxes, box_indices, levels_idx, crop_size):
    """Level-routed RoIAlign over an FPN pyramid, plain PyTorch: every RoI is
    cropped from every level and the assigned level's crop kept
    (``pyramid_roi_align_xla``).

    feature_maps: sequence of (B, C, *spatial_l), one dtype; boxes (R, 2*dim)
    normalised; box_indices, levels_idx (R,) int. Returns (R, C, *crop_size)
    float32 (bf16/f16 maps are promoted, as in JAX).
    """
    pooled = None
    for lvl, fmap in enumerate(feature_maps):
        crop = roi_align(fmap, boxes, box_indices, crop_size)
        sel = (levels_idx == lvl).reshape((-1,) + (1,) * (crop.dim() - 1))
        masked = torch.where(sel, crop, torch.zeros((), dtype=crop.dtype, device=crop.device))
        pooled = masked if pooled is None else pooled + masked
    return pooled.to(torch.float32)


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


def fused_seg_loss(seg_logits, seg, n_classes: int):
    """Soft batch dice over the foreground classes + CE, the sums taken over
    the whole batch in float64, then rounded to float32. seg_logits (b, C,
    *spatial), seg (b, 1, *spatial) int labels. Returns (1 - mean
    foreground dice, CE)."""
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
    total = torch.stack([*intersect, *psum, *count, lp_y.sum(dtype=acc)])
    intersect, psum, count = total[:3 * n_classes].reshape(3, n_classes)
    ce = -total[-1] / lp_y.numel()
    dice = (2.0 * intersect + 1e-6) / (psum + count + 1e-6)
    return (1.0 - dice[1:].mean()).to(dtype), ce.to(dtype)


def gt_anchor_matching(rand, anchors, gt_boxes, gt_class_ids, gt_valid, pos_iou_threshold, neg_iou_threshold,
                       max_pos: int, bbox_std_dev):
    """Match padded GT boxes to anchors, per batch element.

    Args:
      rand: (b, A) uniform draws in [0, 1) for the positive subsampling.
      anchors: (A, 2*dim) float32 anchors in pixel coords.
      gt_boxes: (b, G, 2*dim) float32 GT boxes, zero-padded.
      gt_class_ids: (b, G) int class ids.
      gt_valid: (b, G) bool padding mask.
      pos_iou_threshold: ``cf.anchor_matching_iou``.
      neg_iou_threshold: 0.1 in 2D, 0.01 in 3D.
      max_pos: ``cf.rpn_train_anchors_per_image``; at most ``max_pos // 2``
        positives survive.
      bbox_std_dev: (2*dim,) float32 tensor normalising the delta targets.

    Returns:
      matches (b, A) int32: class id > 0 positive, -1 negative, 0 neutral;
      delta_targets (b, A, 2*dim) float32, zero where ``matches <= 0``.
    """
    bsz, G = gt_valid.shape
    A = anchors.shape[0]
    dev = anchors.device
    gt_boxes = gt_boxes.to(torch.float32)
    gt_class_ids = gt_class_ids.to(torch.int32)

    # running best IoU over GT chunks of 8, as JAX: strict '>' keeps the
    # first maximal GT, argmax the first maximal anchor and GT within a chunk
    chunk = min(8, G)
    run_max = torch.full((bsz, A), float("-inf"), dtype=torch.float32, device=dev)
    run_arg = torch.zeros((bsz, A), dtype=torch.int64, device=dev)
    gt_best_parts = []
    for g0 in range(0, G, chunk):
        cols = pairwise_iou(anchors, gt_boxes[:, g0:g0 + chunk])  # (b, A, c)
        cols = torch.where(gt_valid[:, None, g0:g0 + chunk], cols, -1.0)
        gt_best_parts.append(torch.argmax(cols, dim=1))  # best anchor per GT
        cmax = cols.amax(dim=2)
        carg = torch.argmax(cols, dim=2) + g0
        better = cmax > run_max
        run_max = torch.where(better, cmax, run_max)
        run_arg = torch.where(better, carg, run_arg)
    gt_best_anchor = torch.cat(gt_best_parts, dim=1)  # (b, G)
    matched_class = torch.gather(gt_class_ids, 1, run_arg)

    matches = torch.where(run_max < neg_iou_threshold, -1, 0).to(torch.int32)
    # force-match each valid GT's best anchor; invalid GTs write the spare
    # column A, which is dropped
    padded = torch.cat([matches, torch.zeros((bsz, 1), dtype=torch.int32, device=dev)], dim=1)
    scatter_ix = torch.where(gt_valid, gt_best_anchor, A)
    matches = padded.scatter(1, scatter_ix, gt_class_ids)[:, :A]
    matches = torch.where(run_max >= pos_iou_threshold, matched_class, matches)
    matches = torch.where(gt_valid.any(dim=1, keepdim=True), matches, -1)

    # random positive subsampling: keep the max_pos // 2 positives with the
    # lowest draws (an exact top-k: positives cluster in index space)
    pos = matches > 0
    k = min(max(max_pos // 2, 1), A)
    neg_vals, keep_idx = top_k(-torch.where(pos, rand, float("inf")), k, dim=1)
    keep = torch.zeros((bsz, A + 1), dtype=torch.bool, device=dev)
    keep.scatter_(1, torch.where(torch.isfinite(neg_vals), keep_idx, A), True)
    matches = torch.where(pos & ~keep[:, :A], 0, matches)

    target_gt = torch.gather(gt_boxes, 1, run_arg[..., None].expand(bsz, A, gt_boxes.shape[-1]))
    anchors = anchors.to(torch.float32).expand(bsz, A, anchors.shape[-1])
    positive = (matches > 0)[..., None]
    # degenerate padded GTs would give log(0): rows off the positives decode
    # the anchor onto itself and are zeroed anyway
    safe_gt = torch.where(positive, target_gt, anchors)
    deltas = box_refinement(anchors, safe_gt) / bbox_std_dev
    return matches, torch.where(positive, deltas, 0.0)
