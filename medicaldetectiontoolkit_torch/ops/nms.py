"""Fixed-shape greedy non-maximum suppression, 2D + 3D (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/nms.py:34-115`` with the
same semantics: boxes are taken in descending score order (ties toward the
lower index), a kept box suppresses every box whose IoU with it (legacy
+1-pixel convention via ``pixel_offset``) is *strictly greater* than the
threshold, and exactly ``max_output`` select-and-suppress steps run, giving a
fixed-size index vector (-1 padded) plus a validity mask.

``batched_nms`` is the plain PyTorch version: the reference the kernel is held
against and the path CPU tensors take. ``batched_nms_auto`` dispatches on the
tensor's device: a CPU tensor goes to ``batched_nms``, a CUDA tensor to the
hand-written kernel (``ops/nms_cuda.py``), and there is no third path.
"""

from __future__ import annotations

import torch


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


def nms(boxes, scores, iou_threshold, max_output: int, valid=None, pixel_offset: float = 1.0):
    """Single-lane NMS: (N, 4|6), (N,) -> (max_output,) idx, mask."""
    idx, mask = batched_nms(
        boxes[None], scores[None], iou_threshold, max_output,
        valid=None if valid is None else valid[None], pixel_offset=pixel_offset,
    )
    return idx[0], mask[0]


def batched_nms_auto(boxes, scores, iou_threshold, max_output: int, valid=None, pixel_offset: float = 1.0):
    """Batched NMS keyed on the tensors' device.

    CPU tensors take the plain ``batched_nms``; CUDA tensors launch the
    hand-written kernel (``ops/nms_cuda.py``), which raises rather than
    falling back when it cannot build or launch.
    """
    if scores.device.type == "cpu":
        return batched_nms(boxes, scores, iou_threshold, max_output, valid=valid, pixel_offset=pixel_offset)
    if scores.device.type != "cuda":
        raise ValueError(f"no NMS implementation for device {scores.device}")
    from medicaldetectiontoolkit_torch.ops import nms_cuda

    return nms_cuda.batched_nms(boxes, scores, iou_threshold, max_output, valid=valid, pixel_offset=pixel_offset)
