"""What a run makes from its seed: the weights, and the pool of batches
that the window cycles through.

Weights are drawn as PyTorch initialises a fresh conv or linear layer's
weight (the published configuration sets no ``weight_init``): uniform on
+-1/sqrt(fan_in). Biases are zero, as the measured package's own
``init_weights`` (and flax) make them: a drawn bias of the seg head's two
classes would set their margin at every voxel by itself, so that no rounding
of the features could ever flip a served class and the seg comparison could
not tell float32 from TF32. GroupNorm scales are 1 and shifts 0. They are
drawn on the device from one generator in one call, in float32, the type the
configurations serve in.

A batch holds ``batch_size`` LIDC-like patches of one channel: soft tissue
noise, and in a share ``p_fg`` of them (as the LIDC loader draws
foreground patches) 1 to ``max_lesions`` box-shaped nodules of LIDC's size
range, brighter than their background, with their boxes, class ids (benign
or malignant), seg labels and per-lesion masks. The patches' noise is drawn
on the device; the lesions' geometry on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def make_weights(module: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``module``'s parameters (names and shapes), drawn
    from ``seed`` on ``device``."""
    params = dict(module.named_parameters())
    bounds, numels = [], []
    for name, p in params.items():
        if p.dim() >= 2:
            bounds.append(1.0 / math.sqrt(p.shape[1] * math.prod(p.shape[2:])))
        else:
            bounds.append(0.0)  # a bias or a norm's shift (zero), a norm's scale (one): set below
        numels.append(p.numel())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(numels), generator=gen, device=device)
    scale = torch.repeat_interleave(torch.tensor(bounds, device=device), torch.tensor(numels, device=device))
    flat = (2.0 * flat - 1.0) * scale
    out = {}
    for (name, p), part in zip(params.items(), torch.split(flat, numels)):
        if p.dim() < 2:
            part = torch.full_like(part, 1.0 if name.endswith("weight") else 0.0)
        out[name] = part.reshape(p.shape)
    return out


def _lesions(rng, n_max, size_min, size_max, patch):
    """1..n_max boxes (y1, x1, y2, x2, z1, z2) of sizes drawn in
    [size_min, size_max] per axis, inside ``patch``."""
    boxes = []
    for _ in range(int(rng.integers(1, n_max + 1))):
        size = [int(rng.integers(lo, hi + 1)) for lo, hi in zip(size_min, size_max)]
        lo = [int(rng.integers(0, s - e + 1)) for s, e in zip(patch, size)]
        boxes.append([lo[0], lo[1], lo[0] + size[0], lo[1] + size[1], lo[2], lo[2] + size[2]])
    return boxes


def make_pool(cf, params: dict, seed: int, n_batches: int, device, with_masks: bool):
    """``n_batches`` batch dicts in the program's data contract (numpy,
    channel-first), drawn from ``seed``: ``data``, ``seg``, ``bb_target``,
    ``roi_labels``, ``pid`` and, with ``with_masks``, ``roi_masks``."""
    rng = np.random.default_rng([seed, 1])
    bsz, patch = cf.batch_size, tuple(cf.patch_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((n_batches * bsz, cf.n_channels, *patch), generator=gen, device=device)
    data = (noise * params["noise_std"]).cpu().numpy()
    pool = []
    for i in range(n_batches):
        img = data[i * bsz:(i + 1) * bsz]
        seg = np.zeros((bsz, 1) + patch, np.uint8)
        boxes, labels, masks = [], [], []
        for b in range(bsz):
            found = (_lesions(rng, params["max_lesions"], params["lesion_min"], params["lesion_max"], patch)
                     if rng.random() < params["p_fg"] else [])
            m = np.zeros((len(found), 1) + patch, np.uint8)
            for j, (y1, x1, y2, x2, z1, z2) in enumerate(found):
                img[b, :, y1:y2, x1:x2, z1:z2] += params["lesion_contrast"]
                seg[b, 0, y1:y2, x1:x2, z1:z2] = 1
                m[j, 0, y1:y2, x1:x2, z1:z2] = 1
            boxes.append(np.asarray(found, np.float32).reshape(-1, 6))
            labels.append(rng.integers(1, cf.head_classes, size=len(found)))
            masks.append(m)
        batch = {"data": img, "seg": seg, "bb_target": boxes, "roi_labels": labels,
                 "pid": [f"{i}_{b}" for b in range(bsz)]}
        if with_masks:
            batch["roi_masks"] = masks
        pool.append(batch)
    return pool


def device_batch(batch, device, max_gt: int, with_masks: bool):
    """A batch dict on the device as the reference takes it: image, GT boxes
    (b, max_gt, 6), class ids, valid flags, and the seg labels or the GT
    masks (b, max_gt, *spatial) uint8."""
    bsz = batch["data"].shape[0]
    boxes = np.zeros((bsz, max_gt, 6), np.float32)
    ids = np.zeros((bsz, max_gt), np.int32)
    valid = np.zeros((bsz, max_gt), bool)
    masks = np.zeros((bsz, max_gt) + batch["data"].shape[2:], np.uint8) if with_masks else None
    for b in range(bsz):
        n = len(batch["bb_target"][b])
        boxes[b, :n], ids[b, :n], valid[b, :n] = batch["bb_target"][b], batch["roi_labels"][b], True
        if with_masks and n:
            masks[b, :n] = batch["roi_masks"][b][:, 0]
    last = masks if with_masks else batch["seg"].astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (batch["data"], boxes, ids, valid, last))
