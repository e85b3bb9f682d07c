"""Helpers shared by the measurement scripts: the card's identity, float32
precision switches, the served slices and the training slice, one pipelined
window of chunks, and timed training steps."""

from __future__ import annotations

import subprocess
import time

import torch

from medicaldetectiontoolkit_torch.models import build_model
from medicaldetectiontoolkit_torch.testing import (make_batch, make_mrcnn_slice_config, make_slice_config,
                                                   make_train_slice_config)

# the served slices: 3D Retina U-Net and 3D Mask R-CNN at LIDC width, batch
# 8; and the training slice: 3D Retina U-Net at LIDC width, batch 2 x 4
SLICE_CONFIGS = {"retina_unet": make_slice_config, "mrcnn": make_mrcnn_slice_config,
                 "retina_unet_train": make_train_slice_config}


class QuietLog:
    def info(self, *args, **kwargs):
        pass


def card_line() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def setup_card() -> str:
    """Require CUDA, switch TF32 off for convs and matmuls (float32 results
    stay float32), and return the card line."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card_line()


def slice_net(compute_dtype: str, seed: int = 0, model: str = "retina_unet"):
    """A served slice's detector on the card, random weights from ``seed``."""
    net = build_model(SLICE_CONFIGS[model](compute_dtype), QuietLog(), device="cuda")
    net.initialize(seed=seed)
    return net


def slice_batches(n_chunks: int = 3, model: str = "retina_unet"):
    return [make_batch(SLICE_CONFIGS[model](), seed=i) for i in range(n_chunks)]


def run_window(net, batches):
    """Dispatch every chunk, then convert each, as the Predictor's in-flight
    window does. Returns (device handles, results, host seconds of the
    dispatches, host seconds of the whole window ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [net.test_forward_dispatch(b) for b in batches]
    t_dispatch = time.perf_counter() - t0
    results = [net.test_forward_convert(h, b) for h, b in zip(handles, batches)]
    torch.cuda.synchronize()
    return handles, results, t_dispatch, time.perf_counter() - t0


def train_steps(net, batches):
    """One training step per batch (dispatch, then convert without the
    full-volume seg copy, as per-step monitoring does), ending in a
    synchronise. Returns (results, host seconds of each step)."""
    results, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(net.train_forward_convert(net.train_forward_dispatch(b), b, need_seg_preds=False))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return results, times
