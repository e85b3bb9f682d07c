"""Helpers shared by the measurement scripts: the card's identity, float32
precision switches, the served slice, and one pipelined window of chunks."""

from __future__ import annotations

import subprocess
import time

import torch

from medicaldetectiontoolkit_torch.models import build_model
from medicaldetectiontoolkit_torch.testing import make_batch, make_slice_config


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


def slice_net(compute_dtype: str, seed: int = 0):
    """The served 3D Retina U-Net on the card, random weights from ``seed``."""
    net = build_model(make_slice_config(compute_dtype), QuietLog(), device="cuda")
    net.initialize(seed=seed)
    return net


def slice_batches(n_chunks: int = 3):
    return [make_batch(make_slice_config(), seed=i) for i in range(n_chunks)]


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
