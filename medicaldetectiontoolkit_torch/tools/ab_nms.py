"""End-to-end A/B of the NMS kernel on the served slice, on one CUDA card.

    python3 -m medicaldetectiontoolkit_torch.tools.ab_nms [--rounds 3]

For float32 and bfloat16: the pipelined 3-chunk window (every chunk
dispatched, then converted) with ``refine_detections`` on the plain PyTorch
NMS (A) or on the CUDA kernel (B), in turns A, B, B, A per round. Prints ms
per chunk of every window, the medians, how many A/B pairs B won, and
whether the detections of A and B are identical; exits 1 if they are not.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import statistics

import torch

from medicaldetectiontoolkit_torch.models import retina_net
from medicaldetectiontoolkit_torch.ops import nms as nms_ops
from medicaldetectiontoolkit_torch.tools.common import run_window, setup_card, slice_batches, slice_net


@contextlib.contextmanager
def plain_nms():
    """Route the detector's refine_detections through the plain NMS."""
    kernel_path = retina_net.refine_detections
    retina_net.refine_detections = functools.partial(kernel_path, nms_fn=nms_ops.batched_nms)
    try:
        yield
    finally:
        retina_net.refine_detections = kernel_path


def window_ms(net, batches, plain):
    with plain_nms() if plain else contextlib.nullcontext():
        _, results, _, wall = run_window(net, batches)
    return wall * 1e3 / len(batches), results


def same_detections(ra, rb):
    for a, b in zip(ra, rb):
        for la, lb in zip(a["boxes"], b["boxes"]):
            if len(la) != len(lb) or any(
                (x["box_coords"] != y["box_coords"]).any() or x["box_score"] != y["box_score"]
                or x["box_pred_class_id"] != y["box_pred_class_id"] for x, y in zip(la, lb)
            ):
                return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    card = setup_card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
    batches = slice_batches(3)
    ok = True
    for dtype in ("float32", "bfloat16"):
        net = slice_net(dtype)
        _, ref_a = window_ms(net, batches, plain=True)  # warm-up of both paths
        _, ref_b = window_ms(net, batches, plain=False)
        times = {"A": [], "B": []}
        for _ in range(args.rounds):
            for variant in "ABBA":
                ms, _ = window_ms(net, batches, plain=variant == "A")
                times[variant].append(ms)
        a, b = times["A"], times["B"]
        wins = sum(bb < aa for aa, bb in zip(a, b))
        med_a, med_b = statistics.median(a), statistics.median(b)
        same = same_detections(ref_a, ref_b)
        ok = ok and same
        print(f"[{dtype}] ms per chunk, A (plain NMS): {' '.join(f'{t:.2f}' for t in a)}")
        print(f"[{dtype}] ms per chunk, B (NMS kernel): {' '.join(f'{t:.2f}' for t in b)}")
        print(f"[{dtype}] medians A {med_a:.2f} B {med_b:.2f} (B-A {med_b - med_a:+.2f} ms); B won {wins} of "
              f"{len(a)} pairs; detections identical: {same} ({card})")
        del net
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
