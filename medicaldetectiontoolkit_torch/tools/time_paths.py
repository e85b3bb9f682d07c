"""Time the port's end-to-end paths on one CUDA card, as ``chip_smoke.py``
phases 4, 5 and 7 drive them: 3D Retina U-Net and 3D Mask R-CNN inference
(windows of three chunks of 8 patches, every chunk dispatched, then each
converted) and 3D Retina U-Net training (steps of 8 patches, batch 2 x 4,
remat, ``MDT_STEM_PALLAS=1``), each in float32 and bfloat16 at LIDC width.

    python3 medicaldetectiontoolkit_torch/tools/time_paths.py [--windows 5] [--steps 4]
        [--paths retina_unet mrcnn train] [--dtypes float32 bfloat16]

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it. To compare two commits on one card, unpack the other one
into a directory, copy this script and ``tools/common.py`` into its
``medicaldetectiontoolkit_torch/tools/``, and run the two copies in turns
(A B B A ...), one process each.

After one warm-up window or step per path, it prints the host-clock ms per
chunk of every window and ms of every step, and as its last line a JSON
object of them with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=5, help="timed windows of 3 chunks per inference path")
    ap.add_argument("--steps", type=int, default=4, help="timed steps per training path")
    ap.add_argument("--paths", nargs="+", choices=("retina_unet", "mrcnn", "train"),
                    default=["retina_unet", "mrcnn", "train"])
    ap.add_argument("--dtypes", nargs="+", choices=("float32", "bfloat16"), default=["float32", "bfloat16"])
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import torch

    from medicaldetectiontoolkit_torch.ops import nms_cuda, roi_align_cuda, stem_conv_cuda
    from medicaldetectiontoolkit_torch.tools import common

    if not Path(common.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {common.__file__}, not the package under {root}: run this script by its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off")
    with ThreadPoolExecutor(max_workers=3) as pool:
        list(pool.map(lambda m: m.build(), (nms_cuda, roi_align_cuda, stem_conv_cuda)))

    out = {}
    batches = common.slice_batches(3)
    for model in [p for p in args.paths if p != "train"]:
        for dtype in args.dtypes:
            net = common.slice_net(dtype, seed=0, model=model)
            common.run_window(net, batches)  # warm-up: cuDNN plans, kernel load
            ms = [common.run_window(net, batches)[3] * 1e3 / len(batches) for _ in range(args.windows)]
            out[f"{model} {dtype} ms per chunk"] = ms
            print(f"  {model} {dtype}: ms per chunk of 8, window by window: {' '.join(f'{t:.1f}' for t in ms)}")
            del net
            torch.cuda.empty_cache()

    os.environ["MDT_STEM_PALLAS"] = "1"
    train_batches = common.slice_batches(args.steps, "retina_unet_train")
    for dtype in args.dtypes if "train" in args.paths else ():
        net = common.slice_net(dtype, seed=0, model="retina_unet_train")
        common.train_steps(net, train_batches[:1])  # warm-up
        ms = [t * 1e3 for t in common.train_steps(net, train_batches)[1]]
        out[f"retina_unet training {dtype} ms per step"] = ms
        print(f"  retina_unet training {dtype}: ms per step of 8: {' '.join(f'{t:.1f}' for t in ms)}")
        del net
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": str(root), "times": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
