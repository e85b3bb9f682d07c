"""Time whole-patient test inference on the card at LIDC scale.

One synthetic patient of z 280 x y 512 x x 512 voxels (a LIDC CT resampled
to 0.7 x 0.7 x 1.25 mm: 150 patches of 128 x 128 x 64) goes through the
port's test mode (``exec --mode test``, hold-out set, one checkpoint of
random weights, mirror TTA: 600 patch forwards) for 3D Retina U-Net in
float32 and bfloat16 and 3D Mask R-CNN in float32, each twice (the first
run pays the card's first-use costs). Per run it prints the ms per patient
(host clock around the whole test mode, ending in the device->host copies)
and its split: forward (dispatch and convert of every chunk), stitching (the
rest of ``predict_patient``: mirroring, seg averaging, box offsets),
consolidation (WBC; native unless ``MDT_NO_NATIVE=1``), evaluation, and the rest (model build, checkpoint
load, data load); patches/s (forwards over the whole time, and over the
forward time) and the peak device memory. The card's name and power limit
head the output; the JSON goes to ``--out-dir``.

    python3 -m medicaldetectiontoolkit_torch.tools.time_patient [--shape 280 512 512] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from medicaldetectiontoolkit_torch import native
from medicaldetectiontoolkit_torch.data.dataloader_utils import get_patch_crop_coords
from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc
from medicaldetectiontoolkit_torch.ops import nms_cuda, roi_align_cuda
from medicaldetectiontoolkit_torch.testing import make_lidc_experiment, run_lidc_test
from medicaldetectiontoolkit_torch.tools import common

RUNS = (("retina_unet", "float32"), ("retina_unet", "bfloat16"), ("mrcnn", "float32"))


def n_patches(shape_zyx, patch_size):
    """Patches of one patient (z, y, x) under the loader's grid."""
    z, y, x = shape_zyx
    return len(get_patch_crop_coords(np.broadcast_to(np.uint8(0), (y, x, z)), patch_size))


def time_runs(root, data_dir, model, dtype, shape_zyx, repeats, card):
    """Build the experiment (one checkpoint), run its test mode ``repeats``
    times; one result dict per run."""
    cf = make_lidc_experiment(root, {"MDT_DIM": "3", "MDT_MODEL": model, "MDT_LIDC_DTYPE": dtype},
                              {"test_n_epochs": 1}, seeds=(0,), epochs=(1,), device="cuda", hold_out=True,
                              data_dir=data_dir, exp_name=f"exp_{model}_{dtype}")
    patches = n_patches(shape_zyx, cf.patch_size)
    forwards = patches * (4 if cf.test_aug else 1)
    rows = []
    for run in range(repeats):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run_lidc_test(cf, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t = out["predictor"].times
        split = {"forward_ms": t["forward"] * 1e3, "stitching_ms": (t["patient"] - t["forward"]) * 1e3,
                 "consolidation_ms": t["consolidation"] * 1e3, "evaluation_ms": out["evaluation_s"] * 1e3}
        n_det = sum(b["box_type"] == "det" for r in out["results"] for bl in r[0] for b in bl)
        rows.append(dict(
            model=model, dtype=dtype, run=run, shape_zyx=list(shape_zyx), patches=patches, forwards=forwards,
            ms_per_patient=wall * 1e3, **split, other_ms=wall * 1e3 - sum(split.values()),
            patches_per_s=forwards / wall, forward_patches_per_s=forwards / t["forward"],
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, consolidated_detections=n_det, card=card,
        ))
        r = rows[-1]
        print(f"  {model} {dtype} run {run}: {r['ms_per_patient']:.1f} ms per patient (forward "
              f"{r['forward_ms']:.1f}, stitching {r['stitching_ms']:.1f}, consolidation {r['consolidation_ms']:.1f}, "
              f"evaluation {r['evaluation_ms']:.1f}, other {r['other_ms']:.1f}); {r['patches_per_s']:.2f} patches/s "
              f"({r['forward_patches_per_s']:.2f} over the forward); peak {r['peak_gib']:.2f} GiB; {n_det} "
              f"consolidated detections ({card})", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(280, 512, 512), help="z y x of the patient")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    card = common.setup_card()
    print(card)
    builds = [nms_cuda.build, roi_align_cuda.build] + ([native.get_lib] if native.enabled() else [])
    with ThreadPoolExecutor(max_workers=3) as pool:  # build the kernels and the host library before any timing
        list(pool.map(lambda build: build(), builds))
    rows = []
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        t0 = time.perf_counter()
        generate_synthetic_lidc(data_dir, n_patients=1, shape=tuple(args.shape))
        print(f"  generated one patient of {tuple(args.shape)} in {time.perf_counter() - t0:.1f} s")
        for model, dtype in RUNS:
            rows += time_runs(root, data_dir, model, dtype, tuple(args.shape), args.repeats, card)
            torch.cuda.empty_cache()
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, "time_patient.json"), "w") as handle:
            json.dump(rows, handle, indent=1)
    print(json.dumps({"time_patient": [{k: r[k] for k in ("model", "dtype", "run", "ms_per_patient", "patches_per_s")}
                                       for r in rows]}))


if __name__ == "__main__":
    main()
