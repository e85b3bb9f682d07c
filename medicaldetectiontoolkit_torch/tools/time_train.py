"""Time training through the port's exec on the card at LIDC width.

Synthetic LIDC patients (default 6 of z 280 x y 512 x x 512, a chest CT at
LIDC's 0.7 x 0.7 x 1.25 mm spacing) and the LIDC config's 3D model
(``--model``: Retina U-Net by default, or Mask R-CNN / U-Faster R-CNN+;
patch 128 x 128 x 64, start_filts 18, end_filts 36, batch 8, the config's
loader workers) go through ``exec.train`` (the routine of
``exec --mode train``) for 2 epochs of ``--batches`` train batches and 2
``val_sampling`` batches, in float32 and bfloat16, with ``MDT_STEM_PALLAS``
as given (``--stem``). ``--pipeline`` lists the ``MDT_TRAIN_PIPELINE`` value
of each turn (``1 0 0 1 1 0``: the pipelined and the serial loop in turns);
each turn trains every dtype once. The first epoch warms up (cuDNN plans, the loader's
first batches); over the second epoch's train batches ``torch.profiler``
traces the device. Per dtype it prints: ms per step as the loop logs it,
the host ms the loop waited for each batch, the loader's capacity in
patches/s (workers x batch size over the mean host seconds a worker took
per batch) with its worker and OpenMP thread counts, and the device's busy
time and idle share over the second epoch's train batches (host wall from
its first batch request to the first ``val_sampling`` request, which
follows the last step's convert and the train evaluation). The card's name
and power limit head the output; the JSON goes to ``--out-dir``.

    python3 -m medicaldetectiontoolkit_torch.tools.time_train [--model retina_unet|mrcnn|ufrcnn] [--batches 12]
        [--patients 6] [--shape 280 512 512] [--dtypes float32 bfloat16] [--stem 1] [--pipeline 1] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from medicaldetectiontoolkit_torch import exec as port_exec
from medicaldetectiontoolkit_torch import native
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as lidc_dl
from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc
from medicaldetectiontoolkit_torch.ops import nms_cuda, roi_align_cuda, stem_conv_cuda
from medicaldetectiontoolkit_torch.testing import make_lidc_experiment
from medicaldetectiontoolkit_torch.tools import common
from medicaldetectiontoolkit_torch.tools.profile_slice import RUNTIME, busy_union_us
from medicaldetectiontoolkit_torch.utils import exp_utils


class _Window:
    """Traces the device from the first train batch of ``epoch`` to the
    first ``val_sampling`` batch after it (which the loop requests once the
    epoch's last train step is converted)."""

    def __init__(self, n_train_batches, epoch=2):
        self.start_at = (epoch - 1) * n_train_batches
        self.n_train = 0
        self.prof = None
        self.t0 = self.wall = None

    def before_train_batch(self):
        if self.n_train == self.start_at:
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                           torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        self.n_train += 1

    def before_val_batch(self):
        if self.prof is not None and self.wall is None:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)

    def summary(self):
        dev = [e for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(RUNTIME)]
        if not dev:
            raise RuntimeError("the profiler recorded no device activity")
        busy_ms = busy_union_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3
        return {"window_ms": self.wall * 1e3, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / (self.wall * 1e3)}


class _Probed:
    """A batch generator that calls ``hook`` before each batch."""

    def __init__(self, gen, hook):
        self.gen, self.hook = gen, hook

    def __next__(self):
        self.hook()
        return next(self.gen)

    def __getattr__(self, name):
        return getattr(self.gen, name)


class _ProbedLoader:
    """The LIDC data loader, its train and val_sampling generators probed."""

    def __init__(self, window):
        self.window = window

    def get_train_generators(self, cf, logger):
        gens = lidc_dl.get_train_generators(cf, logger)
        gens["train"] = _Probed(gens["train"], self.window.before_train_batch)
        gens["val_sampling"] = _Probed(gens["val_sampling"], self.window.before_val_batch)
        return gens


def time_dtype(root, data_dir, dtype, args, card, turn=0):
    env = {"MDT_DIM": "3", "MDT_MODEL": args.model, "MDT_LIDC_DTYPE": dtype, "MDT_LIDC_EPOCHS": "2",
           "MDT_LIDC_NTB": str(args.batches), "MDT_LIDC_NVB": "2"}
    name = f"exp_{args.model}_{dtype}_{turn}"
    make_lidc_experiment(root, env, {"n_cv_splits": 3}, seeds=(), epochs=(), device="cuda", data_dir=data_dir,
                         exp_name=name)
    exp_source = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments", "lidc_exp")
    cf = exp_utils.prep_exp(exp_source, os.path.join(root, name), use_stored_settings=True)
    cf.data_dest, cf.fold, cf.resume_to_checkpoint = None, 0, None
    cf.fold_dir = os.path.join(cf.exp_dir, "fold_0")
    os.makedirs(cf.fold_dir, exist_ok=True)
    logger = exp_utils.get_logger(cf.fold_dir)
    window = _Window(cf.num_train_batches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = port_exec.train(cf, _ProbedLoader(window), logger, device="cuda")
    wall = time.perf_counter() - t0
    for hdlr in logger.handlers:
        hdlr.close()
    logger.handlers = []
    loader = out["loader"]
    per_batch = sum(loader["batch_seconds"]) / len(loader["batch_seconds"])
    t = out["times"]
    row = dict(
        model=args.model, dtype=dtype, stem=os.environ.get("MDT_STEM_PALLAS", "0"), turn=turn,
        pipeline=os.environ.get("MDT_TRAIN_PIPELINE", "1"), batch_size=cf.batch_size,
        batches_per_epoch=cf.num_train_batches, step_ms=[s * 1e3 for s in t["step_s"][2]],
        warmup_step_ms=[s * 1e3 for s in t["step_s"][1]], load_wait_ms=[s * 1e3 for s in t["load_s"][2]],
        epoch_s=t["epoch_s"], train_s=t["train_s"], loader_workers=loader["n_workers"],
        omp_threads=native.lib_info()["omp_threads"], cpu_count=os.cpu_count(),
        loader_batches=len(loader["batch_seconds"]), loader_ms_per_batch=per_batch * 1e3,
        loader_patches_per_s=loader["n_workers"] * loader["batch_size"] / per_batch,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, run_s=wall, card=card, **window.summary(),
    )
    steps = sorted(row["step_ms"])
    print(f"  turn {turn}, {args.model}, MDT_TRAIN_PIPELINE={row['pipeline']}, {dtype}: {sum(steps) / len(steps):.1f} ms per "
          f"step of {cf.batch_size} (median {steps[len(steps) // 2]:.1f}; epoch 1: "
          f"{', '.join(f'{s:.0f}' for s in row['warmup_step_ms'])}); "
          f"waited for the loader {sum(row['load_wait_ms']) / len(steps):.1f} ms per step; loader "
          f"{row['loader_patches_per_s']:.2f} patches/s ({row['loader_workers']} workers, {row['omp_threads']} "
          f"OpenMP threads, {row['cpu_count']} CPUs, {row['loader_ms_per_batch']:.0f} ms per batch per worker); "
          f"device busy {row['busy_ms']:.1f} of {row['window_ms']:.1f} ms over epoch 2's train batches, idle share "
          f"{row['idle_share']:.4f}; peak {row['peak_gib']:.2f} GiB ({card})", flush=True)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("retina_unet", "mrcnn", "ufrcnn"), default="retina_unet")
    ap.add_argument("--batches", type=int, default=12, help="train batches per epoch")
    ap.add_argument("--patients", type=int, default=6)
    ap.add_argument("--shape", type=int, nargs=3, default=(280, 512, 512), help="z y x of each patient")
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"])
    ap.add_argument("--stem", default="1", help="MDT_STEM_PALLAS for the runs")
    ap.add_argument("--pipeline", nargs="+", default=["1"], choices=["0", "1"],
                    help="MDT_TRAIN_PIPELINE of each turn")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    os.environ["MDT_STEM_PALLAS"] = args.stem
    card = common.setup_card()
    print(card)
    with ThreadPoolExecutor(max_workers=3) as pool:  # build every library before any timing
        list(pool.map(lambda build: build(), (nms_cuda.build, roi_align_cuda.build, stem_conv_cuda.build,
                                               native.get_lib)))
    info = native.lib_info()
    print(f"  native host library {os.path.basename(info['path'])}: {info['compiler']}, "
          f"{info['omp_threads']} OpenMP threads")
    rows = []
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        t0 = time.perf_counter()
        generate_synthetic_lidc(data_dir, n_patients=args.patients, shape=tuple(args.shape))
        print(f"  generated {args.patients} patients of {tuple(args.shape)} in {time.perf_counter() - t0:.1f} s")
        for turn, pipeline in enumerate(args.pipeline):
            os.environ["MDT_TRAIN_PIPELINE"] = pipeline
            for dtype in args.dtypes:
                rows.append(time_dtype(root, data_dir, dtype, args, card, turn))
                torch.cuda.empty_cache()
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, f"time_train_{args.model}.json"), "w") as handle:
            json.dump(rows, handle, indent=1)
    print(json.dumps({"time_train": [{k: r[k] for k in ("model", "turn", "pipeline", "dtype", "train_s",
                                                        "loader_patches_per_s",
                                                        "idle_share")}
                                     for r in rows]}))


if __name__ == "__main__":
    main()
