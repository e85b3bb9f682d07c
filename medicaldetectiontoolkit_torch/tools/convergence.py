"""Convergence runs of the port on the card: train, validate and test a
detector through ``exec --mode train_test`` and report its APs.

Counterpart of ``tools/convergence3d.py``. ``--exp lidc`` (the default)
generates synthetic LIDC patients (``experiments/lidc_exp/preprocessing.py::
generate_synthetic_lidc``: 40 of z 100 x y 176 x x 176, 1-4 nodules each,
seed 7) and trains the LIDC config in 3D; ``--exp toy`` generates the toy
experiment's donuts_shape set (1,500 train and val images, 1,000 test, as
``generate_toys.py`` does by default) and runs the toy config at its
reference schedule (24 epochs x 100 batches x batch 20, 1,000 train and
100 val images, the first 400 test images; ``tools/chip_queue.sh:76-86``);
``--exp petct`` generates synthetic PET-CT patients
(``experiments/pet_ct_tnm_classification/preprocessing.py::
generate_synthetic_petct``: 8 of z 40 x y 96 x x 96 by default, seed 0) and
runs the PET-CT config (no validation; the hold-out test of every patient),
with ``--dev`` at the JAX package's on-chip smoke settings
(``tools/chip_queue_r5.sh:70-76``: one epoch of 5 batches of 1, one test
patient). Existing data are reused; other ``MDT_*`` settings (``MDT_LIDC_DTYPE``,
``MDT_STEM_PALLAS``) are read from the environment. The per-epoch val APs
are read from the exec log (``val results epoch ...`` lines) and the test's
mean foreground roi-AP from ``results.txt``; both are printed, and with
``--out-dir`` written to ``convergence_{exp}_{model}.json`` there.

    python3 -m medicaldetectiontoolkit_torch.tools.convergence --model retina_unet --epochs 12
    python3 -m medicaldetectiontoolkit_torch.tools.convergence --exp toy --model retina_unet --out-dir OUT
    python3 -m medicaldetectiontoolkit_torch.tools.convergence --exp petct --dev --out-dir OUT

It runs on the CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PACKAGE = os.path.join(REPO, "medicaldetectiontoolkit_torch")
TOY_DEFAULTS = {"epochs": 24, "ntb": 100, "batch_size": 20}
LIDC_DEFAULTS = {"epochs": 12, "ntb": 40, "batch_size": 8, "n_patients": 40, "shape": "100,176,176"}
PETCT_DEFAULTS = {"epochs": 100, "ntb": 60, "batch_size": 8, "n_patients": 8, "shape": "40,96,96"}


def ensure_lidc_data(root, n_patients, shape, seed=7):
    from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc

    pp = os.path.join(root, "lidc_mdt")
    if not (os.path.isdir(pp) and any("meta_info" in f for f in os.listdir(pp))):
        generate_synthetic_lidc(pp, n_patients=n_patients, shape=shape, n_nodules=(1, 4), seed=seed)
    return pp


def ensure_petct_data(root, n_patients, shape, seed=0):
    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing import (
        generate_synthetic_petct,
    )

    pp = os.path.join(root, "pp_norm")
    if not (os.path.isdir(pp) and any("meta_info" in f for f in os.listdir(pp))):
        generate_synthetic_petct(pp, n_patients=n_patients, shape=shape, seed=seed)
    return pp


def ensure_toy_data(root, n_train=1500, n_test=1000):
    from medicaldetectiontoolkit_torch.experiments.toy_exp.generate_toys import generate_experiment

    train_dir = os.path.join(root, "donuts_shape", "train")
    if not (os.path.isdir(train_dir) and any("meta_info" in f for f in os.listdir(train_dir))):
        generate_experiment(root, "donuts_shape", n_train, n_test, "donuts_shape")


def read_aps(exp_dir, fold=0):
    """(per-epoch val metrics from the fold's exec log, the test's
    ``average_foreground_roi`` AP from ``results.txt`` or None)."""
    val = []
    with open(os.path.join(exp_dir, f"fold_{fold}", "exec.log")) as handle:
        for line in handle:
            m = re.match(r"val results epoch (\d+): (.*)$", line.strip())
            if m:
                metrics = {k: (None if v == "None" else float(v))
                           for k, v in (item.rsplit(" ", 1) for item in m.group(2).split(", "))}
                val.append({"epoch": int(m.group(1)), **metrics})
    test_ap = None
    results = os.path.join(exp_dir, "results.txt")
    if os.path.isfile(results):
        with open(results) as handle:
            for line in handle:
                m = re.search(r"AP ([0-9.]+|nan) average_foreground_roi", line)
                if m:
                    test_ap = float(m.group(1))
    return val, test_ap


def read_step_ms(exec_log):
    """Each train step's time as the loop logs it (``tr. batch ... step
    X.XXXs``), in ms."""
    with open(exec_log) as handle:
        return [float(m.group(1)) * 1e3 for m in (re.search(r"tr\. batch .* step ([0-9.]+)s", line)
                                                 for line in handle) if m]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--exp", choices=("lidc", "toy", "petct"), default="lidc")
    ap.add_argument("--model", default="retina_unet")
    ap.add_argument("--epochs", type=int, default=None, help="default: 12 (lidc), 24 (toy), 100 (petct)")
    ap.add_argument("--ntb", type=int, default=None,
                    help="train batches per epoch; default 40 (lidc), 100 (toy), 60 (petct)")
    ap.add_argument("--batch_size", type=int, default=None, help="default 8 (lidc, petct), 20 (toy)")
    ap.add_argument("--n_patients", type=int, default=None, help="synthetic patients; default 40 (lidc), 8 (petct)")
    ap.add_argument("--shape", default=None,
                    help="synthetic volume, z,y,x; default 100,176,176 (lidc), 40,96,96 (petct)")
    ap.add_argument("--patch", default=None, help="LIDC or PET-CT patch, e.g. 48,48,16 (MDT_LIDC_PATCH, "
                    "MDT_PETCT_PATCH)")
    ap.add_argument("--dev", action="store_true", help="exec's --dev: one epoch of 5 batches of 1, one test patient")
    ap.add_argument("--root", default=None, help="data root (default: a directory under the temp dir)")
    ap.add_argument("--exp_dir", default=None)
    ap.add_argument("--mode", default="train_test")
    ap.add_argument("--resume", action="store_true", help="resume from <exp_dir>/fold_0/last_checkpoint")
    ap.add_argument("--out-dir", default=None)
    return ap.parse_args(argv)


def run(args, device=None):
    """Generate the data if needed, run exec and read the APs; ``device``
    None is the card (``exec.main``'s default)."""
    from medicaldetectiontoolkit_torch import exec as port_exec

    defaults = {"toy": TOY_DEFAULTS, "lidc": LIDC_DEFAULTS, "petct": PETCT_DEFAULTS}[args.exp]
    epochs, ntb, bs = (getattr(args, k) or defaults[k] for k in ("epochs", "ntb", "batch_size"))
    root = args.root or os.path.join(tempfile.gettempdir(), f"mdt_torch_{args.exp}_data")
    exp_dir = args.exp_dir or os.path.join(tempfile.gettempdir(), f"mdt_torch_conv_{args.exp}_{args.model}")
    t0 = time.perf_counter()
    if args.exp == "toy":
        ensure_toy_data(root)
        env = {"MDT_TOY_ROOT": root, "MDT_MODEL": args.model, "MDT_TOY_EPOCHS": str(epochs),
               "MDT_TOY_NTB": str(ntb), "MDT_TOY_BS": str(bs), "MDT_TOY_MAXVAL": "100", "MDT_TOY_MAXTEST": "400"}
        exp_source = os.path.join(PACKAGE, "experiments", "toy_exp")
    elif args.exp == "petct":
        pp = ensure_petct_data(root, args.n_patients or defaults["n_patients"],
                               tuple(int(v) for v in (args.shape or defaults["shape"]).split(",")))
        env = {"MDT_PETCT_ROOT": root, "MDT_PETCT_PP": pp, "MDT_MODEL": args.model, "MDT_PETCT_EPOCHS": str(epochs),
               "MDT_PETCT_NTB": str(ntb), "MDT_PETCT_BS": str(bs)}
        if args.patch:
            env["MDT_PETCT_PATCH"] = args.patch
        exp_source = os.path.join(PACKAGE, "experiments", "pet_ct_tnm_classification")
    else:
        pp = ensure_lidc_data(root, args.n_patients or defaults["n_patients"],
                              tuple(int(v) for v in (args.shape or defaults["shape"]).split(",")))
        env = {"MDT_LIDC_ROOT": root, "MDT_LIDC_PP": pp, "MDT_MODEL": args.model, "MDT_DIM": "3",
               "MDT_LIDC_EPOCHS": str(epochs), "MDT_LIDC_NTB": str(ntb), "MDT_LIDC_BS": str(bs),
               "MDT_LIDC_NVB": "5"}
        if args.patch:
            env["MDT_LIDC_PATCH"] = args.patch
        exp_source = os.path.join(PACKAGE, "experiments", "lidc_exp")
    data_s = time.perf_counter() - t0
    os.environ.update(env)
    argv = ["--mode", args.mode, "--exp_source", exp_source, "--exp_dir", exp_dir, "--folds", "0"]
    if args.resume:
        argv += ["--resume_to_checkpoint", os.path.join(exp_dir, "fold_0", "last_checkpoint")]
    if args.dev:
        argv.append("--dev")
    print("running exec", " ".join(argv), "with", env, flush=True)
    t1 = time.perf_counter()
    port_exec.main(argv, device=device)
    val, test_ap = read_aps(exp_dir)
    return {"exp": args.exp, "model": args.model, "epochs": epochs, "train_batches": ntb, "batch_size": bs,
            "dev": args.dev, "env": env, "exp_dir": exp_dir, "data_s": data_s, "exec_s": time.perf_counter() - t1,
            "val": val, "test_mean_fg_roi_ap": test_ap,
            "step_ms": read_step_ms(os.path.join(exp_dir, "fold_0", "exec.log"))}


def main(argv=None):
    import torch

    from medicaldetectiontoolkit_torch.tools import common

    if not torch.cuda.is_available():
        raise RuntimeError("convergence runs on the CUDA card; no CUDA device is visible")
    args = parse_args(argv)
    out = run(args)
    out["card"] = common.card_line()
    for v in out["val"]:
        print("val", json.dumps(v))
    ms = out["step_ms"]
    print(f"train steps as logged: {', '.join(f'{t:.1f}' for t in ms)} ms (median {sorted(ms)[len(ms) // 2]:.1f} ms; "
          f"{out['card']})")
    print(f"test mean fg roi-AP: {out['test_mean_fg_roi_ap']} ({out['exec_s']:.1f} s of exec; {out['card']})")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        with open(os.path.join(args.out_dir, f"convergence_{args.exp}_{args.model}.json"), "w") as handle:
            json.dump(out, handle, indent=1)
    print(json.dumps({k: out[k] for k in ("exp", "model", "epochs", "dev", "test_mean_fg_roi_ap", "exec_s")}))


if __name__ == "__main__":
    main()
