"""Small synthetic configs and batches for the port's scripts and tests.

Counterpart of ``medicaldetectiontoolkit_tpu/testing.py``, cut to what the
ported paths read (inference and training of every detector). ``make_config``
gives the same values as the JAX package's ``make_config``
(``testing.py:10-95``) for every attribute it sets, and ``make_batch`` draws
the same arrays from the same seed (``testing.py:98-131``);
``tests/test_torch_testing.py`` holds them equal.
The config is a plain attribute bag, so an experiment's own config object
(e.g. the JAX package's ``DefaultConfigs`` subclass) serves the port as well.

``make_lidc_experiment`` and ``run_lidc_test`` set up and run the port's
whole-patient test mode on synthetic LIDC patients (the tests, the smoke
script's phase 8 and ``tools/time_patient.py``), ``run_lidc_train`` its
training modes on such an experiment (phase 9, ``tools/time_train.py``);
``make_toy_experiment`` and ``make_petct_experiment`` do the same for the
toy and PET-CT experiments;
``assert_same`` is the tests' exact comparison of two results.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np


def make_config(model="retina_net", dim=2, patch_size=None, start_filts=4, end_filts=8, batch_size=2,
                retina_scales=True):
    """Small but complete detector config (toy-experiment geometry scaled down)."""
    if patch_size is None:
        patch_size = [64, 64] if dim == 2 else [64, 64, 8]
    ps = list(patch_size)
    cf = SimpleNamespace(
        model=model,
        dim=dim,
        seed=0,
        # DefaultConfigs defaults (``config.py:38-107``)
        relu="relu",
        norm=None,
        weight_init=None,
        sixth_pooling=False,
        compute_dtype="float32",
        test_aug=True,
        patch_size=ps,
        batch_size=batch_size,
        n_channels=1,
        start_filts=start_filts,
        end_filts=end_filts,
        res_architecture="resnet50",
        head_classes=3,
        num_seg_classes=2,
        n_rpn_features=8,
        rpn_anchor_ratios=[0.5, 1, 2],
        rpn_anchor_stride=1,
        backbone_strides={"xy": [4, 8, 16, 32], "z": [1, 2, 4, 8]},
        rpn_anchor_scales={"xy": [[8], [16], [32], [64]], "z": [[2], [4], [8], [16]]},
        pyramid_levels=[0, 1, 2, 3],
        pre_nms_limit=500,
        model_max_instances_per_batch_element=10,
        detection_nms_threshold=1e-5,
        model_min_confidence=0.1,
        operate_stride1=model in ("retina_unet", "ufrcnn", "detection_unet"),
        # training (``testing.py:36-43``; ``config.py:46,111,139`` defaults)
        anchor_matching_iou=0.5,
        rpn_train_anchors_per_image=32,
        shem_poolsize=10,
        max_gt_boxes=8,
        weight_decay=0.0,
        use_remat=None,
        grad_accum_steps=1,
        # mrcnn-family extras (``testing.py:65-77``, ``config.py:89-91``)
        rpn_nms_threshold=0.7,
        train_rois_per_image=8,
        roi_positive_ratio=0.5,
        pool_size=(7, 7) if dim == 2 else (7, 7, 3),
        mask_pool_size=(14, 14) if dim == 2 else (14, 14, 5),
        mask_shape=(28, 28) if dim == 2 else (28, 28, 10),
        roi_chunk_size=100,
        post_nms_rois_training=50,
        post_nms_rois_inference=50,
        n_plot_rpn_props=3,
        return_masks_in_val=True,
        return_masks_in_test=False,
        frcnn_mode=model == "ufrcnn",
        # detection_unet extras (``testing.py:78-94``)
        class_dict={1: "benign", 2: "malignant"},
        n_roi_candidates=3,
        seg_loss_mode="dice_wce",
        fp_dice_weight=1,
        aggregation_operation="max",
        detection_min_confidence=0.1,
        min_det_thresh=0.1,
    )
    if model in ("ufrcnn", "detection_unet"):
        cf.num_seg_classes = 3
    if model == "detection_unet":
        cf.head_classes = cf.num_seg_classes
    cf.wce_weights = [1] * cf.num_seg_classes
    if retina_scales:
        for ax in ("xy", "z"):
            cf.rpn_anchor_scales[ax] = [[s[0], s[0] * 2 ** (1 / 3), s[0] * 2 ** (2 / 3)]
                                        for s in cf.rpn_anchor_scales[ax]]
    cf.n_anchors_per_pos = 9 if retina_scales else 3
    strides_xy, strides_z = cf.backbone_strides["xy"], cf.backbone_strides["z"]
    if dim == 2:
        cf.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.2, 0.2])
        cf.window = np.array([0, 0, ps[0], ps[1]])
        cf.scale = np.array([ps[0], ps[1], ps[0], ps[1]])
        cf.backbone_shapes = np.array([[int(np.ceil(ps[0] / s)), int(np.ceil(ps[1] / s))] for s in strides_xy])
    else:
        cf.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        cf.window = np.array([0, 0, ps[0], ps[1], 0, ps[2]])
        cf.scale = np.array([ps[0], ps[1], ps[0], ps[1], ps[2], ps[2]])
        cf.backbone_shapes = np.array(
            [[int(np.ceil(ps[0] / s)), int(np.ceil(ps[1] / s)), int(np.ceil(ps[2] / sz))]
             for s, sz in zip(strides_xy, strides_z)]
        )
    cf.bbox_std_dev = cf.rpn_bbox_std_dev.copy()
    return cf


def make_slice_config(compute_dtype="float32"):
    """The port's served configuration: 3D Retina U-Net at LIDC width on the
    bench geometry (``bench.py:161-176``), 673,920 anchors per patch."""
    cf = make_config(model="retina_unet", dim=3, patch_size=[128, 128, 64], start_filts=18, end_filts=36,
                     batch_size=8)
    cf.n_rpn_features = 64
    cf.pre_nms_limit = 50000
    cf.model_max_instances_per_batch_element = 30
    cf.compute_dtype = compute_dtype
    return cf


def make_train_slice_config(compute_dtype="float32"):
    """The training slice: ``make_slice_config`` with the settings of
    ``bench.py:161-177``, LIDC's 300 training anchors per image
    (``experiments/lidc_exp/configs.py:257``) and an effective batch of 8
    as 4 accumulated microbatches of 2; remat on (the 3D default)."""
    cf = make_slice_config(compute_dtype)
    cf.rpn_train_anchors_per_image = 300
    cf.grad_accum_steps = 4
    return cf


def make_mrcnn_slice_config(compute_dtype="float32"):
    """3D Mask R-CNN at LIDC width (``experiments/lidc_exp/configs.py:164-211``)
    on the same bench geometry as ``make_slice_config``: 3 anchors per
    position (224,640 per patch), 6,000 pre-NMS proposals per patch, 500 kept,
    second stage in chunks of 600 RoIs."""
    cf = make_config(model="mrcnn", dim=3, patch_size=[128, 128, 64], start_filts=18, end_filts=36,
                     batch_size=8, retina_scales=False)
    cf.n_rpn_features = 128
    cf.pre_nms_limit = 6000
    cf.post_nms_rois_training = 75
    cf.post_nms_rois_inference = 500
    cf.roi_chunk_size = 600
    cf.model_max_instances_per_batch_element = 30
    cf.compute_dtype = compute_dtype
    return cf


def make_det_unet_slice_config(compute_dtype="float32"):
    """3D Detection U-Net at LIDC width (``experiments/lidc_exp/configs.py``:
    patch 128x128x64, start_filts 18, end_filts 36, resnet50, 30 RoI
    candidates per class in 3D), batch 8 as one microbatch, remat on (the
    3D default)."""
    cf = make_config(model="detection_unet", dim=3, patch_size=[128, 128, 64], start_filts=18, end_filts=36,
                     batch_size=8)
    cf.n_roi_candidates = 30
    cf.use_remat = True
    cf.compute_dtype = compute_dtype
    return cf


def make_batch(cf, seed=42):
    """Synthetic batch dict in the framework's data contract: channel-first
    float32 ``data`` in [0, 1), one box-shaped lesion per element in ``seg``,
    ``bb_target`` and ``roi_masks``."""
    rng = np.random.RandomState(seed)
    bsz, ps = cf.batch_size, cf.patch_size
    data = rng.rand(bsz, cf.n_channels, *ps).astype(np.float32)
    seg = np.zeros((bsz, 1) + tuple(ps), dtype=np.uint8)
    boxes, labels, roi_masks = [], [], []
    for b in range(bsz):
        y1, x1 = rng.randint(2, ps[0] // 2, 2)
        y2 = y1 + rng.randint(8, ps[0] // 2)
        x2 = x1 + rng.randint(8, ps[1] // 2)
        if cf.dim == 2:
            boxes.append(np.array([[y1, x1, y2, x2]], np.float32))
            seg[b, 0, y1:y2, x1:x2] = 1
        else:
            z1 = rng.randint(0, max(1, ps[2] // 2))
            z2 = min(z1 + rng.randint(2, max(3, ps[2] // 2 + 1)), ps[2])
            boxes.append(np.array([[y1, x1, y2, x2, z1, z2]], np.float32))
            seg[b, 0, y1:y2, x1:x2, z1:z2] = 1
        labels.append(np.array([rng.randint(1, cf.head_classes)]))
        # per-RoI full-resolution binary masks (mrcnn's data contract)
        roi_masks.append(seg[b][None].copy())
    return {
        "data": data,
        "seg": seg,
        "bb_target": boxes,
        "roi_labels": labels,
        "roi_masks": roi_masks,
        "pid": [str(i) for i in range(bsz)],
        "class_target": np.array([[lab[0] - 1] for lab in labels]),
    }


def assert_same(a, b, path="value"):
    """Recursive exact equality of two results: the same containers, keys
    and key order, arrays of the same dtype, shape and values (NaN equal to
    NaN), scalars of the same type and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, type(a), type(b), len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


_PINNED_CONFIGS = '''"""{exp} configs pinned to one setting (written by medicaldetectiontoolkit_torch.testing)."""

import os

from medicaldetectiontoolkit_torch.experiments.{exp}.configs import configs as _base_configs

ENV = {env!r}
OVERRIDES = {overrides!r}


class configs(_base_configs):
    def __init__(self, server_env=None):
        saved = {{k: os.environ.get(k) for k in ENV}}
        os.environ.update(ENV)
        try:
            _base_configs.__init__(self, server_env)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for k, v in OVERRIDES.items():
            setattr(self, k, v)
'''


def _exp_source(exp):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments", exp)


def _pinned_experiment(exp, exp_dir, env, overrides):
    """``exec --mode create_exp`` of the port's experiment ``exp`` into
    ``exp_dir``, its ``configs.py`` snapshot pinned to the ``MDT_*``
    settings in ``env`` and to the attribute ``overrides``, and the model
    sources snapshotted for the pinned model. Returns the exp dir's config."""
    from medicaldetectiontoolkit_torch import exec as port_exec
    from medicaldetectiontoolkit_torch.utils import exp_utils

    port_exec.main(["--mode", "create_exp", "--exp_source", _exp_source(exp), "--exp_dir", exp_dir])
    with open(os.path.join(exp_dir, "configs.py"), "w") as handle:
        handle.write(_PINNED_CONFIGS.format(exp=exp, env=env, overrides=overrides))
    for name in ("model.py", "backbone.py"):  # create_exp snapshotted the default model's
        if os.path.isfile(os.path.join(exp_dir, name)):
            os.remove(os.path.join(exp_dir, name))
    exp_utils.prep_exp(_exp_source(exp), exp_dir, use_stored_settings=True)
    return exp_utils.prep_exp(_exp_source(exp), exp_dir, is_training=False)


def make_lidc_experiment(root, env, overrides=None, n_patients=4, shape=(16, 48, 48), seeds=(0, 1), epochs=(3, 1),
                         device="cpu", hold_out=False, data_dir=None, exp_name="exp"):
    """An experiment directory as a LIDC training run leaves one, on
    synthetic patients, for the port's test mode (``exec --mode test``).

    ``data_dir`` (default ``root/data``) gets ``n_patients`` synthetic
    patients of ``shape`` (z, y, x) unless it holds some already;
    ``root/exp_name`` is made by ``exec --mode create_exp`` from the port's
    LIDC experiment, and its ``configs.py``
    snapshot is then pinned to the ``MDT_*`` settings in ``env`` (read while
    the config is built; ``MDT_LIDC_PP`` is set to the data) and to the
    attribute ``overrides``; ``model.py`` and ``backbone.py`` are the
    snapshot of the pinned model's sources. Fold 0 gets one best checkpoint
    per entry of ``seeds`` (random weights drawn from it, saved by
    ``save_checkpoint`` as epoch ``epochs[i]``) and ``epoch_ranking.npy``;
    the CV split is ``fold_ids.pickle`` from ``fold_generator``, or with
    ``hold_out`` every patient is tested (``hold_out_test_set``). Returns
    the exp dir's config.
    """
    import pickle

    from medicaldetectiontoolkit_torch.data.dataloader_utils import fold_generator
    from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.utils import exp_utils

    data_dir, exp_dir = data_dir or os.path.join(root, "data"), os.path.join(root, exp_name)
    if not (os.path.isdir(data_dir) and any("meta_info" in f for f in os.listdir(data_dir))):
        generate_synthetic_lidc(data_dir, n_patients=n_patients, shape=tuple(shape))
    n_patients = sum("meta_info" in f for f in os.listdir(data_dir))
    overrides = dict(overrides or {}, hold_out_test_set=bool(hold_out))
    cf = _pinned_experiment("lidc_exp", exp_dir, dict(env, MDT_LIDC_PP=data_dir), overrides)
    if not hold_out:
        with open(os.path.join(exp_dir, "fold_ids.pickle"), "wb") as handle:
            pickle.dump(fold_generator(cf.seed, cf.n_cv_splits, n_patients).get_fold_names(), handle)
    fold_dir = os.path.join(exp_dir, "fold_0")
    for seed, epoch in zip(seeds, epochs):
        net = build_model(cf, None, device=device)
        net.initialize(seed=seed)
        exp_utils.save_checkpoint(os.path.join(fold_dir, f"{epoch}_best_checkpoint"),
                                  {"params": net.jax_params(), "epoch": epoch})
        del net
    if len(epochs):
        np.save(os.path.join(fold_dir, "epoch_ranking.npy"), np.asarray(epochs))
    return cf


def run_lidc_test(cf, device="cpu", folds=(0,), exp="lidc_exp"):
    """``exec --mode test`` on the experiment of ``make_lidc_experiment``
    (``exp="pet_ct_tnm_classification"`` for one of
    ``make_petct_experiment``); returns ``exec.main``'s result for fold
    ``folds[0]``."""
    from medicaldetectiontoolkit_torch import exec as port_exec

    argv = ["--mode", "test", "--exp_source", _exp_source(exp), "--exp_dir", cf.exp_dir,
            "--folds", *map(str, folds)]
    return port_exec.main(argv, device=device)[folds[0]]


def run_lidc_train(cf, mode="train_test", device="cpu", folds=(0,), resume=None, exp="lidc_exp"):
    """``exec --mode train | train_test`` on the experiment of
    ``make_lidc_experiment`` (made with no checkpoints; ``exp="toy_exp"``
    for one of ``make_toy_experiment``, ``exp="pet_ct_tnm_classification"``
    for one of ``make_petct_experiment``), with its pinned config snapshot
    (``--use_stored_settings``), optionally resuming from the checkpoint
    directory ``resume``; returns ``exec.main``'s result for fold
    ``folds[0]``."""
    from medicaldetectiontoolkit_torch import exec as port_exec

    argv = ["--mode", mode, "--exp_source", _exp_source(exp), "--exp_dir", cf.exp_dir, "--use_stored_settings",
            "--folds", *map(str, folds)]
    if resume:
        argv += ["--resume_to_checkpoint", resume]
    return port_exec.main(argv, device=device)[folds[0]]


def make_toy_experiment(root, env, overrides=None, n_train=24, n_test=4, exp_name="toy_exp"):
    """An experiment directory of the port's toy experiment for ``exec
    --mode train | train_test`` (``run_lidc_train(cf, mode, exp="toy_exp")``):
    ``root/donuts_shape/{train,test}`` get ``n_train`` / ``n_test`` toy
    images (``generate_toys.generate_experiment``) unless they hold some
    already, and ``root/exp_name``'s config is pinned to ``env`` (with
    ``MDT_TOY_ROOT`` set to ``root``) and ``overrides``. Returns its config."""
    from medicaldetectiontoolkit_torch.experiments.toy_exp.generate_toys import generate_experiment

    train_dir = os.path.join(root, "donuts_shape", "train")
    if not (os.path.isdir(train_dir) and any("meta_info" in f for f in os.listdir(train_dir))):
        generate_experiment(root, "donuts_shape", n_train, n_test, "donuts_shape")
    return _pinned_experiment("toy_exp", os.path.join(root, exp_name), dict(env, MDT_TOY_ROOT=root), overrides or {})


def make_petct_experiment(root, env, overrides=None, n_patients=4, shape=(12, 48, 48), exp_name="petct_exp",
                          data_dir=None):
    """An experiment directory of the port's PET-CT experiment for ``exec
    --mode train | train_test`` (``run_lidc_train(cf, mode,
    exp="pet_ct_tnm_classification")``): ``data_dir`` (default
    ``root/petct_data``) gets ``n_patients`` synthetic two-modality patients
    of ``shape`` (z, y, x) (``generate_synthetic_petct``) unless it holds
    some already, and ``root/exp_name``'s config is pinned to ``env`` (with
    ``MDT_PETCT_PP`` set to the data, which is the hold-out test set too)
    and ``overrides``. Returns its config."""
    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing import (
        generate_synthetic_petct,
    )

    data_dir = data_dir or os.path.join(root, "petct_data")
    if not (os.path.isdir(data_dir) and any("meta_info" in f for f in os.listdir(data_dir))):
        generate_synthetic_petct(data_dir, n_patients=n_patients, shape=tuple(shape))
    return _pinned_experiment("pet_ct_tnm_classification", os.path.join(root, exp_name),
                              dict(env, MDT_PETCT_PP=data_dir), overrides or {})


#############################
#   data-parallel ranks     #
#############################

DP_CASES = ("retina_unet", "mrcnn", "detection_unet")


def dp_case(name):
    """(cf, global batch, init seed) of a data-parallel parity case: a
    global batch of 8 in 2 microbatches (2 rows per rank per microbatch on
    2 ranks). Mask R-CNN takes the init seed, proposal counts and 3D
    geometry of ``tests/test_torch_mrcnn_train.py``, under which positive
    RoIs are sampled; Detection U-Net its class and false-positive
    weights."""
    if name == "retina_unet":
        cf = make_config(model="retina_unet", dim=2, batch_size=8)
        seed, init = 3, 1
    elif name == "mrcnn":
        cf = make_config(model="mrcnn", dim=3, batch_size=8, retina_scales=False)
        cf.pre_nms_limit, cf.post_nms_rois_training, cf.use_remat = 2000, 300, True
        seed, init = 1, 4
    elif name == "detection_unet":
        cf = make_config(model="detection_unet", dim=2, batch_size=8)
        cf.fp_dice_weight, cf.wce_weights = 1.5, [0.5, 1.0, 2.0]
        seed, init = 5, 1
    else:
        raise ValueError(f"unknown data-parallel case {name!r}")
    cf.grad_accum_steps = 2
    return cf, make_batch(cf, seed=seed), init


def dp_step(cf, batch, init_seed, device="cpu", draws=None, lr=1e-3):
    """One train step and one validation step of ``cf``'s detector on
    ``batch``, the global batch: on this rank's rows (``mesh.shard_batch``)
    and data-parallel when a process group is up, else the single-card
    step. ``draws`` (the global tensors of ``Detector.draws``) replace the
    train step's own. Returns the monitor values of both steps, the summed
    gradients, the updated parameters (CPU tensors) and the train step's
    detections (``box_type == "det"`` dicts per row)."""
    import torch

    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.models.base import resolve_grad_accum
    from medicaldetectiontoolkit_torch.parallel import mesh

    net = build_model(cf, None, device=device)
    net.initialize(seed=init_seed)
    rank, world = mesh.rank_and_world()
    if mesh.dist.is_initialized():
        net.enable_data_parallel()
    net.current_lr = lr
    n_micro = resolve_grad_accum(cf, cf.batch_size)
    out = {}
    for key, local in (("train", mesh.shard_batch(batch, rank, world, n_micro)),
                       ("val", mesh.shard_batch(batch, rank, world, 1))):
        if key == "train" and draws is not None:
            net.draws = lambda n_micro, m: tuple(d.to(net.device) for d in draws)
        handles = net.train_forward_dispatch(local, is_validation=key == "val")
        vars(net).pop("draws", None)  # the validation step draws its own
        # the monitor dict of the one-stage and two-stage handles; Detection
        # U-Net's handles start with its loss
        monitor = handles[1] if isinstance(handles[1], dict) else {"loss": handles[0]}
        res = net.train_forward_convert(handles, local, need_seg_preds=False)
        out[key] = {k: float(v) for k, v in monitor.items()}
        if key == "train":
            out["grads"] = {n: p.grad.detach().float().cpu().clone() for n, p in net.module.named_parameters()}
            out["params"] = {n: p.detach().float().cpu().clone() for n, p in net.module.named_parameters()}
            out["dets"] = [[b for b in row if b["box_type"] == "det"] for row in res["boxes"]]
    out["rows"] = mesh.shard_rows(cf.batch_size, rank, world, n_micro)
    return out


def dp_rank_main(argv=None):
    """A rank of ``run_ranks``' parity runs: ``out_dir device case...``;
    joins the ``MDT_DIST_*`` process group (gloo on the CPU) and writes
    ``dp_step``'s result per case to ``out_dir/{case}_rank{r}.pt``; a case
    ``name:path`` feeds the global draws saved at ``path``."""
    import sys

    import torch

    from medicaldetectiontoolkit_torch.parallel import mesh

    out_dir, device, *cases = sys.argv[2:] if argv is None else argv
    torch.set_num_threads(2)
    mesh.maybe_initialize_distributed(device=device, backend="gloo")
    try:
        for case in cases:
            name, _, draws_path = case.partition(":")
            cf, batch, init = dp_case(name)
            draws = torch.load(draws_path) if draws_path else None
            result = dp_step(cf, batch, init, device=device, draws=draws)
            torch.save(result, os.path.join(out_dir, f"{name}_rank{mesh.rank_and_world()[0]}.pt"))
    finally:
        mesh.dist.destroy_process_group()


def run_ranks(argv, world=2, timeout=300.0, env=None):
    """Run ``python argv...`` as ``world`` processes, each with the
    ``MDT_DIST_*`` triple of its rank (a free port on 127.0.0.1) and 2
    torch threads, and wait at most ``timeout`` seconds for them all. A rank
    that fails or a run that times out kills every rank and raises with
    their output. Returns each rank's output."""
    import subprocess
    import sys
    import tempfile
    import time

    from medicaldetectiontoolkit_torch.parallel import mesh

    port = mesh.free_port()
    procs, logs = [], []
    try:
        for rank in range(world):
            penv = dict(os.environ, **(env or {}), MDT_DIST_COORD=f"127.0.0.1:{port}", MDT_DIST_NPROCS=str(world),
                        MDT_DIST_RANK=str(rank), OMP_NUM_THREADS="2", MDT_DIST_INIT_TIMEOUT=str(int(timeout)))
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, *argv], env=penv, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"ranks exited {[p.returncode for p in procs]} (timeout {timeout} s):\n" +
                           "\n".join(f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outputs)))
    return outputs


#############################
#   spatial partitioning    #
#############################

SP_CASES = ("retina_unet", "mrcnn", "detection_unet", "instance_norm", "replicated")
# (lo, hi, pad) of the halo exchanges held against slicing a padded tensor
SP_HALOS = ((1, 1, 0.0), (3, 2, 0.0), (4, 2, 0.0), (1, 0, float("-inf")), (0, 1, 0.0), (1, 1, "replicate"))


def sp_case(name):
    """(cf, batch, env) of a spatial-partitioning parity case at S = 2: 3D
    Retina U-Net and 3D Mask R-CNN (masks returned) under
    ``MDT_STEM_PALLAS=1``, so that K3's plain version takes conv0's slab
    (stride 1) and the C1 stem's (stride 2) with their halos; 2D Detection
    U-Net at patch 128 with ``"batch_norm"`` (GroupNorm(1)) and, as
    ``instance_norm``, with instance norm, whose GroupNorms sum their
    statistics over the space group; 2D Retina U-Net at patch 96, whose C4
    (6 rows, 3 per rank) does not split for the stride-2 C5 stage, so C5 and
    P5 run replicated."""
    env = {}
    if name == "retina_unet":
        cf = make_config(model="retina_unet", dim=3)
        env = {"MDT_STEM_PALLAS": "1"}
    elif name == "mrcnn":
        cf = make_config(model="mrcnn", dim=3, retina_scales=False)
        cf.return_masks_in_test = True
        env = {"MDT_STEM_PALLAS": "1"}
    elif name in ("detection_unet", "instance_norm"):
        cf = make_config(model="detection_unet", dim=2, patch_size=[128, 128])
        cf.norm = "batch_norm" if name == "detection_unet" else "instance_norm"
    elif name == "replicated":
        cf = make_config(model="retina_unet", dim=2, patch_size=[96, 96])
    else:
        raise ValueError(f"unknown spatial case {name!r}")
    return cf, make_batch(cf, seed=7), env


def sp_heads_fn(net):
    """The module forward (``extract`` of the two-stage detectors, the
    module itself otherwise) with every output whole along Y: the heads and
    maps it gathers itself, and the P0 seg logits (its last output, or its
    only one), which the detectors keep on the slab, gathered here."""
    from medicaldetectiontoolkit_torch.parallel import mesh

    fn = net.module.extract if hasattr(net.module, "extract") else net.module

    def heads(img):
        out = fn(img)
        seg = out[-1] if isinstance(out, tuple) else out
        if seg is not None:
            with mesh.on_slabs(net.module.fpn.slab_levels[0]):
                seg = mesh.gather_y(seg)
        return (*out[:-1], seg) if isinstance(out, tuple) else seg

    return heads


def sp_primitives():
    """[(name, fn, x)]: the slab-aware ops of ``models/backbone.py`` on
    seeded inputs of 16 rows (4 per rank at S = 4), each fn a whole-tensor
    op on one process and a slab op inside a spatial forward. The convs with
    one input channel take K3's plain version (``MDT_STEM_PALLAS=1``)."""
    import torch

    from medicaldetectiontoolkit_torch.models import backbone as bb

    rng = np.random.RandomState(0)
    x3 = torch.from_numpy(rng.randn(2, 3, 16, 6, 4).astype(np.float32))
    x2 = torch.from_numpy(rng.randn(2, 3, 16, 6).astype(np.float32))
    img = torch.from_numpy(rng.rand(2, 1, 16, 6, 8).astype(np.float32))
    convs = {
        "conv3x3_3d": (bb.ConvND(3, 3, 5, ks=3, pad=1), x3),
        "conv7x7_s2_3d": (bb.ConvND(3, 3, 5, ks=7, stride=(2, 2, 1), pad=3), x3),
        "conv1x1_s2_3d": (bb.ConvND(3, 3, 5, ks=1, stride=(2, 2, 1)), x3),
        "conv3x3_2d": (bb.ConvND(2, 3, 5, ks=3, pad=1), x2),
        "conv7x7_s2_2d": (bb.ConvND(2, 3, 5, ks=7, stride=2, pad=3), x2),
        "k3_conv0": (bb.ConvND(3, 1, 5, ks=3, pad=1), img),
        "k3_stem_s2": (bb.ConvND(3, 1, 5, ks=7, stride=(2, 2, 1), pad=3), img),
        "group_norm_1": (bb.ConvND(3, 3, 6, ks=3, pad=1, norm="batch_norm"), x3),
        "instance_norm": (bb.ConvND(3, 3, 6, ks=3, pad=1, norm="instance_norm"), x3),
    }
    ops = []
    for i, (name, (conv, x)) in enumerate(convs.items()):
        bb.init_weights(conv, "kaiming_uniform", torch.Generator().manual_seed(i))
        with torch.no_grad():
            conv.conv.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(100 + i))
        ops.append((name, conv, x))
    ops += [("maxpool_3d", lambda t: bb.maxpool(t, 3), x3), ("maxpool_2d", lambda t: bb.maxpool(t, 2), x2),
            ("linear_up_3d", lambda t: bb.linear_up(t, (2, 2, 1)), x3),
            ("linear_up_2d", lambda t: bb.linear_up(t, (2, 2)), x2),
            ("nearest_up_3d", lambda t: bb.nearest_up(t, (2, 2, 2)), x3)]
    return ops


def env_scope(env):
    """A context with the variables of ``env`` set in ``os.environ`` and
    restored after it."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return scope()


def _sp_primitives_rank(world):
    """The primitives on this rank's slabs at S = ``world`` (one space
    group) and, on 4 ranks, at S = 2 too (a 2 x 2 grid): per S the gathered
    ops, the haloed slabs of ``SP_HALOS``, a summed row sum and a gathered
    slab."""
    import torch

    from medicaldetectiontoolkit_torch.parallel import mesh

    out = {}
    for n_space in (world, 2) if world == 4 else (world,):
        sg = mesh.SpaceGroup(mesh.grid_layout(world // n_space, n_space))
        res = {"space_index": sg.rank, "ops": {}, "halo": []}
        with torch.no_grad(), env_scope({"MDT_STEM_PALLAS": "1"}), sg.forward():
            for name, fn, x in sp_primitives():
                res["ops"][name] = mesh.gather_y(fn(mesh.slab_of(x)))
            x = sp_primitives()[0][2]
            slab = mesh.slab_of(x)
            res["halo"] = [mesh.halo_exchange(slab, lo, hi, pad) for lo, hi, pad in SP_HALOS]
            res["sum"] = mesh.space_sum(slab.sum(dim=2))
            res["gather"] = mesh.gather_y(slab)
        out[n_space] = res
    return out


def _sp_forward_rank(case, out_dir, device, world):
    """One parity case on this rank: the detector made spatial over the
    ``world`` ranks, loaded with ``out_dir/{case}_params.pkl`` (a JAX param
    tree) where the test wrote one, else initialised from seed 1; its
    gathered heads (``sp_heads_fn``) and ``test_forward`` results, which
    levels split, and the collectives' counts. ``cap`` records the cap's
    refusals at enable time and per call; ``verify`` runs Retina U-Net
    under ``MDT_SP_VERIFY=1``, then with every slab padded as if it lay at
    the image's edge (no neighbour rows), and records what each gave."""
    import pickle

    import torch

    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh

    if case == "cap":
        out = {}
        try:
            build_model(make_config(model="retina_unet", dim=2, patch_size=[32, 32]), None, device=device) \
                .enable_spatial_parallel_inference(n_space=world)
        except ValueError as e:
            out["enable"] = str(e)
        net = build_model(make_config(model="retina_unet", dim=2, patch_size=[64, 64]), None, device=device)
        net.enable_spatial_parallel_inference(n_space=world)
        try:
            net.test_forward(make_batch(make_config(model="retina_unet", dim=2, patch_size=[32, 32])))
        except ValueError as e:
            out["call"] = str(e)
        return out
    name = "retina_unet" if case == "verify" else case
    cf, batch, env = sp_case(name)
    with env_scope(env):
        net = build_model(cf, None, device=device)
        net.enable_spatial_parallel_inference(n_space=world)
        params = os.path.join(out_dir, f"{name}_params.pkl")
        if os.path.isfile(params):
            with open(params, "rb") as handle:
                net.load_params(pickle.load(handle))
        else:
            net.initialize(seed=1)
        if case == "verify":
            out = {}
            with env_scope({"MDT_SP_VERIFY": "1"}):
                out["sound"] = sum(len(b) for b in net.test_forward(batch)["boxes"])
                net.space._verified.clear()
                exchange = mesh.halo_exchange

                def edges_only(x, lo, hi, pad=0.0):  # every slab padded as if it lay at the image's edge
                    with mesh.on_slabs(False):
                        return exchange(x, lo, hi, pad)

                mesh.halo_exchange = edges_only
                try:
                    net.test_forward(batch)
                except AssertionError as e:
                    out["broken"] = str(e)
                finally:
                    mesh.halo_exchange = exchange
            return out
        with torch.inference_mode():
            heads = net._spatial(sp_heads_fn(net), torch.from_numpy(batch["data"]).to(net.device))
        res = net.test_forward(batch, return_masks=True)

    def cpu(tree):
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(t) for t in tree)
        return None if tree is None else tree.cpu()

    return {"heads": cpu(heads), "results": res, "slab_levels": net.module.fpn.slab_levels,
            "stats": net.space.stats,
            "tf32": (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)}


def sp_rank_main(argv=None):
    """A rank of the spatial parity runs (``run_ranks``): ``out_dir device
    case...``, each case ``primitives``, ``grad_primitives``, ``cap``,
    ``verify``, one of ``SP_CASES`` (a test forward), ``train:NAME``
    (``_sp_train_rank``, NAME one of ``SP_CASES`` or ``grid``), ``seg_loss``,
    ``seg:NAME`` (NAME one of ``SP_SEG_CASES``), ``mask_layer`` or
    ``mask:NAME`` (NAME one of ``SP_MASK_CASES``); joins the ``MDT_DIST_*``
    process group (gloo) and writes
    each case's result to ``out_dir/{case}_rank{r}.pt`` (``:`` written as
    ``_``)."""
    import sys

    import torch

    from medicaldetectiontoolkit_torch.parallel import mesh

    out_dir, device, *cases = sys.argv[2:] if argv is None else argv
    torch.set_num_threads(2)
    mesh.maybe_initialize_distributed(device=device, backend="gloo")
    rank, world = mesh.rank_and_world()
    try:
        for case in cases:
            if case == "primitives":
                result = _sp_primitives_rank(world)
            elif case == "grad_primitives":
                result = _sp_grad_rank(world)
            elif case.startswith("train:"):
                result = _sp_train_rank(case.partition(":")[2], out_dir, device, world)
            elif case == "seg_loss":
                result = _sp_seg_loss_rank(world)
            elif case.startswith("seg:"):
                result = _sp_seg_rank(case.partition(":")[2], device, world)
            elif case == "mask_layer":
                result = _sp_mask_layer_rank(out_dir, world)
            elif case.startswith("mask:"):
                result = _sp_mask_rank(case.partition(":")[2], device, world)
            else:
                result = _sp_forward_rank(case, out_dir, device, world)
            torch.save(result, os.path.join(out_dir, f"{case.replace(':', '_')}_rank{rank}.pt"))
    finally:
        mesh.dist.destroy_process_group()


#############################
#   spatial training        #
#############################

# the training case of ``sp_train_case`` on a 2 x 2 (data x space) grid of four ranks; SP_CASES run at S = 2
SP_GRID_CASE = "grid"


def sp_train_case(name):
    """(cf, global batch, init seed, env) of a spatial training parity case:
    ``sp_case``'s configuration and env (3D Retina U-Net and Mask R-CNN with
    K3/K4's plain versions on the slabs, 2D Detection U-Net with one-group
    and instance norm, 2D Retina U-Net with C5 / P5 replicated) at a batch
    of 2 in one microbatch; Mask R-CNN with the init seed, batch seed and
    proposal counts of ``tests/test_torch_mrcnn_train.py``, under which
    positive RoIs are sampled. ``grid``: 2D Retina U-Net at patch 64, a
    global batch of 4 in 2 microbatches, for a 2 x 2 grid (one row per
    data group and microbatch)."""
    if name == SP_GRID_CASE:
        cf = make_config(model="retina_unet", dim=2, batch_size=4)
        cf.grad_accum_steps = 2
        return cf, make_batch(cf, seed=3), 1, {}
    cf, _, env = sp_case(name)
    init, seed = 1, 7
    if name == "mrcnn":
        cf.pre_nms_limit, cf.post_nms_rois_training = 2000, 300
        cf.return_masks_in_test = False
        init, seed = 4, 1
    return cf, make_batch(cf, seed=seed), init, env


def sp_train_step(cf, batch, init_seed, device="cpu", draws=None, lr=1e-3, grid=None):
    """A validation step, a train step and a second validation step of
    ``cf``'s detector on ``batch``, the global batch (JAX's
    ``test_enable_spatial_parallel_train_forward`` sequence): with ``grid``
    = (n_data, n_space) over the process group (``enable_spatial_parallel``,
    the data group's rows, ``mesh.shard_batch``), else the single-card step.
    ``draws`` (the global tensors of ``Detector.draws``) replace the train
    step's own. Returns the monitor values of the three steps, the
    gradients Adam took and the updated parameters (CPU tensors), and under
    ``grid`` the train step's collective counts (``stats``) and each step's
    (``step_stats``)."""
    import torch

    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.models.base import resolve_grad_accum
    from medicaldetectiontoolkit_torch.parallel import mesh

    net = build_model(cf, None, device=device)
    net.initialize(seed=init_seed)
    index, n_data = 0, 1
    if grid is not None:
        g = net.enable_spatial_parallel(*grid)
        index, n_data = g.data_index, g.n_data
    net.current_lr = lr
    n_micro = resolve_grad_accum(cf, cf.batch_size)
    out, step_stats = {}, {}
    for key in ("val", "train", "val_after"):
        local = mesh.shard_batch(batch, index, n_data, n_micro if key == "train" else 1)
        if key == "train" and draws is not None:
            net.draws = lambda n_micro, m: tuple(d.to(net.device) for d in draws)
        if net.space is not None:
            net.space.reset_stats()
        handles = net.train_forward_dispatch(local, is_validation=key != "train")
        vars(net).pop("draws", None)
        monitor = handles[1] if isinstance(handles[1], dict) else {"loss": handles[0]}
        net.train_forward_convert(handles, local, need_seg_preds=False)
        out[key] = {k: float(v) for k, v in monitor.items()}
        if net.space is not None:
            step_stats[key] = {k: dict(v) for k, v in net.space.stats.items()}
        if key == "train":
            out["grads"] = {n: p.grad.detach().float().cpu().clone() for n, p in net.module.named_parameters()}
            out["params"] = {n: p.detach().float().cpu().clone() for n, p in net.module.named_parameters()}
    if net.space is not None:
        out["stats"], out["step_stats"] = step_stats["train"], step_stats
        out["slab_levels"] = net.module.fpn.slab_levels
    return out


def sp_grad_primitives():
    """[(name, fn, x, params)]: float64 ops whose gradients a spatial
    backward must give as on the whole tensor, on seeded inputs of 16 rows
    (4 per rank at S = 4), each fn a whole-tensor op on one process and a
    slab op inside a spatial forward whose output is a slab: the convs,
    max pools and upsamplings of ``sp_primitives`` (without K3), the halos
    of ``SP_HALOS`` as windows along Y (weighted sums; a max for ``-inf``),
    GroupNorm(1) and instance norm in float64 (``_group_norm64``), the
    identity (``gather_y`` alone), and ``fenced``: a conv on the slab, a
    stride-2 stage whose halo no slab covers (``mesh.space_fence`` gathers,
    the conv runs replicated), its output's slab added back (``slab_of``).
    ``params`` are the tensors whose gradient shares the ranks sum."""
    import torch

    from medicaldetectiontoolkit_torch.models import backbone as bb
    from medicaldetectiontoolkit_torch.parallel import mesh

    ops = []
    for name, fn, x in sp_primitives():
        if name.startswith("k3") or name in ("group_norm_1", "instance_norm"):
            continue
        params = []
        if isinstance(fn, torch.nn.Module):
            fn = fn.double()
            fn.dtype = torch.float64
            params = list(fn.parameters())
        ops.append((name, fn, x.double(), params))
    x = sp_primitives()[0][2].double()
    for lo, hi, pad in SP_HALOS:
        def window(t, lo=lo, hi=hi, pad=pad):
            h, n = mesh.halo_exchange(t, lo, hi, pad), t.shape[2]
            rows = [h[:, :, j:j + n] for j in range(lo + hi + 1)]
            if pad == float("-inf"):
                return torch.stack(rows).amax(dim=0)
            return sum((j + 1.5) * r for j, r in enumerate(rows))
        ops.append((f"halo_{lo}_{hi}_{pad}", window, x, []))
    gen = torch.Generator().manual_seed(5)
    for name, groups in (("group_norm_1", 1), ("instance_norm", 3)):
        scale = (torch.rand(3, dtype=torch.float64, generator=gen) + 0.5).requires_grad_(True)
        bias = (torch.rand(3, dtype=torch.float64, generator=gen) - 0.5).requires_grad_(True)
        ops.append((name, lambda t, g=groups, s=scale, b=bias: _group_norm64(t, g, s, b), x, [scale, bias]))
    ops.append(("gather", lambda t: t, x, []))
    conv_a = bb.ConvND(3, 3, 4, ks=3, pad=1).double()
    conv_b = bb.ConvND(3, 4, 4, ks=3, stride=(2, 2, 1), pad=1).double()
    for i, conv in enumerate((conv_a, conv_b)):
        conv.dtype = torch.float64
        bb.init_weights(conv, "kaiming_uniform", torch.Generator().manual_seed(20 + i))

    def fenced(t):
        a = conv_a(t)
        h, split = mesh.space_fence(a, True, stride=2, halo=t.shape[2] + 1)  # no slab lends that many rows
        with mesh.on_slabs(split):
            c = conv_b(h)
        return mesh.slab_of(bb.nearest_up(c, (2, 2, 1))) + a

    ops.append(("fenced", fenced, x, [*conv_a.parameters(), *conv_b.parameters()]))
    return ops


def _group_norm64(x, groups: int, scale, bias):
    """GroupNorm in float64 whose statistics are sums over the image's rows
    (``mesh.space_sum`` on a slab): mean, then the variance about it."""
    import torch

    from medicaldetectiontoolkit_torch.parallel import mesh

    sg = mesh.space()
    b, c = x.shape[:2]
    xg = x.reshape(b, groups, c // groups, -1)
    count = xg.shape[2] * xg.shape[3] * (1 if sg is None else sg.size)
    mean = mesh.space_sum(xg.sum(dim=(2, 3), keepdim=True)) / count
    var = mesh.space_sum((xg - mean).square().sum(dim=(2, 3), keepdim=True)) / count
    y = ((xg - mean) / torch.sqrt(var + 1e-6)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * scale.view(shape) + bias.view(shape)


def sp_grad_weight(shape):
    """The fixed float64 weights ``w`` of the scalar ``(w * out).sum()``
    whose gradient the primitives' backward tests take."""
    import torch

    return torch.rand(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(11)) - 0.5


def _sp_grad_rank(world):
    """The gradients of ``sp_grad_primitives`` on this rank's slabs at S =
    ``world`` (one space group) and, on 4 ranks, at S = 2 too (a 2 x 2
    grid): per op the whole input's gradient (this rank's slab rows) and the
    params' gradient shares of ``(w * gather_y(fn(slab))).sum() / S``, the
    loss seeded with 1/S on every rank; and ``identity_sum``: GroupNorm(1)'s
    gradient with ``space_sum``'s backward the identity."""
    import torch

    from medicaldetectiontoolkit_torch.parallel import mesh

    out = {}
    for n_space in (world, 2) if world == 4 else (world,):
        sg = mesh.SpaceGroup(mesh.grid_layout(world // n_space, n_space))
        res = {"space_index": sg.rank, "grads": {}}
        for name, fn, x, params in sp_grad_primitives():
            res["grads"][name] = _sp_grad_of(sg, fn, x, params)
        name, fn, x, params = next(op for op in sp_grad_primitives() if op[0] == "group_norm_1")
        backward = mesh._SpaceSum.backward
        mesh._SpaceSum.backward = staticmethod(lambda ctx, g: (g, None))
        try:
            res["identity_sum"] = _sp_grad_of(sg, fn, x, params)
        finally:
            mesh._SpaceSum.backward = backward
        res["stats"] = {k: dict(v) for k, v in sg.stats.items()}
        out[n_space] = res
    return out


def _sp_grad_of(sg, fn, x, params):
    """(x's gradient, [params' gradient shares]) of ``(w * gather_y(fn(
    slab_of(x)))).sum() / S`` inside ``sg``."""
    import torch

    from medicaldetectiontoolkit_torch.parallel import mesh

    x = x.clone().requires_grad_(True)
    with sg.forward():
        out = mesh.gather_y(fn(mesh.slab_of(x)))
    loss = (sp_grad_weight(out.shape) * out).sum() / sg.size
    grads = torch.autograd.grad(loss, [x, *params], allow_unused=True)
    return grads[0], [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads[1:])]


def _sp_train_rank(case, out_dir, device, world):
    """One training case on this rank (``sp_train_step`` over the grid):
    ``grid`` on a 2 x 2 grid, every other case at S = ``world`` with remat
    on and off; the train step takes ``out_dir/{case}_draws.pt`` where the
    test wrote one."""
    import torch

    cf, batch, init, env = sp_train_case(case)
    path = os.path.join(out_dir, f"{case}_draws.pt")
    draws = torch.load(path) if os.path.isfile(path) else None
    with env_scope(env):
        if case == SP_GRID_CASE:
            return sp_train_step(cf, batch, init, device, draws, grid=(2, 2))
        out = {}
        for remat in (True, False):
            cf.use_remat = remat
            out[remat] = sp_train_step(cf, batch, init, device, draws, grid=(world // 2, 2))
        return out


#############################
#   the seg path on slabs   #
#############################

# Detection U-Net's seg loss modes, each a spatial step case; ``replicated_p0``
# is 2D Retina U-Net with P0's fence made to gather (P0 and every deeper
# level replicated), so the seg path runs whole
SP_SEG_CASES = ("retina_unet", "ufrcnn", "dice", "wce", "dice_wce", "replicated_p0")


def sp_seg_loss_cases():
    """[(name, logits, seg, n_classes, false_positive_weight, class_weights)]
    of ``fused_seg_loss`` on seeded float64 inputs of 16 rows (4 per rank at
    S = 4): 2 and 3 classes, 2D and 3D, false-positive weights 1, 2.5 and
    0.5, with and without class weights."""
    rng = np.random.RandomState(3)
    cases = []
    for name, n_classes, spatial, fpw, weights in (("c2", 2, (16, 6, 4), 1.0, None),
                                                    ("c3_fp", 3, (16, 10), 2.5, None),
                                                    ("c3_weighted", 3, (16, 6, 4), 0.5, [0.2, 1.0, 3.0]),
                                                    ("c2_weighted", 2, (16, 10), 1.0, [1.0, 4.0])):
        logits = rng.randn(2, n_classes, *spatial) * 2
        seg = rng.randint(0, n_classes, (2, 1, *spatial)).astype(np.int32)
        cases.append((name, logits, seg, n_classes, fpw, weights))
    return cases


def _sp_seg_loss_rank(world):
    """``fused_seg_loss`` on this rank's slabs of ``sp_seg_loss_cases`` at S
    = ``world`` (one space group) and, on 4 ranks, at S = 2 (a 2 x 2 grid),
    outside any spatial forward, the group given as the detectors give it:
    per case and dtype (float64, float32) the dice, the CE, the slab's
    logits gradient of dice + CE (float64) and the collectives' counts; and
    ``dropped``: float64 dice and CE with the sums' ``space_sum`` given no
    group (the identity there, as a loss that relied on ``mesh.space()``
    would have it)."""
    import torch

    from medicaldetectiontoolkit_torch.ops import losses
    from medicaldetectiontoolkit_torch.parallel import mesh

    out = {}
    for n_space in (world, 2) if world == 4 else (world,):
        sg = mesh.SpaceGroup(mesh.grid_layout(world // n_space, n_space))
        res = {"space_index": sg.rank, "cases": {}}
        for name, logits, seg, n_classes, fpw, weights in sp_seg_loss_cases():
            case = {}
            for dtype in (torch.float64, torch.float32):
                sg.reset_stats()
                x = torch.from_numpy(sg.slab(logits)).to(dtype).requires_grad_(True)
                lab = torch.from_numpy(np.ascontiguousarray(sg.slab(seg)))
                dice, ce = losses.fused_seg_loss(x, lab, n_classes, fpw, weights, space=sg)
                (dice + ce).backward()
                case[str(dtype)] = {"dice": dice.detach(), "ce": ce.detach(), "grad": x.grad,
                                    "stats": {k: dict(v) for k, v in sg.stats.items()}}
            space_sum = mesh.space_sum
            mesh.space_sum = lambda t, sg=None: space_sum(t)
            try:
                case["dropped"] = [float(v) for v in losses.fused_seg_loss(
                    torch.from_numpy(sg.slab(logits)), torch.from_numpy(np.ascontiguousarray(sg.slab(seg))),
                    n_classes, fpw, weights, space=sg)]
            finally:
                mesh.space_sum = space_sum
            res["cases"][name] = case
        out[n_space] = res
    return out


def sp_seg_case(name):
    """(cf, batch, env) of a ``SP_SEG_CASES`` step at S = 2: 3D Retina
    U-Net as ``sp_case``'s (K3's plain version on the slabs), 2D U-Faster
    R-CNN+ and 2D Detection U-Net at patch 64, the latter with no norm (so
    that the seg loss's is the step's one ``sum``), a false-positive weight
    of 2 and class weights (0.5, 1, 2) in each ``seg_loss_mode``; 2D Retina
    U-Net at patch 64 for ``replicated_p0``."""
    if name == "retina_unet":
        return sp_case(name)
    if name == "ufrcnn":
        cf = make_config(model="ufrcnn", dim=2, retina_scales=False)
    elif name == "replicated_p0":
        cf = make_config(model="retina_unet", dim=2)
    else:
        cf = make_config(model="detection_unet", dim=2)
        cf.seg_loss_mode, cf.fp_dice_weight, cf.wce_weights = name, 2.0, [0.5, 1.0, 2.0]
    return cf, make_batch(cf, seed=7), {}


def sp_seg_step(cf, batch, device="cpu", n_space=None):
    """A validation step, a train step and a test forward of ``cf``'s
    detector (init seed 1) on ``batch``, seg_preds asked for in each
    convert: with ``n_space``, spatially partitioned over the process group
    (``enable_spatial_parallel``), else on one process. Returns the monitor
    values, the gradients Adam took, the seg_preds of the train convert and
    of the test forward, and under ``n_space`` the collectives' counts of
    each dispatch and convert (``{step}_dispatch``, ``{step}_convert``)."""
    from medicaldetectiontoolkit_torch.models import build_model

    net = build_model(cf, None, device=device)
    net.initialize(seed=1)
    if n_space is not None:
        net.enable_spatial_parallel(n_space=n_space)
    out, stats = {}, {}

    def counted(key, fn):
        if net.space is not None:
            net.space.reset_stats()
        result = fn()
        if net.space is not None:
            stats[key] = {k: dict(v) for k, v in net.space.stats.items()}
        return result

    for key in ("val", "train"):
        handles = counted(f"{key}_dispatch", lambda: net.train_forward_dispatch(batch, is_validation=key == "val"))
        res = counted(f"{key}_convert", lambda: net.train_forward_convert(handles, batch, need_seg_preds=True))
        monitor = handles[1] if isinstance(handles[1], dict) else {"loss": res["loss"]}
        out[key] = {k: float(v) for k, v in monitor.items()}
        out[f"{key}_seg_preds"] = res["seg_preds"]
        if key == "train":
            out["grads"] = {n: p.grad.detach().clone() for n, p in net.module.named_parameters()}
    handles = counted("test_dispatch", lambda: net.test_forward_dispatch(batch))
    out["test_seg_preds"] = counted("test_convert", lambda: net.test_forward_convert(handles, batch))["seg_preds"]
    if net.space is not None:
        out["stats"] = stats
        out["slab_levels"] = net.module.fpn.slab_levels
    return out


def _sp_seg_rank(name, device, world):
    """``sp_seg_step`` of ``SP_SEG_CASES`` ``name`` on this rank at S =
    ``world``; ``replicated_p0`` with ``mesh.keeps_split`` refusing every
    stride-1 fence, so that P0's gathers the image."""
    from medicaldetectiontoolkit_torch.parallel import mesh

    cf, batch, env = sp_seg_case(name)
    keeps_split = mesh.keeps_split
    if name == "replicated_p0":
        mesh.keeps_split = lambda n, stride=1, halo=1: stride > 1 and keeps_split(n, stride, halo)
    try:
        with env_scope(env):
            return sp_seg_step(cf, batch, device, n_space=world)
    finally:
        mesh.keeps_split = keeps_split


#############################
#   the GT masks on slabs   #
#############################

# the crafted masks' extent: 16 rows per rank at S = 2, 8 at S = 4
SP_MASK_SPATIAL = {2: (32, 32), 3: (32, 32, 8)}
# normalised GT boxes (y1, x1, y2, x2, (z1, z2)) per element of the crafted
# target-layer batch, and the jitters of each GT among the proposals; the
# elements hold 2 mask slots, so element 1's third GT has none
_SP_MASK_GTS = (
    ([[0.35, 0.1, 0.65, 0.5, 0.2, 0.8], [0.03, 0.55, 0.2, 0.9, 0.1, 0.6]], (2, 2)),  # across row 16; rows 0-7
    ([[0.15, 0.2, 0.35, 0.6, 0.25, 0.75], [0.6, 0.5, 0.9, 0.8, 0.3, 0.9], [0.4, 0.05, 0.6, 0.35, 0.1, 0.5]],
     (1, 1, 2)),  # across row 8; across row 24; across row 16, past the mask slots
    ([], ()),  # no GT
    ([[0.2, 0.2, 0.8, 0.8, 0.0, 1.0], [0.55, 0.1, 0.72, 0.3, 0.4, 0.7]], (2, 2)),  # rows 6-26; rows 17-23
)


_AXES = ((0, 2), (1, 3), (4, 5))  # (lo, hi) box columns of y, x, z


def sp_mask_layer_case(dim):
    """(cf, [per-element inputs]) of ``detection_target_layer`` crafted for
    the GT masks on slabs: 2D or 3D Mask R-CNN's config, 4 GT slots and 2
    mask slots per element on masks of ``SP_MASK_SPATIAL`` (random voxels,
    denser inside each GT's box, so that every row differs), 12 proposals:
    each GT jittered by 0.01 as ``_SP_MASK_GTS`` says (positives), then
    random boxes. Crops cross the rows 8, 16 and 24 where slabs meet at S =
    2 and 4, and lie inside one slab; element 1 has a positive assigned past
    the mask slots, element 2 no GT. Inputs per element: proposals, their
    valid flags, class scores, GT boxes, ids, valid flags, masks."""
    cf = make_config("mrcnn", dim=dim, retina_scales=False)
    spatial, G, P, n_slots = SP_MASK_SPATIAL[dim], 4, 12, 2
    rng = np.random.RandomState(dim)
    elements = []
    for gts, jitters in _SP_MASK_GTS:
        gt = np.asarray([g[:2 * dim] for g in gts], np.float32).reshape(-1, 2 * dim)
        near = np.repeat(gt, np.asarray(jitters, int), axis=0)
        near = near + rng.randn(*near.shape).astype(np.float32) * 0.01
        lo = rng.rand(P - len(near), dim) * 0.6
        far = np.concatenate([lo[:, :2], lo[:, :2] + 0.1 + rng.rand(len(lo), 2) * 0.3] + (
            [lo[:, 2:], lo[:, 2:] + 0.2 + rng.rand(len(lo), 1) * 0.3] if dim == 3 else []), axis=1)
        proposals = np.concatenate([near, far]).astype(np.float32)
        boxes, ids, valid = np.zeros((G, 2 * dim), np.float32), np.zeros((G,), np.int32), np.zeros((G,), bool)
        boxes[:len(gt)], ids[:len(gt)], valid[:len(gt)] = gt, rng.randint(1, 3, len(gt)), True
        masks = (rng.rand(n_slots, *spatial) < 0.3).astype(np.uint8)
        for i, g in enumerate(gt[:n_slots]):
            box = (i, *(slice(int(g[lo] * n), int(np.ceil(g[hi] * n))) for (lo, hi), n in zip(_AXES, spatial)))
            masks[box] |= (rng.rand(*masks[box].shape) < 0.9).astype(np.uint8)
        elements.append([proposals, np.ones((P,), bool), rng.rand(P, 3).astype(np.float32), boxes, ids, valid,
                         masks])
    return cf, elements


def sp_mask_layer_inputs(elements):
    """The batched torch inputs of ``sp_mask_layer_case``'s elements."""
    import torch

    return [torch.from_numpy(np.stack(parts)) for parts in zip(*elements)]


def _sp_mask_layer_rank(out_dir, world):
    """``detection_target_layer`` on this rank's Y slab of
    ``sp_mask_layer_case``'s masks at S = ``world`` (one space group) and,
    on 4 ranks, at S = 2 (a 2 x 2 grid), the group given and no spatial
    forward running (as the detectors call it), with the draws the test
    wrote to ``out_dir/mask_layer_{dim}d_draws.pt``: per S and dim the
    outputs, the slab's shape and the collectives' counts; and two traps'
    target masks: ``skipped``, the ``mask_rows`` sum left out (each rank
    keeps only its own rows), and ``own_extent``, the slab taken as the
    whole image (rows indexed by the slab's extent)."""
    import torch

    from medicaldetectiontoolkit_torch.models import mrcnn
    from medicaldetectiontoolkit_torch.parallel import mesh

    out = {}
    for n_space in (world, 2) if world == 4 else (world,):
        sg = mesh.SpaceGroup(mesh.grid_layout(world // n_space, n_space))
        res = {"space_index": sg.rank, "dims": {}}
        for dim in (2, 3):
            cf, elements = sp_mask_layer_case(dim)
            draws = torch.load(os.path.join(out_dir, f"mask_layer_{dim}d_draws.pt"))
            *inputs, masks = sp_mask_layer_inputs(elements)
            slab = sg.slab(masks).contiguous()
            sg.reset_stats()
            got = mrcnn.detection_target_layer(draws, *inputs, slab, cf, space=sg)
            stats = {k: dict(v) for k, v in sg.stats.items()}
            sg.sum = lambda t, kind="sum": t
            try:
                skipped = mrcnn.detection_target_layer(draws, *inputs, slab, cf, space=sg)[4]
            finally:
                del sg.sum
            own_extent = mrcnn.detection_target_layer(draws, *inputs, slab, cf)[4]
            res["dims"][dim] = {"out": got, "slab_shape": tuple(slab.shape), "stats": stats, "skipped": skipped,
                                "own_extent": own_extent}
        out[n_space] = res
    return out


# the steps of the GT masks on slabs: 3D Mask R-CNN, whose masks go up as
# slabs, and 2D U-Faster R-CNN+, which uploads none
SP_MASK_CASES = ("mrcnn", "ufrcnn")


def sp_mask_case(name):
    """(cf, batch, init seed, env) of a ``SP_MASK_CASES`` step: Mask
    R-CNN as ``sp_train_case``'s (3D, K3's plain version on the slabs,
    positive RoIs sampled) with its batch of 2 in 2 microbatches and no
    remat; U-Faster R-CNN+ as ``sp_seg_case``'s (2D), init seed 1."""
    if name == "mrcnn":
        cf, batch, init, env = sp_train_case(name)
        cf.grad_accum_steps, cf.use_remat = 2, False
        return cf, batch, init, env
    if name == "ufrcnn":
        cf, batch, env = sp_seg_case(name)
        return cf, batch, 1, env
    raise ValueError(f"unknown GT-mask case {name!r}")


def sp_mask_step(cf, batch, init_seed, device="cpu", n_space=None):
    """``sp_train_step`` on one process or, with ``n_space``, over the
    process group as one space group, with each call of
    ``detection_target_layer`` recorded: ``mask_uploads`` lists, per call,
    the shape and dtype of the GT masks it was given (None without)."""
    from medicaldetectiontoolkit_torch.models import mrcnn

    layer, uploads = mrcnn.detection_target_layer, []

    def recorded(*args, **kwargs):
        masks = args[7]
        uploads.append(None if masks is None else (tuple(masks.shape), str(masks.dtype)))
        return layer(*args, **kwargs)

    mrcnn.detection_target_layer = recorded
    try:
        out = sp_train_step(cf, batch, init_seed, device, grid=None if n_space is None else (1, n_space))
    finally:
        mrcnn.detection_target_layer = layer
    out["mask_uploads"] = uploads
    return out


def _sp_mask_rank(name, device, world):
    cf, batch, init, env = sp_mask_case(name)
    with env_scope(env):
        return sp_mask_step(cf, batch, init, device, n_space=world)


def same_detections(a, b, score_tol=1e-5, coord_tol=1e-3):
    """Largest differences (score, coords) between two results' ``boxes``
    (per batch element a list of box dicts), matched as sets: per element
    the same count, and after sorting each by (type, class, coords), the
    same types and classes, scores within ``score_tol`` and coords within
    ``coord_tol``; raises AssertionError otherwise."""
    def key(box):
        return (box["box_type"], box.get("box_pred_class_id", -1), tuple(np.round(np.asarray(box["box_coords"],
                                                                                              float), 2)))

    worst = [0.0, 0.0]
    if len(a) != len(b):
        raise AssertionError(f"detections: {len(a)} elements against {len(b)}")
    for i, (la, lb) in enumerate(zip(a, b)):
        if len(la) != len(lb):
            raise AssertionError(f"detections of element {i}: {len(la)} boxes against {len(lb)}")
        for x, y in zip(sorted(la, key=key), sorted(lb, key=key)):
            if key(x)[:2] != key(y)[:2]:
                raise AssertionError(f"detections of element {i}: {x} against {y}")
            worst[1] = max(worst[1], float(np.abs(np.asarray(x["box_coords"], float)
                                                  - np.asarray(y["box_coords"], float)).max()))
            if "box_score" in x:
                worst[0] = max(worst[0], abs(float(x["box_score"]) - float(y["box_score"])))
    if worst[0] > score_tol or worst[1] > coord_tol:
        raise AssertionError(f"detections differ: max|score| {worst[0]:.3e} (tol {score_tol}), max|coords| "
                             f"{worst[1]:.3e} (tol {coord_tol})")
    return worst


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["dp_rank"]:
        dp_rank_main()
    elif sys.argv[1:2] == ["sp_rank"]:
        sp_rank_main()
