#!/usr/bin/env python
"""Execution script of the port: train / test / train_test / analysis /
create_exp.

Counterpart of the root ``exec.py``, with the same CLI (--mode, --folds,
--exp_dir, --exp_source, --server_env, --data_dest, --use_stored_settings,
--resume_to_checkpoint, --dev):

    python -m medicaldetectiontoolkit_torch.exec --mode train_test \\
        --exp_source medicaldetectiontoolkit_torch/experiments/lidc_exp --exp_dir EXP [--folds 0]

(or ``--exp_source medicaldetectiontoolkit_torch/experiments/toy_exp``, or
``medicaldetectiontoolkit_torch/experiments/pet_ct_tnm_classification``: two
input channels, no validation, so that model selection ranks the train
metrics, and a hold-out test set whose ``analysis`` ensembles the folds).
``train`` trains each fold on the CUDA card with the root ``exec.py``'s epoch
structure: the per-epoch lr, the train batches (a one-step-deep pipeline:
step i+1 is dispatched before step i's results are converted on the host;
``MDT_TRAIN_PIPELINE=0`` gives the serial loop, with the same results), the
train evaluation, validation (``val_sampling`` batches or ``val_patient``
whole patients), model selection (ranked best checkpoints, ``last_checkpoint``
with the Adam state), the monitoring plots and a ``val_sampling``
prediction plot. ``--resume_to_checkpoint`` continues from a
``last_checkpoint``. Every registered detector trains (``retina_net``,
``retina_unet``, ``mrcnn``, ``ufrcnn``, ``detection_unet``). ``test`` runs whole-patient inference of
each fold (tiling, mirror TTA, temporal ensembling over the fold's ranked
checkpoints, WBC, 2D->3D merging) and scores it (``results.txt``);
``train_test`` does both; ``analysis`` re-scores the raw prediction pickles;
``create_exp`` prepares an experiment directory. The checkpoints may be the
JAX package's (``{epoch}_best_checkpoint/params.pkl``, loaded as they are).
From Python, ``main(argv, device="cpu")`` runs on the CPU with the plain
PyTorch versions of the kernels.

Data parallelism (``parallel/mesh.py``): with ``cf.n_data_parallel = W > 1``
(``MDT_DP=W``) and no ``MDT_DIST_*`` in the environment, ``main`` runs the
command in W new processes, rank r on ``cuda:r`` over NCCL (on the CPU over
gloo with ``device="cpu"``); with the ``MDT_DIST_*`` triple set (one process
per card, on one host or several) the process joins that job on ``cuda:(rank
% device_count)``. ``cf.batch_size`` is the global batch: each rank trains on
its ``cf.batch_size / W`` rows, and a step equals the single-card step on the
whole batch. The ranks' train and validation results are gathered for the
evaluators; each rank predicts the whole test (and ``val_patient``) patients
of its slice ``pids[rank::W]``, whose results are gathered in the data set's
order. Only rank 0 writes the exp dir (log file, checkpoints,
``epoch_ranking.npy``, monitoring, plots, prediction pickles,
``results.txt``). A rank that raises, or a collective that outlasts
``MDT_DIST_INIT_TIMEOUT``, fails the run.

Spatial partitioning (``cf.n_space_parallel = S > 1``, ``MDT_SP=S``): every
mode but ``analysis`` runs over W = D x S ranks (D = ``cf.n_data_parallel``
or 1), started as above. The S ranks of a space group take the same rows of
the global batch (the loader's slice of data group d of D) and the same
patients of their data slice ``pids[d::D]``; each train, validation and
test forward is split along the image's Y over them (``parallel/mesh.py``)
and gives the single-process results (computed with TF32 off: each rank
turns it off, see ``parallel/mesh.py``). The results are gathered over the
data groups; global rank 0 writes, and ``--resume_to_checkpoint`` loads on
every rank and broadcasts rank 0's parameters. More ranks than cards are
refused unless the caller of ``main`` names the gloo backend
(``backend="gloo"``: two ranks may then share a card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import medicaldetectiontoolkit_torch.utils.exp_utils as utils
from medicaldetectiontoolkit_torch import native
from medicaldetectiontoolkit_torch.evaluator import Evaluator
from medicaldetectiontoolkit_torch.models import build_model
from medicaldetectiontoolkit_torch.parallel import mesh
from medicaldetectiontoolkit_torch.plotting import plot_batch_prediction
from medicaldetectiontoolkit_torch.predictor import Predictor
from medicaldetectiontoolkit_torch.utils import trace


def _n_ranks(cf) -> int:
    """W = D x S: ``cf.n_data_parallel`` by ``cf.n_space_parallel``."""
    return (getattr(cf, "n_data_parallel", None) or 1) * (getattr(cf, "n_space_parallel", None) or 1)


def _check_parallel(cf, device, backend=None):
    """Refuse a split whose deepest level has fewer Y rows than
    ``cf.n_space_parallel`` (``mesh.check_space_cap``, JAX's message), and
    more ranks than cards where this command starts the ranks itself
    (unless ``backend`` is gloo)."""
    n_space = getattr(cf, "n_space_parallel", None) or 1
    if n_space > 1:
        mesh.check_space_cap(cf, n_space, cf.patch_size[0])
    n = _n_ranks(cf)
    if n > 1 and not mesh.dist.is_initialized() and (device is None or str(device).startswith("cuda")) and \
            backend != "gloo":
        import torch

        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks (cf.n_data_parallel x cf.n_space_parallel), but {torch.cuda.device_count()} "
                             "CUDA card(s) are visible: one rank per card, unless the caller names the gloo backend")


def _data_parallel(cf, net):
    """Make ``net`` a rank of the process group's data-parallel run, or of
    its (data x space) grid under ``cf.n_space_parallel > 1`` (the loader
    then takes the data group's slice, ``cf.input_shard``, its generators
    seeded alike on the S ranks of a space group and read in a fixed order,
    ``data/loader.py``, so that those ranks take the same rows at every
    step); on one card nothing. ``cf.n_data_parallel``, where set, must be
    the group's size without spatial partitioning. Returns the group whose ranks hold other
    rows (None: the whole job)."""
    n_space = getattr(cf, "n_space_parallel", None) or 1
    if n_space > 1:
        if not mesh.dist.is_initialized():
            raise RuntimeError(f"cf.n_space_parallel = {n_space} needs a process group: run through exec.main, which "
                               "starts the ranks, or under MDT_DIST_*")
        grid = net.enable_spatial_parallel()
        cf.input_shard = (grid.data_index, grid.n_data)
        return grid.data_group
    _, world = mesh.rank_and_world()
    n = getattr(cf, "n_data_parallel", None)
    if not mesh.dist.is_initialized():
        if (n or 1) > 1:
            raise RuntimeError(f"cf.n_data_parallel = {n} needs a process group: run through exec.main, which starts "
                               "the ranks, or under MDT_DIST_*")
        return
    if (n or world) != world:
        raise ValueError(f"cf.n_data_parallel = {n}, but the process group has {world} ranks")
    net.enable_data_parallel()
    return None


class _StepProfiler:
    """``torch.profiler`` over train steps 2-6 of an epoch (``cf.profile``),
    the trace written to ``exp_dir/profile/trace.json`` and the program's
    spans and counters of those steps (``utils/trace.py``: ``mdt.`` ranges
    in the trace) summed in ``spans.json`` beside it."""

    def __init__(self, cf, logger, device):
        self.out_dir = os.path.join(cf.exp_dir, "profile")
        self.logger = logger
        self.device = device
        self.prof = None

    def step(self, bix):
        import torch

        if bix == 2:  # skip the first steps (cuDNN plans, allocator growth)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.__enter__()
        elif bix == 7:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(os.path.join(self.out_dir, "spans.json"), "w") as f:
            json.dump(trace.summary(), f, indent=1)
        self.logger.info(f"profiler trace and span summary written to {self.out_dir}")
        self.prof = None


def train(cf, data_loader, logger, device=None):
    """Training routine for one fold; writes plots and checkpoints to the exp
    dir. Returns {"monitor_metrics", "times", "loader"}: per epoch the wall
    seconds of the epoch (``epoch_s``) and of its train batches
    (``train_s``), each train step's seconds as the step log gives them
    (``step_s``) and the host seconds the loop waited for each train batch
    (``load_s``); the train loader's worker count, batch size and host
    seconds per generated batch."""
    _check_parallel(cf, device)
    writer = mesh.is_writer()
    logger.info(
        "performing training in {}D over fold {} on experiment {} with model {}".format(
            cf.dim, cf.fold, cf.exp_dir, cf.model
        )
    )
    net = build_model(cf, logger, device=device)
    net.initialize()
    rows_group = _data_parallel(cf, net)
    model_selector = utils.ModelSelector(cf, logger)
    train_evaluator = Evaluator(cf, logger, mode="train")
    val_evaluator = Evaluator(cf, logger, mode=cf.val_mode)

    starting_epoch = 1
    monitor_metrics, training_plot = utils.prepare_monitoring(cf)

    if cf.resume_to_checkpoint:
        starting_epoch, monitor_metrics = utils.load_checkpoint(cf.resume_to_checkpoint, net)
        for split in monitor_metrics.values():  # room for epochs beyond the checkpoint's run
            split["monitor_values"] += [[] for _ in range(cf.num_epochs + 1 - len(split["monitor_values"]))]
        logger.info(f"resumed to checkpoint {cf.resume_to_checkpoint} at epoch {starting_epoch}")

    logger.info("loading dataset and initializing batch generators...")
    batch_gen = data_loader.get_train_generators(cf, logger)
    if native.enabled():
        native.get_lib()
        info = native.lib_info()
        logger.info(f"native host library {info['path']} ({info['compiler']}, {info['omp_threads']} OpenMP threads)")
    else:
        logger.info("MDT_NO_NATIVE=1: augmentation and consolidation run on NumPy / scipy")
    # one-step-deep software pipeline: dispatch step i+1 to the device BEFORE
    # converting step i's results on the host (box building, logging and the
    # monitor floats wait for the device), so the device does not idle on
    # host monitoring. MDT_TRAIN_PIPELINE=0 restores the serial loop
    # (identical results, order preserved).
    pipelined = os.environ.get("MDT_TRAIN_PIPELINE", "1") != "0"
    times = {"epoch_s": {}, "train_s": {}, "step_s": {}, "load_s": {}}

    try:
        for epoch in range(starting_epoch, cf.num_epochs + 1):
            logger.info(f"starting training epoch {epoch}")
            net.current_lr = cf.learning_rate[epoch - 1]

            start_time = time.time()
            train_results_list = []
            step_s = times["step_s"][epoch] = []
            load_s = times["load_s"][epoch] = []
            profiler = _StepProfiler(cf, logger, net.device) if getattr(cf, "profile", False) and \
                epoch == starting_epoch and writer else None
            pending = None

            def _finish(handles, fbatch, fbix, tic, foreign=0.0):
                # monitoring consumes boxes + floats only: skip the
                # full-volume seg_preds copy
                results_dict = net.train_forward_convert(handles, fbatch, need_seg_preds=False)
                # 'foreign' is host time spent on the NEXT batch (loading +
                # dispatch) between this batch's tic and now: subtracted, so
                # the pipelined log reports this step's own device + convert
                # time, not step + data time
                train_time_step = time.time() - tic - foreign
                step_s.append(train_time_step)
                logger.info(
                    "tr. batch {0}/{1} (ep. {2}) step {3:.3f}s || ".format(
                        fbix + 1, cf.num_train_batches, epoch, train_time_step
                    )
                    + results_dict["logger_string"]
                )
                train_results_list.append([results_dict["boxes"], fbatch["pid"]])
                monitor_metrics["train"]["monitor_values"][epoch].append(results_dict["monitor_values"])

            for bix in range(cf.num_train_batches):
                if profiler is not None:
                    profiler.step(bix)
                t_load0 = time.time()
                batch = next(batch_gen["train"])
                tic_fw = time.time()
                load_s.append(tic_fw - t_load0)
                if pipelined:
                    handles = net.train_forward_dispatch(batch)
                    if pending is not None:
                        _finish(*pending, foreign=time.time() - t_load0)
                    pending = (handles, batch, bix, tic_fw)
                else:
                    _finish(net.train_forward_dispatch(batch), batch, bix, tic_fw)
            if pending is not None:
                _finish(*pending)
            if profiler is not None:
                profiler.stop()

            # every rank's rows; rank 0 scores them, selects and writes
            train_results_list = mesh.gather_objects(train_results_list, rows_group)
            if writer:
                _, monitor_metrics["train"] = train_evaluator.evaluate_predictions(
                    train_results_list, monitor_metrics["train"]
                )
            train_time = time.time() - start_time

            logger.info(f"starting validation in mode {cf.val_mode}.")
            if cf.do_validation:
                val_results_list = []
                val_predictor = Predictor(cf, net, logger, mode="val")
                pending_val = None  # val_sampling pipelines one-deep like training

                def _record_val(results_dict, fbatch):
                    val_results_list.append(([results_dict["boxes"], fbatch["pid"]], results_dict["monitor_values"]))

                for _ in range(batch_gen["n_val"]):
                    batch = next(batch_gen[cf.val_mode])
                    if cf.val_mode == "val_patient":
                        _record_val(val_predictor.predict_patient(batch), batch)
                    elif pipelined:
                        handles = net.train_forward_dispatch(batch, is_validation=True)
                        if pending_val is not None:
                            _record_val(net.train_forward_convert(*pending_val, need_seg_preds=False),
                                        pending_val[1])
                        pending_val = (handles, batch)
                    else:
                        _record_val(net.train_forward(batch, is_validation=True, need_seg_preds=False), batch)
                if pending_val is not None:
                    _record_val(net.train_forward_convert(*pending_val, need_seg_preds=False), pending_val[1])
                if cf.val_mode == "val_patient":  # each rank validated patients of its own
                    val_results_list = mesh.gather_interleaved(val_results_list, rows_group)
                entries = [entry for entry, _ in val_results_list]
                # a val_sampling step's monitor values are the global batch's on every rank
                monitor_metrics["val"]["monitor_values"][epoch] += [monitor for _, monitor in val_results_list]
                if cf.val_mode != "val_patient":
                    entries = mesh.gather_objects(entries, rows_group)
                if writer:
                    _, monitor_metrics["val"] = val_evaluator.evaluate_predictions(entries, monitor_metrics["val"])
                    logger.info(f"val results epoch {epoch}: " + ", ".join(
                        f"{k} {v[-1]}" for k, v in monitor_metrics["val"].items() if k != "monitor_values"))
            if writer:
                # without validation, selection reads the train metrics
                model_selector.run_model_selection(net, monitor_metrics, epoch)
                training_plot.update_and_save(monitor_metrics, epoch)
            epoch_time = time.time() - start_time
            times["epoch_s"][epoch], times["train_s"][epoch] = epoch_time, train_time
            logger.info(f"trained epoch {epoch}: took {epoch_time:.1f} sec. ({train_time:.1f} train / "
                        f"{epoch_time - train_time:.1f} val)")
            batch = next(batch_gen["val_sampling"])
            results_dict = net.train_forward(batch, is_validation=True)
            if writer:
                logger.info("plotting predictions from validation sampling.")
                plot_batch_prediction(batch, results_dict, cf)
        mesh.barrier()  # the last checkpoints are written before any rank tests
    finally:
        for key in ("train", "val_sampling"):
            if key in batch_gen:
                batch_gen[key].shutdown()
    loader = {"n_workers": batch_gen["train"].n_workers, "batch_size": cf.batch_size,
              "batch_seconds": list(batch_gen["train"].batch_seconds)}
    return {"monitor_metrics": monitor_metrics, "times": times, "loader": loader}


def test(cf, data_loader, logger, device=None):
    """Testing for one fold (or the hold-out set): predict, consolidate,
    score. Returns {"results": consolidated results per patient,
    "predictor", "evaluator", "evaluation_s": host seconds of the scoring};
    the predictor's ``times`` hold the other stages. In a data-parallel run
    each rank predicts the patients of its slice, the results are gathered
    and rank 0 scores them; under spatial partitioning the slices are the
    data groups' (the Predictor enables it)."""
    _check_parallel(cf, device)
    logger.info(f"starting testing model of fold {cf.fold} in exp {cf.exp_dir}")
    net = build_model(cf, logger, device=device)
    net.initialize()
    test_predictor = Predictor(cf, net, logger, mode="test")
    if net.space is not None:  # the loader takes this rank's data slice, as mesh.host_shard_info reads it
        cf.input_shard = (net.space.grid.data_index, net.space.grid.n_data)
    test_evaluator = Evaluator(cf, logger, mode="test")
    batch_gen = data_loader.get_test_generator(cf, logger)
    test_results_list = test_predictor.predict_test_set(batch_gen, return_results=True)
    t0 = time.perf_counter()
    if mesh.is_writer():
        test_evaluator.evaluate_predictions(test_results_list)
        test_evaluator.score_test_df()
    return {"results": test_results_list, "predictor": test_predictor, "evaluator": test_evaluator,
            "evaluation_s": time.perf_counter() - t0}


def _close(logger):
    for hdlr in logger.handlers:
        hdlr.close()
    logger.handlers = []


def apply_dev_shrinkage(cf, args, folds):
    if args.dev:
        if folds is None:
            folds = [0, 1]
        cf.batch_size = 3 if cf.dim == 2 else 1
        cf.num_epochs, cf.min_save_thresh, cf.save_n_models = 1, 0, 1
        cf.num_train_batches, cf.num_val_batches, cf.max_val_patients = 5, 1, 1
        cf.test_n_epochs = cf.save_n_models
        cf.max_test_patients = 1
    return folds


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--mode", type=str, default="train_test",
                        help="pipeline stage to run: train | test | train_test | analysis | create_exp")
    parser.add_argument("-f", "--folds", nargs="+", type=int, default=None,
                        help="cross-validation folds to process (default: every fold)")
    parser.add_argument("--exp_dir", type=str, default=os.path.join(tempfile.gettempdir(), "mdt_torch_exp"),
                        help="experiment output directory (created on demand)")
    parser.add_argument("--server_env", default=False, action="store_true",
                        help="switch IO paths to the cluster layout from the experiment config")
    parser.add_argument("--data_dest", type=str, default=None,
                        help="override the config's preprocessed-data location")
    parser.add_argument("--use_stored_settings", default=False, action="store_true",
                        help="run with the config snapshot already in exp_dir rather than the source tree")
    parser.add_argument("--resume_to_checkpoint", type=str, default=None,
                        help="checkpoint directory to continue training from (pick the fold via --folds)")
    parser.add_argument("--exp_source", type=str, default="medicaldetectiontoolkit_torch/experiments/lidc_exp",
                        help="experiment package providing configs.py and data_loader.py")
    parser.add_argument("-d", "--dev", default=False, action="store_true",
                        help="tiny-scale smoke mode: few batches, few epochs, one patient")
    return parser.parse_args(argv)


def _prep_exp(*args, **kwargs):
    """``utils.prep_exp`` on rank 0 first; the other ranks then read the
    configuration it wrote and write nothing."""
    if mesh.is_writer():
        cf = utils.prep_exp(*args, **kwargs)
        mesh.barrier()
        return cf
    mesh.barrier()
    return utils.prep_exp(*args, write=False, **kwargs)


def _spawned(cf, argv, device, backend):
    """With W = ``cf.n_data_parallel`` x ``cf.n_space_parallel`` > 1 and no
    process group: run this command in W new processes
    (``mesh.spawn_ranks``) and wait. Returns whether it did."""
    if _n_ranks(cf) == 1 or mesh.dist.is_initialized():
        return False
    _check_parallel(cf, device, backend)
    mesh.spawn_ranks(main, _n_ranks(cf), (argv, device, backend))
    return True


def main(argv=None, device=None, backend=None):
    """Run the CLI on ``argv``; ``device`` None is the CUDA card. Returns
    ``{fold: result}``: train()'s in train mode, test()'s in test mode, both
    as ``{"train", "test"}`` in train_test mode; ``{}`` where it started the
    ranks of a data-parallel run (their results stay in the exp dir).
    ``backend`` names the ranks' ``torch.distributed`` backend (default:
    NCCL on cards, gloo on the CPU); ``"gloo"`` lets the ranks that this
    call starts share cards."""
    argv = sys.argv[1:] if argv is None else list(argv)
    distributed = mesh.maybe_initialize_distributed(device=device, backend=backend)
    try:
        return _run(parse_args(argv), argv, device, backend)
    finally:
        if distributed:
            mesh.dist.destroy_process_group()


def _run(args, argv, device, backend):
    folds = args.folds
    out = {}

    if args.mode in ("train", "train_test"):
        cf = _prep_exp(args.exp_source, args.exp_dir, args.server_env, args.use_stored_settings)
        if _spawned(cf, argv, device, backend):
            return out
        folds = apply_dev_shrinkage(cf, args, folds)
        cf.data_dest = args.data_dest
        data_loader = utils.import_module("dl", os.path.join(args.exp_source, "data_loader.py"))
        if folds is None:
            folds = range(cf.n_cv_splits)
        for fold in folds:
            cf.fold_dir = os.path.join(cf.exp_dir, f"fold_{fold}")
            cf.fold = fold
            cf.resume_to_checkpoint = args.resume_to_checkpoint
            if mesh.is_writer():
                os.makedirs(cf.fold_dir, exist_ok=True)
            logger = utils.get_logger(cf.fold_dir)
            try:
                trained = train(cf, data_loader, logger, device=device)
                cf.resume_to_checkpoint = None
                if args.mode == "train_test":
                    out[fold] = {"train": trained, "test": test(cf, data_loader, logger, device=device)}
                else:
                    out[fold] = trained
            finally:
                _close(logger)

    elif args.mode == "test":
        cf = _prep_exp(args.exp_source, args.exp_dir, args.server_env, is_training=False, use_stored_settings=True)
        if _spawned(cf, argv, device, backend):
            return out
        if args.dev:
            folds = [0, 1]
            cf.test_n_epochs = 1
            cf.max_test_patients = 1
        cf.data_dest = args.data_dest
        data_loader = utils.import_module("dl", os.path.join(args.exp_source, "data_loader.py"))
        if folds is None:
            folds = range(cf.n_cv_splits)
        for fold in folds:
            cf.fold_dir = os.path.join(cf.exp_dir, f"fold_{fold}")
            cf.fold = fold
            logger = utils.get_logger(cf.fold_dir)
            out[fold] = test(cf, data_loader, logger, device=device)
            _close(logger)

    elif args.mode == "analysis":
        cf = utils.prep_exp(args.exp_source, args.exp_dir, args.server_env, is_training=False, use_stored_settings=True)
        logger = utils.get_logger(cf.exp_dir)
        if cf.hold_out_test_set:
            cf.folds = args.folds
            predictor = Predictor(cf, net=None, logger=logger, mode="analysis")
            results_list = predictor.load_saved_predictions(apply_wbc=True)
            utils.create_csv_output(results_list, cf, logger)
        else:
            if folds is None:
                folds = range(cf.n_cv_splits)
            for fold in folds:
                cf.fold_dir = os.path.join(cf.exp_dir, f"fold_{fold}")
                cf.fold = fold
                predictor = Predictor(cf, net=None, logger=logger, mode="analysis")
                results_list = predictor.load_saved_predictions(apply_wbc=True)
                logger.info("starting evaluation...")
                evaluator = Evaluator(cf, logger, mode="test")
                evaluator.evaluate_predictions(results_list)
                evaluator.score_test_df()
        _close(logger)

    elif args.mode == "create_exp":
        cf = utils.prep_exp(args.exp_source, args.exp_dir, args.server_env, use_stored_settings=True)
        logger = utils.get_logger(cf.exp_dir)
        logger.info(f"created experiment directory at {args.exp_dir}")
        _close(logger)

    else:
        raise RuntimeError(f"unknown --mode {args.mode!r}; see --help for the supported stages")
    return out


if __name__ == "__main__":
    main()
