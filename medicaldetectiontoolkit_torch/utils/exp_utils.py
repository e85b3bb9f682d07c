"""Experiment bootstrap, logging, checkpoints, model selection, monitoring and
the results csv of the port.

Counterpart of ``medicaldetectiontoolkit_tpu/utils/exp_utils.py`` with no
pandas and no jax:
  * ``prep_exp``: experiment dir creation and the snapshot of the configs
    (``configs.py``, ``default_configs.py``) and of the model sources
    (``model.py``, ``backbone.py``), whose paths it sets as
    ``cf.model_source_path`` / ``cf.backbone_source_path``, from which the
    port's ``build_model`` builds the detector;
  * ``get_logger``: file + ANSI-coloured console logging;
  * ``save_checkpoint`` / ``load_checkpoint_state``: ``params.pkl`` with the
    JAX package's layout, ``{"params": tree of numpy arrays, "epoch": int}``,
    the tree in flax's names (``Detector.jax_params``). A JAX fold directory
    (``{epoch}_best_checkpoint/params.pkl``) loads as it is, on a machine
    without jax, flax or optax: the unpickler turns the pickles of jax arrays
    into numpy arrays and refuses any other jax, flax or optax class;
  * ``ModelSelector``: top-k epoch checkpoints ranked by the mean of
    ``cf.model_selection_criteria`` val metrics and ``epoch_ranking.npy`` for
    the test mode's ensembling, as in JAX. A best checkpoint holds
    ``{"params": net.jax_params(), "epoch": e}``, JAX's layout, which this
    package's and the JAX package's test modes read. The always-rewritten
    ``last_checkpoint`` holds the port's own ``Detector.state_dict()`` (the
    parameters under their torch names and the torch Adam state, as numpy
    arrays) and the epoch;
  * ``load_checkpoint``: resume from a ``last_checkpoint`` (or, without the
    optimizer state, from a best checkpoint). A JAX ``last_checkpoint``, which
    holds optax's state, is refused by name: ``utils/convert.py`` converts
    it on a machine with jax;
  * ``prepare_monitoring``: the monitor-metrics dicts and the training plot;
  * ``create_csv_output`` with the ``csv`` module.

In a data-parallel run (``parallel/mesh.py``) only rank 0 writes: the
snapshots of ``prep_exp`` (``write=False`` on the other ranks), the log
file and the checkpoints of ``ModelSelector``.
"""

from __future__ import annotations

import csv
import importlib.util
import logging
import os
import pickle
import shutil
import sys

import numpy as np


class ColorHandler(logging.StreamHandler):
    """Console handler colouring records by severity (ANSI, TTY-only): debug
    green, info plain, warning/error red. Non-TTY streams get plain text."""

    _LEVEL_CODES = {logging.DEBUG: 32, logging.WARNING: 31, logging.ERROR: 31, logging.CRITICAL: 31}

    def emit(self, record):
        try:
            msg = self.format(record)
            code = self._LEVEL_CODES.get(record.levelno)
            if code is not None and getattr(self.stream, "isatty", lambda: False)():
                msg = f"\x1b[{code}m{msg}\x1b[0m"
            self.stream.write(msg + self.terminator)
            self.flush()
        except Exception:
            self.handleError(record)


def get_logger(exp_dir):
    """One logger per exp/fold dir, writing ``exec.log`` there and to stdout;
    on the other ranks of a data-parallel run warnings to stdout only."""
    from medicaldetectiontoolkit_torch.parallel import mesh

    tag = os.path.abspath(exp_dir).replace(".", "_")  # dots would imply logger hierarchy
    logger = logging.getLogger(f"medicaldetectiontoolkit_torch.{tag}")
    logger.setLevel(logging.DEBUG)
    for hdlr in list(logger.handlers):  # idempotent re-init for the same dir
        hdlr.close()
        logger.removeHandler(hdlr)
    console = ColorHandler(sys.stdout)
    console.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(console)
    logger.propagate = False
    if not mesh.is_writer():
        console.setLevel(logging.WARNING)
        return logger
    log_file = os.path.join(exp_dir, "exec.log")
    logger.addHandler(logging.FileHandler(log_file))
    print(f"Logging to {log_file}")
    return logger


def import_module(name, path):
    """Import a module by file path (configs / data_loader plugin mechanism)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _snapshot(src, dst):
    if os.path.isfile(src):
        shutil.copy(src, dst)


def model_source_file(model_name):
    """models/ file of the port defining a given model."""
    return {"retina_unet": "retina_net.py", "ufrcnn": "mrcnn.py"}.get(model_name, f"{model_name}.py")


def prep_exp(dataset_path, exp_path, server_env=False, use_stored_settings=True, is_training=True, write=True):
    """Create/enter an experiment dir; snapshot configs + model sources.

    At test time (``is_training=False``) the config is the snapshot in
    ``exp_path``, as in the JAX package. With ``write=False`` (the other
    ranks of a data-parallel run, after rank 0's ``prep_exp``) the config is
    read from where a writing call reads it, and nothing is written.
    """
    package_dir = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    default_cfg_src = os.path.join(package_dir, "config.py")

    def snapshot_model_sources(cf):
        _snapshot(os.path.join(package_dir, "models", model_source_file(cf.model)), os.path.join(exp_path, "model.py"))
        _snapshot(os.path.join(package_dir, "models", "backbone.py"), os.path.join(exp_path, "backbone.py"))

    use_snapshot_sources = False
    if is_training and not write:
        cf_path = os.path.join(exp_path if use_stored_settings else dataset_path, "configs.py")
        cf = import_module("cf", cf_path).configs(server_env)
        use_snapshot_sources = use_stored_settings
    elif is_training:
        if not os.path.exists(exp_path):
            os.makedirs(os.path.join(exp_path, "plots"))
            _snapshot(os.path.join(dataset_path, "configs.py"), os.path.join(exp_path, "configs.py"))
            _snapshot(default_cfg_src, os.path.join(exp_path, "default_configs.py"))
        os.makedirs(os.path.join(exp_path, "plots"), exist_ok=True)

        if use_stored_settings:
            _snapshot(default_cfg_src, os.path.join(exp_path, "default_configs.py"))
            cf = import_module("cf", os.path.join(exp_path, "configs.py")).configs(server_env)
            if not os.path.isfile(os.path.join(exp_path, "model.py")):
                snapshot_model_sources(cf)
            use_snapshot_sources = True
        else:
            cf = import_module("cf", os.path.join(dataset_path, "configs.py")).configs(server_env)
            snapshot_model_sources(cf)
            _snapshot(default_cfg_src, os.path.join(exp_path, "default_configs.py"))
            _snapshot(os.path.join(dataset_path, "configs.py"), os.path.join(exp_path, "configs.py"))
    else:
        cf = import_module("cf", os.path.join(exp_path, "configs.py")).configs(server_env)
        use_snapshot_sources = True

    if use_snapshot_sources and os.path.isfile(os.path.join(exp_path, "model.py")):
        cf.model_source_path = os.path.join(exp_path, "model.py")
        cf.backbone_source_path = os.path.join(exp_path, "backbone.py")

    cf.exp_dir = exp_path
    cf.test_dir = os.path.join(cf.exp_dir, "test")
    cf.plot_dir = os.path.join(cf.exp_dir, "plots")
    cf.experiment_name = os.path.basename(exp_path.rstrip("/"))
    cf.server_env = server_env
    cf.created_fold_id_pickle = False
    if write:
        os.makedirs(cf.plot_dir, exist_ok=True)
    return cf


#############################
#       checkpoints         #
#############################


def save_checkpoint(path, state):
    """Pickle a state dict (``{"params": net.jax_params(), "epoch": e}`` for
    a best checkpoint) into ``path/params.pkl``; torch tensors in it are
    stored as numpy arrays. Write-then-rename, so a crash mid-write leaves
    the previous checkpoint intact."""
    import torch

    def to_host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, dict):
            return {k: to_host(v) for k, v in x.items()}
        return x

    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, "params.pkl")
    tmp = final + ".tmp"
    with open(tmp, "wb") as handle:
        pickle.dump(to_host(state), handle, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, final)


def _atomic_pickle(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "wb") as handle:
        pickle.dump(obj, handle)
    os.replace(tmp, path)


def _atomic_np_save(path, arr):
    """``np.save`` by write-then-rename: ``epoch_ranking`` is what a
    preempted job's test-time ensembling reads."""
    if not path.endswith(".npy"):
        path += ".npy"
    tmp = path + ".tmp.npy"
    with open(tmp, "wb") as handle:
        np.save(handle, arr)
    os.replace(tmp, path)


def _jax_array_from_pickle(fun, args, arr_state, aval_state):
    """What a pickled ``jax.Array`` holds: its numpy value (jax's own
    ``_reconstruct_array`` rebuilds the numpy array the same way, then puts
    it on a device)."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _CheckpointUnpickler(pickle.Unpickler):
    """Loads ``params.pkl`` without jax, flax or optax: pickled jax arrays
    become numpy arrays, flax's ``FrozenDict`` a dict; any other class of
    those packages is refused by name."""

    _STUBS = {
        ("jax._src.array", "_reconstruct_array"): _jax_array_from_pickle,
        ("flax.core.frozen_dict", "FrozenDict"): dict,
    }

    def find_class(self, module, name):
        if (module, name) in self._STUBS:
            return self._STUBS[(module, name)]
        if module.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise pickle.UnpicklingError(f"checkpoint holds {module}.{name}, which the port cannot load")
        return super().find_class(module, name)


def load_checkpoint_state(path):
    """``path/params.pkl`` as written by this package's or the JAX package's
    ``save_checkpoint``: ``{"params": tree of numpy arrays, "epoch": ...}``."""
    with open(os.path.join(path, "params.pkl"), "rb") as handle:
        return _CheckpointUnpickler(handle).load()


def _to_tensors(x):
    """numpy arrays in a (nested dict of a) checkpoint -> CPU tensors."""
    import torch

    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, dict):
        return {k: _to_tensors(v) for k, v in x.items()}
    return x


def load_checkpoint(checkpoint_path, net):
    """Resume: restore the net's params (and the optimizer state of a
    ``last_checkpoint``); return (epoch + 1, monitor_metrics)."""
    try:
        state = load_checkpoint_state(checkpoint_path)
    except pickle.UnpicklingError as e:
        raise RuntimeError(
            f"{checkpoint_path}: {e}. A JAX last_checkpoint holds optax's state; on a machine with jax, "
            "medicaldetectiontoolkit_torch/utils/convert.py (jax_to_torch, jax_adam_to_torch) converts it, "
            "or Detector.load_params takes its params and opt_state"
        ) from e
    if any(isinstance(v, dict) for v in state["params"].values()):
        net.load_params(state["params"])  # a best checkpoint: JAX's param tree, no optimizer state
    else:
        net.load_state_dict({"params": _to_tensors(state["params"]), "opt_state": _to_tensors(state.get("opt_state"))})
    with open(os.path.join(checkpoint_path, "monitor_metrics.pickle"), "rb") as handle:
        monitor_metrics = pickle.load(handle)
    return state["epoch"] + 1, monitor_metrics


class ModelSelector:
    """Top-k epoch checkpointing by the mean val selection criteria, plus the
    resume checkpoint.

    With ``cf.do_validation = False`` the criteria are read from the train
    metrics, as in the JAX package, so ``--mode test`` has ranked
    checkpoints to ensemble.
    """

    def __init__(self, cf, logger):
        self.cf = cf
        self.logger = logger

    def run_model_selection(self, net, monitor_metrics, epoch):
        """Rank and save (rank 0 of a data-parallel run; the others write
        nothing)."""
        from medicaldetectiontoolkit_torch.parallel import mesh

        if not mesh.is_writer():
            return
        source = "val" if getattr(self.cf, "do_validation", True) else "train"
        non_nan_scores = np.mean(
            np.array([[0 if ii is None else ii for ii in monitor_metrics[source][sc]]
                      for sc in self.cf.model_selection_criteria]),
            0,
        )
        epochs_scores = [ii for ii in non_nan_scores[1:]]
        epoch_ranking = np.argsort(epochs_scores)[::-1] + 1  # epochs start at 1
        epoch_ranking = epoch_ranking[epoch_ranking >= self.cf.min_save_thresh]

        if epoch in epoch_ranking[: self.cf.save_n_models]:
            save_dir = os.path.join(self.cf.fold_dir, f"{epoch}_best_checkpoint")
            save_checkpoint(save_dir, {"params": net.jax_params(), "epoch": epoch})
            _atomic_pickle(os.path.join(save_dir, "monitor_metrics.pickle"), monitor_metrics)
            _atomic_np_save(os.path.join(self.cf.fold_dir, "epoch_ranking"), epoch_ranking[: self.cf.save_n_models])
            _atomic_np_save(os.path.join(save_dir, "epoch_ranking"), epoch_ranking[: self.cf.save_n_models])
            self.logger.info(f"saving current epoch {epoch} at rank {np.argwhere(epoch_ranking == epoch)}")
            # delete checkpoints that fell out of the top-k
            for se in [int(ii.split("_")[0]) for ii in os.listdir(self.cf.fold_dir) if "best_checkpoint" in ii]:
                if se in epoch_ranking[self.cf.save_n_models :]:
                    shutil.rmtree(os.path.join(self.cf.fold_dir, f"{se}_best_checkpoint"), ignore_errors=True)
                    self.logger.info(f"deleting epoch {se} at rank {np.argwhere(epoch_ranking == se)}")

        # always (re)write the resume checkpoint with the optimizer state
        save_dir = os.path.join(self.cf.fold_dir, "last_checkpoint")
        state = dict(net.state_dict())
        state["epoch"] = epoch
        save_checkpoint(save_dir, state)
        _atomic_np_save(os.path.join(save_dir, "epoch_ranking"), epoch_ranking[: self.cf.save_n_models])
        _atomic_pickle(os.path.join(save_dir, "monitor_metrics.pickle"), monitor_metrics)


def prepare_monitoring(cf):
    """Monitor-metrics dicts (train/val per-class AP, patient AUC, raw
    values) and the training plot."""
    from collections import OrderedDict

    from medicaldetectiontoolkit_torch import plotting

    metrics = {"train": OrderedDict(), "val": OrderedDict()}
    metric_classes = []
    if "rois" in cf.report_score_level:
        metric_classes.extend([v for k, v in cf.class_dict.items()])
    if "patient" in cf.report_score_level:
        metric_classes.extend(["patient"])
    for cl in metric_classes:
        metrics["train"][cl + "_ap"] = [None]
        metrics["val"][cl + "_ap"] = [None]
        if cl == "patient":
            metrics["train"][cl + "_auc"] = [None]
            metrics["val"][cl + "_auc"] = [None]
    metrics["train"]["monitor_values"] = [[] for _ in range(cf.num_epochs + 1)]
    metrics["val"]["monitor_values"] = [[] for _ in range(cf.num_epochs + 1)]
    return metrics, plotting.TrainingPlot2Panel(cf)


def create_csv_output(results_list, cf, logger):
    """results_{fold}.csv: patientID | predictionID | coords | score | pred_classID.
    Returns the rows."""
    fold = getattr(cf, "fold", "hold_out")
    out_path = os.path.join(cf.exp_dir, f"results_{fold}.csv")
    logger.info(f"creating csv output file at {out_path}")
    rows = []
    for r in results_list:
        pid = r[1]
        for bix, box in enumerate(r[0][0]):
            assert box["box_type"] == "det", box["box_type"]
            if box["box_score"] >= cf.min_det_thresh:
                rows.append([pid, bix, list(np.asarray(box["box_coords"]).tolist()), box["box_score"],
                             box["box_pred_class_id"]])
    with open(out_path, "w", newline="") as handle:
        writer = csv.writer(handle, lineterminator="\n")
        writer.writerow(["patientID", "predictionID", "coords", "score", "pred_classID"])
        writer.writerows(rows)
    return rows
