"""Experiment bootstrap, logging, checkpoints and the results csv of the port.

Counterpart of ``medicaldetectiontoolkit_tpu/utils/exp_utils.py`` with no
pandas and no jax:
  * ``prep_exp``: experiment dir creation and the snapshot of the configs
    (``configs.py``, ``default_configs.py``) and of the model sources
    (``model.py``, ``backbone.py``), whose paths it sets as
    ``cf.model_source_path`` / ``cf.backbone_source_path``. The port's
    ``build_model`` does not import the snapshotted sources yet: it builds
    the installed ones (ROADMAP.md, Queue 1);
  * ``get_logger``: file + ANSI-coloured console logging;
  * ``save_checkpoint`` / ``load_checkpoint_state``: ``params.pkl`` with the
    JAX package's layout, ``{"params": tree of numpy arrays, "epoch": int}``,
    the tree in flax's names (``Detector.jax_params``). A JAX fold directory
    (``{epoch}_best_checkpoint/params.pkl``) loads as it is, on a machine
    without jax, flax or optax: the unpickler turns the pickles of jax arrays
    into numpy arrays and refuses any other jax, flax or optax class;
  * ``create_csv_output`` with the ``csv`` module.

``ModelSelector`` and ``prepare_monitoring`` come with the training drivers.
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
    """One logger per exp/fold dir, writing ``exec.log`` there and to stdout."""
    tag = os.path.abspath(exp_dir).replace(".", "_")  # dots would imply logger hierarchy
    logger = logging.getLogger(f"medicaldetectiontoolkit_torch.{tag}")
    logger.setLevel(logging.DEBUG)
    for hdlr in list(logger.handlers):  # idempotent re-init for the same dir
        hdlr.close()
        logger.removeHandler(hdlr)
    log_file = os.path.join(exp_dir, "exec.log")
    logger.addHandler(logging.FileHandler(log_file))
    console = ColorHandler(sys.stdout)
    console.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(console)
    logger.propagate = False
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


def prep_exp(dataset_path, exp_path, server_env=False, use_stored_settings=True, is_training=True):
    """Create/enter an experiment dir; snapshot configs + model sources.

    At test time (``is_training=False``) the config is the snapshot in
    ``exp_path``, as in the JAX package.
    """
    package_dir = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    default_cfg_src = os.path.join(package_dir, "config.py")

    def snapshot_model_sources(cf):
        _snapshot(os.path.join(package_dir, "models", model_source_file(cf.model)), os.path.join(exp_path, "model.py"))
        _snapshot(os.path.join(package_dir, "models", "backbone.py"), os.path.join(exp_path, "backbone.py"))

    use_snapshot_sources = False
    if is_training:
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
