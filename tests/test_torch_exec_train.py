"""The port's training loop against the root ``exec.py``, on the CPU.

* ``ModelSelector`` fed the same ``monitor_metrics`` keeps and deletes the
  same epochs and writes the same ``epoch_ranking``; the JAX package's
  ``load_checkpoint_state`` reads the port's best ``params.pkl`` as
  ``net.jax_params()``; a JAX ``last_checkpoint`` (optax's state) is refused
  by name.
* The port's ``exec.train`` and the root ``exec.train`` on the same small
  synthetic LIDC experiment, both nets stubbed to record what they are fed
  (the JAX generator's patients, one loader worker): the same batches in the
  same order, dispatches and converts interleaved the same way, the same lr
  per step, the same ``monitor_metrics`` and the same file names in the fold
  directory.
* One real ``exec.main(["--mode", "train_test", ...], device="cpu")`` run of
  2 epochs, then ``--resume_to_checkpoint`` to epoch 3, whose first step
  starts from the saved params and Adam state; ``MDT_TRAIN_PIPELINE=0``
  gives the same results as the pipelined loop (which also writes a
  ``torch.profiler`` trace under ``cf.profile``).
"""

import copy
import json
import importlib.util
import math
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pandas")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.lidc_exp import configs as jax_lidc_configs  # noqa: E402
from experiments.lidc_exp import data_loader as jax_dl  # noqa: E402
from experiments.lidc_exp.preprocessing import generate_synthetic_lidc as jax_generate  # noqa: E402
from medicaldetectiontoolkit_tpu.utils import exp_utils as jax_utils  # noqa: E402
from medicaldetectiontoolkit_torch import exec as port_exec  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as port_dl  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402
from medicaldetectiontoolkit_torch.models.retina_net import RetinaNetDetector  # noqa: E402
from medicaldetectiontoolkit_torch.testing import assert_same, make_config, make_lidc_experiment  # noqa: E402
from medicaldetectiontoolkit_torch.utils import exp_utils  # noqa: E402

torch.set_num_threads(2)

EXP_SOURCE = os.path.join(REPO, "medicaldetectiontoolkit_torch", "experiments", "lidc_exp")
ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "2",
       "MDT_LIDC_EPOCHS": "2", "MDT_LIDC_NTB": "2", "MDT_LIDC_NVB": "1"}
SMALL = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4,
         "n_workers": 1, "plot_prediction_histograms": False}


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def _fold_files(fold_dir):
    return sorted(os.path.relpath(os.path.join(d, f), fold_dir) for d, _, fs in os.walk(fold_dir) for f in fs)


###########################
#  model selection        #
###########################


class _SelectorNet:
    """What ModelSelector reads of a net, in both packages' names."""

    def __init__(self, port_net):
        self.port_net = port_net
        self.params = port_net.jax_params()

    def jax_params(self):
        return self.port_net.jax_params()

    def state_dict(self):
        return self.port_net.state_dict()


def _monitor(n_epochs, seed):
    rng = np.random.RandomState(seed)
    m = {"train": {}, "val": {}}
    for split in m:
        for k in ("benign_ap", "malignant_ap", "patient_ap", "patient_auc"):
            m[split][k] = [None] + [float(v) for v in np.round(rng.rand(n_epochs), 1)]  # ties between epochs
        m[split]["monitor_values"] = [[] for _ in range(n_epochs + 1)]
    return m


def test_model_selector_matches_jax(tmp_path):
    cf = make_config(model="retina_unet", dim=2, patch_size=[32, 32])
    net = _SelectorNet(build_model(cf, None, device="cpu"))
    rankings = {}
    for name, module in (("jax", jax_utils), ("port", exp_utils)):
        cf.fold_dir = str(tmp_path / name)
        os.makedirs(cf.fold_dir)
        cf.save_n_models, cf.min_save_thresh, cf.do_validation = 2, 2, True
        cf.model_selection_criteria = ["malignant_ap", "benign_ap"]
        selector = module.ModelSelector(cf, _Log())
        full = _monitor(6, seed=4)
        rankings[name] = []
        for epoch in range(1, 7):
            m = {s: {k: (v[: epoch + 1] if k != "monitor_values" else v) for k, v in d.items()}
                 for s, d in full.items()}
            selector.run_model_selection(net, m, epoch)
            rankings[name].append((_best_dirs(cf.fold_dir), np.load(os.path.join(cf.fold_dir, "epoch_ranking.npy"))
                                   if os.path.isfile(os.path.join(cf.fold_dir, "epoch_ranking.npy")) else None))
    assert_same(rankings["port"], rankings["jax"])
    assert len(rankings["port"][-1][0]) == 2
    assert _fold_files(tmp_path / "port") == _fold_files(tmp_path / "jax")

    # a best checkpoint holds JAX's layout: the JAX package reads it as it is
    best = os.path.join(tmp_path, "port", rankings["port"][-1][0][0])
    state = jax_utils.load_checkpoint_state(best)
    assert sorted(state) == ["epoch", "params"]
    assert_same(state["params"], net.jax_params())
    assert_same(exp_utils.load_checkpoint_state(best)["params"], net.jax_params())


def _best_dirs(fold_dir):
    return sorted(d for d in os.listdir(fold_dir) if d.endswith("_best_checkpoint"))


def test_jax_last_checkpoint_is_refused_by_name(tmp_path):
    import optax

    adam = optax.ScaleByAdamState(count=np.zeros([], np.int32), mu={"w": np.zeros(2)}, nu={"w": np.zeros(2)})
    os.makedirs(tmp_path / "last_checkpoint")
    with open(tmp_path / "last_checkpoint" / "params.pkl", "wb") as handle:
        pickle.dump({"params": {"w": np.zeros(2)}, "opt_state": (adam,), "epoch": 3}, handle)
    with pytest.raises(RuntimeError, match="optax.*convert.py"):
        exp_utils.load_checkpoint(str(tmp_path / "last_checkpoint"), None)


def test_parallel_configs_raise(tmp_path, monkeypatch):
    """``train`` with ``n_space_parallel`` 2 but no process group (not
    started by ``main``) refuses to take single-card steps; on CUDA a run
    takes no more ranks (data x space) than cards; and ``train`` with
    ``n_data_parallel`` 2 but no process group refuses too."""
    cf = make_config()
    cf.fold, cf.exp_dir = 0, str(tmp_path)
    cf.n_space_parallel = 2
    with pytest.raises(RuntimeError, match="n_space_parallel = 2 needs a process group"):
        port_exec.train(cf, port_dl, _Log(), device="cpu")
    cf.n_space_parallel, cf.n_data_parallel = None, 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"2 ranks \(cf.n_data_parallel x cf.n_space_parallel\), but 1 CUDA card"):
        port_exec.train(cf, port_dl, _Log())
    with pytest.raises(RuntimeError, match="needs a process group"):
        port_exec.train(cf, port_dl, _Log(), device="cpu")


###########################
#  the loop vs root exec  #
###########################


class _RecordingNet:
    """Records every dispatch (its batch, flags and lr) and convert; returns
    the GT boxes plus one detection per element and made-up losses that
    depend only on the call count."""

    def __init__(self, cf, record):
        self.cf, self.record = cf, record
        self.params = {"w": np.zeros(2, np.float32)}
        self.current_lr = None
        self.device = torch.device("cpu")

    def initialize(self, seed=None):
        pass

    def jax_params(self):
        return self.params

    def state_dict(self):
        return {"params": self.params, "opt_state": None}

    def train_forward_dispatch(self, batch, is_validation=False, do_update=True):
        self.record.append(("dispatch", is_validation, self.current_lr,
                            {k: batch[k] for k in ("data", "seg", "pid", "bb_target", "roi_labels")}))
        return len(self.record)

    def train_forward_convert(self, handles, batch, need_seg_preds=True):
        self.record.append(("convert", handles, need_seg_preds))
        boxes = []
        for b in range(len(batch["pid"])):
            el = [{"box_coords": np.asarray(c), "box_label": lab, "box_type": "gt"}
                  for c, lab in zip(batch["bb_target"][b], np.asarray(batch["roi_labels"][b]).reshape(-1))]
            if len(batch["bb_target"][b]):
                el.append({"box_coords": np.asarray(batch["bb_target"][b][0]), "box_type": "det",
                           "box_score": 0.2 + (handles * 7 + b) % 8 / 10, "box_pred_class_id": 1 + (handles + b) % 2})
            boxes.append(el)
        loss = 1.0 / handles
        return {"boxes": boxes, "seg_preds": np.zeros((batch["data"].shape[0], 1, *batch["data"].shape[2:]), np.uint8),
                "loss": loss, "monitor_values": {"loss": loss, "class_loss": loss / 2},
                "logger_string": f"loss: {loss:.2f}"}

    def train_forward(self, batch, is_validation=False, do_update=True, need_seg_preds=True):
        return self.train_forward_convert(self.train_forward_dispatch(batch, is_validation, do_update), batch,
                                          need_seg_preds)


def _root_exec():
    saved = dict(os.environ)
    try:
        spec = importlib.util.spec_from_file_location("root_exec", os.path.join(REPO, "exec.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return module


def test_train_loop_matches_root_exec(tmp_path, monkeypatch):
    data_dir = str(tmp_path / "data")
    jax_generate(data_dir, n_patients=8, shape=(16, 48, 48), seed=5)
    cf = make_lidc_experiment(str(tmp_path), ENV, SMALL, data_dir=data_dir, seeds=(), epochs=())
    os.remove(os.path.join(cf.exp_dir, "fold_ids.pickle"))  # each loop writes its own split
    cf.fold, cf.fold_dir, cf.resume_to_checkpoint = 0, os.path.join(cf.exp_dir, "fold_0"), None

    saved = {k: os.environ.get(k) for k in (*ENV, "MDT_LIDC_PP")}
    os.environ.update(ENV, MDT_LIDC_PP=data_dir)
    try:
        jcf = jax_lidc_configs.configs()
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    for k, v in SMALL.items():
        setattr(jcf, k, v)
    jcf.exp_dir = str(tmp_path / "jax_exp")
    jcf.fold, jcf.fold_dir, jcf.plot_dir = 0, os.path.join(jcf.exp_dir, "fold_0"), os.path.join(jcf.exp_dir, "plots")
    jcf.server_env, jcf.created_fold_id_pickle, jcf.resume_to_checkpoint = False, False, None
    os.makedirs(jcf.plot_dir)
    os.makedirs(jcf.fold_dir)
    os.makedirs(cf.fold_dir)

    root_exec = _root_exec()
    records = {"jax": [], "port": []}
    monkeypatch.setattr(root_exec, "build_model", lambda c, log: _RecordingNet(c, records["jax"]))
    monkeypatch.setattr(port_exec, "build_model", lambda c, log, device=None: _RecordingNet(c, records["port"]))
    np.random.seed(0)  # the evaluators' tie jitter and the 3D plot's slice choice
    root_exec.train(jcf, jax_dl, _Log())
    np.random.seed(0)
    out = port_exec.train(cf, port_dl, _Log(), device="cpu")

    assert_same(records["port"], records["jax"])
    n_steps = 2 * (2 + 1 + 1)  # per epoch: 2 train batches, 1 val batch, 1 plotted val batch
    assert sum(r[0] == "dispatch" for r in records["port"]) == n_steps
    assert [r[2] for r in records["port"] if r[0] == "dispatch"] == [1e-4] * n_steps
    with open(os.path.join(jcf.fold_dir, "last_checkpoint", "monitor_metrics.pickle"), "rb") as handle:
        jax_metrics = pickle.load(handle)
    assert {s: {k: len(v) for k, v in d.items()} for s, d in out["monitor_metrics"].items()} == \
        {s: {k: len(v) for k, v in d.items()} for s, d in jax_metrics.items()}
    assert_same(out["monitor_metrics"], jax_metrics)
    assert _fold_files(cf.fold_dir) == _fold_files(jcf.fold_dir)
    assert "epoch_ranking.npy" in os.listdir(cf.fold_dir)
    assert sorted(out["times"]["epoch_s"]) == [1, 2] and all(len(v) == 2 for v in out["times"]["step_s"].values())


###########################
#  real runs on the CPU   #
###########################


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """exec --mode train_test, 2 epochs; then a resume to epoch 3."""
    root = str(tmp_path_factory.mktemp("train"))
    overrides = dict(SMALL, test_n_epochs=1, max_test_patients=1)
    cf = make_lidc_experiment(root, ENV, overrides, n_patients=8, seeds=(), epochs=())
    argv = ["--exp_source", EXP_SOURCE, "--exp_dir", cf.exp_dir, "--folds", "0", "--use_stored_settings"]
    nets = []

    def keep(c, log, device=None):
        nets.append(build_model(c, log, device=device))
        return nets[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(port_exec, "build_model", keep)
    try:
        first = port_exec.main(["--mode", "train_test", *argv], device="cpu")[0]
        final_state = copy.deepcopy(nets[0].state_dict())
        fold_dir = os.path.join(cf.exp_dir, "fold_0")
        first["files"] = sorted(os.listdir(fold_dir))
        first["ranking"] = np.load(os.path.join(fold_dir, "epoch_ranking.npy"))
        # the same experiment, run to 3 epochs
        make_lidc_experiment(root, dict(ENV, MDT_LIDC_EPOCHS="3"), overrides, seeds=(), epochs=())
        starts = []
        real_dispatch = RetinaNetDetector.train_forward_dispatch

        def dispatch(self, batch, is_validation=False, do_update=True):
            if not starts:
                starts.append(copy.deepcopy(self.state_dict()))
            return real_dispatch(self, batch, is_validation, do_update)

        mp.setattr(RetinaNetDetector, "train_forward_dispatch", dispatch)
        last = os.path.join(cf.exp_dir, "fold_0", "last_checkpoint")
        resumed = port_exec.main(["--mode", "train", "--resume_to_checkpoint", last, *argv], device="cpu")[0]
    finally:
        mp.undo()
    return {"cf": cf, "first": first, "final_state": final_state, "resumed": resumed, "start_state": starts[0]}


def test_train_test_writes_checkpoints_and_tests(trained):
    cf, first = trained["cf"], trained["first"]
    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    assert {"epoch_ranking.npy", "last_checkpoint", "1_best_checkpoint", "2_best_checkpoint"} <= set(first["files"])
    ranking = first["ranking"]
    assert sorted(ranking.tolist()) == [1, 2]
    metrics = first["train"]["monitor_metrics"]
    losses = [v["loss"] for split in ("train", "val") for ep in metrics[split]["monitor_values"] for v in ep]
    assert len(losses) == 2 * (2 + 1) and all(math.isfinite(x) for x in losses)
    assert all(len(v) == 3 for k, v in metrics["val"].items())
    # the best checkpoints load back into the port, and the test ran on them
    net = build_model(trained["cf"], None, device="cpu")
    net.load_params(exp_utils.load_checkpoint_state(os.path.join(fold_dir, f"{ranking[0]}_best_checkpoint"))["params"])
    assert len(first["test"]["results"]) == 1
    assert os.path.isfile(os.path.join(cf.exp_dir, "plots", "monitor_0_0.png"))


def test_resume_starts_from_saved_params_and_adam_state(trained):
    start, final = trained["start_state"], trained["final_state"]
    assert list(start["params"]) == list(final["params"])
    for k in final["params"]:
        assert torch.equal(start["params"][k], final["params"][k]), k
    s_opt, f_opt = start["opt_state"], final["opt_state"]
    assert s_opt["param_groups"] == f_opt["param_groups"]
    assert sorted(s_opt["state"]) == sorted(f_opt["state"]) and len(f_opt["state"]) > 0
    for i in f_opt["state"]:
        for k in f_opt["state"][i]:
            assert torch.equal(torch.as_tensor(s_opt["state"][i][k]), torch.as_tensor(f_opt["state"][i][k])), (i, k)
    assert float(f_opt["state"][0]["step"]) == 2 * 2  # 2 epochs x 2 train steps
    resumed = trained["resumed"]
    assert sorted(resumed["times"]["epoch_s"]) == [3]
    ranking = np.load(os.path.join(trained["cf"].exp_dir, "fold_0", "epoch_ranking.npy"))
    assert sorted(ranking.tolist()) == [1, 2, 3]
    assert len(resumed["monitor_metrics"]["val"]["malignant_ap"]) == 4
    assert resumed["monitor_metrics"]["train"]["monitor_values"][1] == \
        trained["first"]["train"]["monitor_metrics"]["train"]["monitor_values"][1]


def test_serial_loop_gives_the_pipelined_results(tmp_path, monkeypatch):
    overrides = dict(SMALL, plot_prediction_histograms=False)
    env = dict(ENV, MDT_LIDC_EPOCHS="1", MDT_LIDC_NTB="3")
    outs = {}
    for mode in ("1", "0"):
        root = str(tmp_path / f"pipeline_{mode}")
        # the pipelined run also traces its steps 2-6 (cf.profile), which changes no result
        cf = make_lidc_experiment(root, env, dict(overrides, profile=mode == "1"), n_patients=8, seeds=(), epochs=())
        monkeypatch.setenv("MDT_TRAIN_PIPELINE", mode)
        np.random.seed(0)
        out = port_exec.main(["--mode", "train", "--exp_source", EXP_SOURCE, "--exp_dir", cf.exp_dir, "--folds", "0",
                              "--use_stored_settings"], device="cpu")[0]
        state = exp_utils.load_checkpoint_state(os.path.join(cf.exp_dir, "fold_0", "last_checkpoint"))
        outs[mode] = (out["monitor_metrics"], state)
        assert os.path.isfile(os.path.join(cf.exp_dir, "profile", "trace.json")) == (mode == "1")
        if mode == "1":  # the program's spans: ranges in the trace, totals in spans.json beside it
            with open(os.path.join(cf.exp_dir, "profile", "trace.json")) as f:
                names = {e.get("name") for e in json.load(f)["traceEvents"]}
            assert {"mdt.dispatch", "mdt.upload"} <= names
            with open(os.path.join(cf.exp_dir, "profile", "spans.json")) as f:
                spans = json.load(f)["spans"]
            assert spans["dispatch"]["count"] >= 1 and spans["upload"]["count"] == spans["dispatch"]["count"]
        shutil.rmtree(os.path.join(root, "data"))
    assert_same(outs["0"], outs["1"])
