"""``exec --mode train_test`` of the port over two data-parallel ranks on the
CPU (gloo), on the small synthetic LIDC experiment of
``tests/test_torch_exec_train.py``.

The command runs in a subprocess with a hard timeout; ``exec.main`` with
``cf.n_data_parallel = 2`` starts the two ranks itself. It trains 2 epochs
(global batch 4, 2 rows per rank) and tests fold 0's two test patients, one
per rank. Only rank 0 writes: one log (rank 0's), the ranked checkpoints and
``epoch_ranking.npy``; rank 1's ``ModelSelector`` writes nothing. The test's
raw prediction pickle and its ``results.txt`` scores equal those of a
single-process ``--mode test`` of the same checkpoints (each patient is
predicted whole on one rank). ``n_space_parallel = 2`` is refused for this
experiment's patch, whose deepest level has one Y row, with JAX's message
(``mesh.check_space_cap``), before any rank starts.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_torch import exec as port_exec  # noqa: E402
from medicaldetectiontoolkit_torch.parallel import mesh  # noqa: E402
from medicaldetectiontoolkit_torch.testing import assert_same, make_config, make_lidc_experiment  # noqa: E402
from medicaldetectiontoolkit_torch.utils import exp_utils  # noqa: E402

torch.set_num_threads(2)

EXP_SOURCE = os.path.join(REPO, "medicaldetectiontoolkit_torch", "experiments", "lidc_exp")
ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "4",
       "MDT_LIDC_EPOCHS": "2", "MDT_LIDC_NTB": "2", "MDT_LIDC_NVB": "1"}
SMALL = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4,
         "n_workers": 1, "plot_prediction_histograms": False, "test_n_epochs": 2}
RUN = "import sys; from medicaldetectiontoolkit_torch import exec as e; e.main(sys.argv[1:], device='cpu')"


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def _scores(path):
    """The score lines of ``results.txt``."""
    with open(path) as handle:
        return [line for line in handle.read().splitlines() if line.startswith("AUC")]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_exec"))
    cf = make_lidc_experiment(root, ENV, dict(SMALL, n_data_parallel=2), n_patients=8, seeds=(), epochs=())
    argv = ["--mode", "train_test", "--exp_source", EXP_SOURCE, "--exp_dir", cf.exp_dir, "--folds", "0",
            "--use_stored_settings"]
    env = dict(os.environ, OMP_NUM_THREADS="2", MDT_DIST_INIT_TIMEOUT="120")
    for key in ("MDT_DIST_COORD", "MDT_DIST_NPROCS", "MDT_DIST_RANK"):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-c", RUN, *argv], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    # the same checkpoints tested by one process
    single = os.path.join(root, "single")
    shutil.copytree(cf.exp_dir, single)
    configs = os.path.join(single, "configs.py")
    with open(configs) as handle:
        text = handle.read()
    with open(configs, "w") as handle:
        handle.write(text.replace("'n_data_parallel': 2", "'n_data_parallel': None"))
    os.remove(os.path.join(single, "results.txt"))
    test_argv = ["--mode", "test", "--exp_source", EXP_SOURCE, "--exp_dir", single, "--folds", "0"]
    world1 = port_exec.main(test_argv, device="cpu")[0]
    return {"cf": cf, "single": single, "world1": world1, "stdout": proc.stdout}


def test_two_ranks_train_and_test(run):
    fold_dir = os.path.join(run["cf"].exp_dir, "fold_0")
    files = set(os.listdir(fold_dir))
    assert {"exec.log", "epoch_ranking.npy", "last_checkpoint", "raw_pred_boxes_list.pickle"} <= files
    assert sorted(np.load(os.path.join(fold_dir, "epoch_ranking.npy")).tolist()) == [1, 2]
    with open(os.path.join(fold_dir, "exec.log")) as handle:
        log = handle.read()
    assert "data-parallel training: rank 0 of 2" in log and "rank 1 of 2" not in log
    assert log.count("tr. batch 1/2") == 2  # one log: rank 0's, one line per epoch
    metrics = pickle.load(open(os.path.join(fold_dir, "last_checkpoint", "monitor_metrics.pickle"), "rb"))
    losses = [v["loss"] for split in ("train", "val") for ep in metrics[split]["monitor_values"] for v in ep]
    assert len(losses) == 2 * (2 + 1) and all(np.isfinite(losses))


def test_test_results_equal_a_single_process_test(run):
    exp_dir, single = run["cf"].exp_dir, run["single"]

    def raw(d):
        with open(os.path.join(d, "fold_0", "raw_pred_boxes_list.pickle"), "rb") as handle:
            return pickle.load(handle)

    a, b = raw(exp_dir), raw(single)
    assert len(a) == 2 and [p for _, p in a] == [p for _, p in b]
    assert_same(a, b)
    scores = _scores(os.path.join(exp_dir, "results.txt"))
    assert scores and scores == _scores(os.path.join(single, "results.txt"))
    assert len(run["world1"]["results"]) == 2


def test_other_ranks_write_no_checkpoint(tmp_path, monkeypatch):
    """``ModelSelector`` on rank 1 of 2 writes nothing; ``prep_exp`` with
    ``write=False`` reads the snapshot rank 0 wrote and writes nothing."""
    cf = make_config()
    cf.fold_dir, cf.do_validation, cf.model_selection_criteria = str(tmp_path), True, ["malignant_ap"]
    cf.min_save_thresh, cf.save_n_models = 0, 2
    monkeypatch.setattr(mesh, "rank_and_world", lambda group=None: (1, 2))
    metrics = {"val": {"malignant_ap": [None, 0.5]}}
    exp_utils.ModelSelector(cf, _Log()).run_model_selection(None, metrics, 1)
    assert os.listdir(tmp_path) == []
    root = tmp_path / "exp"
    monkeypatch.undo()
    exp_utils.prep_exp(EXP_SOURCE, str(root), use_stored_settings=False)
    before = sorted(os.listdir(root))
    monkeypatch.setattr(mesh, "rank_and_world", lambda group=None: (1, 2))
    cf = exp_utils.prep_exp(EXP_SOURCE, str(root), use_stored_settings=True, write=False)
    assert sorted(os.listdir(root)) == before and cf.exp_dir == str(root)


def test_spatial_partitioning_is_refused(tmp_path):
    cf = make_lidc_experiment(str(tmp_path), ENV, dict(SMALL, n_space_parallel=2), n_patients=4, seeds=(),
                              epochs=())
    argv = ["--mode", "train", "--exp_source", EXP_SOURCE, "--exp_dir", cf.exp_dir, "--folds", "0",
            "--use_stored_settings"]
    with pytest.raises(ValueError, match=r"^spatial axis 2 exceeds C5 Y-extent 1 for Y=32 \(stride 32\); use fewer "
                                         "'space' shards$"):
        port_exec.main(argv, device="cpu")
