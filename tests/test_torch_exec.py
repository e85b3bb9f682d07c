"""The port's test mode as a whole against the JAX package's, on the CPU.

The same synthetic LIDC patients (written by the JAX generator) and the same
two ranked checkpoints (a JAX Retina U-Net's, written by the JAX
``save_checkpoint``) go through the JAX ``Predictor`` + ``Evaluator`` and
through ``python -m medicaldetectiontoolkit_torch.exec --mode test`` (as
``exec.main(argv, device="cpu")``), which reads the JAX checkpoints as they
are. Tolerances, those of ``tests/test_torch_retina.py::
test_test_forward_matches_jax`` for the detections (float32 convs summed in
another order): the raw boxes of every rank, mirror and patch equal in coords,
class and patch metadata, scores within 1e-5; after WBC the same clusters
per class, scores within 1e-5 and coords (score-weighted means) within 1e-4
voxels; the same AP / AUC lines. The JAX side's WBC runs its NumPy loop, which
``tests/test_native_wbc.py`` holds equal to its native copy.

Also: the JAX checkpoint loads into the port in a process where importing
jax, flax or optax fails, as on the card's machine.
"""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.lidc_exp import configs as jax_lidc_configs  # noqa: E402
from experiments.lidc_exp import data_loader as jax_dl  # noqa: E402
from experiments.lidc_exp.preprocessing import generate_synthetic_lidc as jax_generate  # noqa: E402
from medicaldetectiontoolkit_tpu import native  # noqa: E402
from medicaldetectiontoolkit_tpu.evaluator import Evaluator as JaxEvaluator  # noqa: E402
from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.predictor import Predictor as JaxPredictor  # noqa: E402
from medicaldetectiontoolkit_tpu.utils.exp_utils import save_checkpoint as jax_save_checkpoint  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_lidc_experiment, run_lidc_test  # noqa: E402
from medicaldetectiontoolkit_torch.utils import exp_utils  # noqa: E402

torch.set_num_threads(2)

ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "4"}
SMALL = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4,
         "plot_prediction_histograms": False}
EPOCHS = (3, 1)


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run and the port's run of fold 0's test split."""
    root = tmp_path_factory.mktemp("slice")
    data_dir = str(root / "data")
    jax_generate(data_dir, n_patients=4, shape=(16, 48, 48), seed=0)

    # the port's exp dir: its LIDC configs pinned to the same setting; the
    # JAX detector's checkpoints go into its fold 0
    cf = make_lidc_experiment(str(root), ENV, SMALL, seeds=(), epochs=())
    fold_dir = os.path.join(cf.exp_dir, "fold_0")

    saved = {k: os.environ.get(k) for k in (*ENV, "MDT_LIDC_PP")}
    os.environ.update(ENV, MDT_LIDC_PP=data_dir)
    try:
        jcf = jax_lidc_configs.configs()
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    for k, v in SMALL.items():
        setattr(jcf, k, v)
    jcf.exp_dir = str(root / "jax_exp")
    jcf.fold, jcf.fold_dir, jcf.plot_dir = 0, os.path.join(jcf.exp_dir, "fold_0"), os.path.join(jcf.exp_dir, "plots")
    jcf.server_env, jcf.created_fold_id_pickle = False, True
    os.makedirs(jcf.plot_dir)
    shutil.copy(os.path.join(cf.exp_dir, "fold_ids.pickle"), jcf.exp_dir)

    jnet = jbuild(jcf, _Log())
    for seed, epoch in zip((0, 1), EPOCHS):
        jnet.initialize(seed=seed)
        jax_save_checkpoint(os.path.join(jcf.fold_dir, f"{epoch}_best_checkpoint"), {"params": jnet.params, "epoch": epoch})
    np.save(os.path.join(jcf.fold_dir, "epoch_ranking.npy"), np.array(EPOCHS))
    shutil.copytree(jcf.fold_dir, fold_dir)

    real_get_lib = native.get_lib
    native.get_lib = lambda: None
    try:
        jres = JaxPredictor(jcf, jnet, _Log(), mode="test").predict_test_set(jax_dl.get_test_generator(jcf, _Log()))
        jev = JaxEvaluator(jcf, _Log(), mode="test")
        jev.evaluate_predictions(jres)
        jev.score_test_df()
    finally:
        native.get_lib = real_get_lib

    tout = run_lidc_test(cf, device="cpu")
    return {"jax": (jcf, jres, jev), "port": (cf, tout), "jnet": jnet, "root": root}


def _raw(cf):
    with open(os.path.join(cf.exp_dir, "fold_0", "raw_pred_boxes_list.pickle"), "rb") as handle:
        return pickle.load(handle)


def test_raw_predictions_match_jax(runs):
    jraw, traw = _raw(runs["jax"][0]), _raw(runs["port"][0])
    assert [r[1] for r in traw] == [r[1] for r in jraw]
    n_det = 0
    for (tb, _), (jb, _) in zip(traw, jraw):
        assert len(tb) == len(jb) == 1
        assert len(tb[0]) == len(jb[0])
        for t, j in zip(tb[0], jb[0]):
            assert set(t) == set(j)
            np.testing.assert_array_equal(np.asarray(t["box_coords"]), np.asarray(j["box_coords"]))
            if t["box_type"] == "det":
                n_det += 1
                assert abs(t["box_score"] - j["box_score"]) <= 1e-5
            for k in set(t) - {"box_coords", "box_score"}:
                assert np.array_equal(t[k], j[k]), (k, t[k], j[k])
    assert n_det > 0


def test_consolidated_results_match_jax(runs):
    jres, tres = runs["jax"][1], runs["port"][1]["results"]
    assert [r[1] for r in tres] == [r[1] for r in jres]
    for (tb, _), (jb, _) in zip(tres, jres):
        for cl in (1, 2):
            td = [b for b in tb[0] if b["box_type"] == "det" and b["box_pred_class_id"] == cl]
            jd = [b for b in jb[0] if b["box_type"] == "det" and b["box_pred_class_id"] == cl]
            assert len(td) == len(jd) > 0
            for t, j in zip(td, jd):
                assert abs(t["box_score"] - j["box_score"]) <= 1e-5
                np.testing.assert_allclose(np.asarray(t["box_coords"]), np.asarray(j["box_coords"]), rtol=0, atol=1e-4)
        gts = [[b["box_label"] for b in bl if b["box_type"] == "gt"] for bl in (tb[0], jb[0])]
        assert gts[0] == gts[1]


def test_scores_match_jax(runs):
    (jcf, _, jev), (cf, tout) = runs["jax"], runs["port"]
    jstats, tstats = jev.return_metrics()[0], tout["evaluator"].return_metrics()[0]
    for t, j in zip(tstats, jstats):
        assert t["name"] == j["name"]
        for k in ("ap", "auc"):
            assert t[k] == pytest.approx(j[k], abs=1e-9, nan_ok=True), (t["name"], k)
    with open(os.path.join(jcf.exp_dir, "results.txt")) as a, open(os.path.join(cf.exp_dir, "results.txt")) as b:
        assert a.read() == b.read()
    assert os.path.isfile(os.path.join(cf.exp_dir, "0_test_df.pickle"))
    assert set(tout["predictor"].times) == {"forward", "patient", "consolidation"}


_NO_JAX = """
import importlib.abc, sys

class Blocked(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Blocked())
"""


def test_jax_checkpoint_loads_without_jax(runs, tmp_path):
    """The JAX best checkpoint as it is, and a pickle of the raw jax arrays,
    load into the port's detector where jax, flax and optax cannot be
    imported; the weights equal the JAX params converted in this process."""
    cf = runs["port"][0]
    ckpt = os.path.join(cf.exp_dir, "fold_0", f"{EPOCHS[0]}_best_checkpoint")
    raw_dir = tmp_path / "raw"
    os.makedirs(raw_dir)
    with open(raw_dir / "params.pkl", "wb") as handle:  # jax arrays, no device_get
        pickle.dump({"params": runs["jnet"].params, "epoch": 1}, handle)
    code = _NO_JAX + f"""
import numpy as np
from medicaldetectiontoolkit_torch.models import build_model
from medicaldetectiontoolkit_torch.utils import exp_utils
cf = exp_utils.prep_exp(None, {cf.exp_dir!r}, is_training=False)
net = build_model(cf, None, device="cpu")
out = {{}}
for tag, path in (("ckpt", {ckpt!r}), ("raw", {str(raw_dir)!r})):
    state = exp_utils.load_checkpoint_state(path)
    assert isinstance(state["epoch"], int)
    net.load_params(state["params"])
    out.update({{tag + "/" + k: v.numpy().copy() for k, v in net.module.state_dict().items()}})
np.savez({str(tmp_path / "sd.npz")!r}, **out)
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax")))
"""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout
    from medicaldetectiontoolkit_tpu.utils.exp_utils import load_checkpoint_state as jax_load
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.utils import convert

    module = build_model(cf, None, device="cpu").module
    got = np.load(tmp_path / "sd.npz")
    for tag, tree in (("ckpt", jax_load(ckpt)["params"]), ("raw", jax.device_get(runs["jnet"].params))):
        for k, v in convert.jax_to_torch(tree, module).items():
            np.testing.assert_array_equal(got[f"{tag}/{k}"], v.numpy())


def test_checkpoint_refuses_other_jax_classes(tmp_path):
    optax = pytest.importorskip("optax")
    os.makedirs(tmp_path / "ckpt")
    state = optax.adam(1e-3).init({"w": jax.numpy.ones(3)})
    with open(tmp_path / "ckpt" / "params.pkl", "wb") as handle:
        pickle.dump({"opt_state": state}, handle)
    with pytest.raises(pickle.UnpicklingError, match="optax"):
        exp_utils.load_checkpoint_state(str(tmp_path / "ckpt"))


def test_csv_output_matches_jax(runs, tmp_path):
    """results_{fold}.csv of the consolidated detections: the csv module's
    file equals pandas' byte for byte."""
    from types import SimpleNamespace

    from medicaldetectiontoolkit_tpu.utils.exp_utils import create_csv_output as jax_csv

    results = [[[[b for b in r[0][0] if b["box_type"] == "det"]], r[1]] for r in runs["port"][1]["results"]]
    texts = []
    for name, fn in (("jax", jax_csv), ("port", exp_utils.create_csv_output)):
        cf = SimpleNamespace(exp_dir=str(tmp_path / name), fold=0, min_det_thresh=0.1)
        os.makedirs(cf.exp_dir)
        fn(results, cf, _Log())
        texts.append((tmp_path / name / "results_0.csv").read_text())
    assert texts[1] == texts[0]
    assert texts[1].count("\n") > 1


@pytest.mark.parametrize("mode", ["train", "train_test"])
def test_training_modes_are_not_ported(mode, tmp_path):
    """Every detector the port registers trains (``tests/test_torch_exec_train.py``,
    ``tests/test_torch_mrcnn_train.py``, ``tests/test_torch_detection_unet.py``);
    for a model nothing registers exec's train modes raise, naming the five
    models the port has, instead of running another model."""
    from medicaldetectiontoolkit_torch.testing import run_lidc_train

    # the LIDC config is built for Retina U-Net, then names a model nothing registers
    env = dict(ENV, MDT_LIDC_EPOCHS="1", MDT_LIDC_NTB="1", MDT_LIDC_NVB="1")
    cf = make_lidc_experiment(str(tmp_path), env, dict(SMALL, n_workers=1, model="no_such_model"), seeds=(),
                              epochs=())
    have = ", ".join(repr(m) for m in sorted(["detection_unet", "mrcnn", "retina_net", "retina_unet", "ufrcnn"]))
    with pytest.raises(KeyError, match=f"unknown model 'no_such_model', the PyTorch package has \\[{have}\\]"):
        run_lidc_train(cf, mode, device="cpu")


@pytest.mark.parametrize("mode", ["train", "train_test"])
def test_training_without_card_raises(mode, tmp_path, monkeypatch):
    """Without a card and without ``device="cpu"``, exec's train modes raise
    instead of running on the CPU."""
    from medicaldetectiontoolkit_torch import exec as port_exec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_exec.main(["--mode", mode, "--exp_dir", str(tmp_path / "exp")])
