"""The port's ``Predictor`` against the JAX package's ``Predictor``, bit for
bit, when both drive the same port detector on the CPU.

Both predictors get the same batches (from the port's LIDC loader on a
synthetic set), load the same two checkpoints (written by the port's
``save_checkpoint``) and drive one ``RetinaUNetDetector`` on the CPU; every
box dict, seg map, monitor value and pickle must be identical. WBC and
``nms_2to3D`` run their NumPy loops on both sides (``MDT_NO_NATIVE=1`` for
the port, JAX's ``native.get_lib`` patched to None), and, in the tests that
ask for ``native_consolidation``, both packages' native C++ copies, built
here from the same code with the same flags (the native copy agrees with the
NumPy loop only to 1e-9, ``tests/test_torch_native.py``). Also: WBC,
``nms_2to3D`` and the mirrored patch crops alone on random inputs."""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu import native  # noqa: E402
from medicaldetectiontoolkit_tpu import predictor as jpred  # noqa: E402
from medicaldetectiontoolkit_torch import predictor as tpred  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as port_dl  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402
from medicaldetectiontoolkit_torch.testing import assert_same, make_lidc_experiment  # noqa: E402

torch.set_num_threads(2)

SMALL = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4}
SETTINGS = {
    "3d": ({"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "4"}, {}),
    "2d": ({"MDT_DIM": "2", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "32,32", "MDT_LIDC_BS": "6"},
           {"n_3D_context": 1, "n_channels": 3}),
}


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


@pytest.fixture(autouse=True)
def numpy_consolidation(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setenv("MDT_NO_NATIVE", "1")


@pytest.fixture
def native_consolidation(monkeypatch):
    """Both packages' native libraries (undoing ``numpy_consolidation``)."""
    from medicaldetectiontoolkit_torch import native as port_native

    monkeypatch.undo()
    assert native.get_lib() is not None and port_native.get_lib() is not None
    port_native.reset_calls()
    yield port_native
    assert port_native.calls()["wbc_greedy"] > 0


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def experiment(request, tmp_path_factory):
    """(config, detector): a synthetic LIDC experiment with two ranked
    checkpoints, and the port detector both predictors drive."""
    env, overrides = SETTINGS[request.param]
    root = str(tmp_path_factory.mktemp(f"pred_{request.param}"))
    cf = make_lidc_experiment(root, env, dict(SMALL, **overrides))
    cf.fold, cf.fold_dir = 0, os.path.join(cf.exp_dir, "fold_0")
    return cf, build_model(cf, _Log(), device="cpu")


def _fresh_fold_dir(cf, name):
    """A copy of fold 0 (checkpoints, ranking) for one predictor's pickles."""
    fold_dir = os.path.join(cf.exp_dir, name)
    shutil.rmtree(fold_dir, ignore_errors=True)
    shutil.copytree(os.path.join(cf.exp_dir, "fold_0"), fold_dir)
    return fold_dir


def _predict_test_set(module, cf, net, name):
    cf.fold_dir = _fresh_fold_dir(cf, name)
    batch_gen = port_dl.get_test_generator(cf, _Log())
    results = module.Predictor(cf, net, _Log(), mode="test").predict_test_set(batch_gen, return_results=True)
    with open(os.path.join(cf.fold_dir, "raw_pred_boxes_list.pickle"), "rb") as handle:
        raw = pickle.load(handle)
    return results, raw


def test_test_mode_matches_jax(experiment):
    """Mirror TTA, two ranks, patched patients, WBC (and the 2D->3D merge)."""
    cf, net = experiment
    jres, jraw = _predict_test_set(jpred, cf, net, "jax")
    tres, traw = _predict_test_set(tpred, cf, net, "port")
    assert_same(traw, jraw)
    assert_same(tres, jres)
    assert sum(b["box_type"] == "det" for r in tres for bl in r[0] for b in bl) > 0
    # raw boxes: 2 ranks x 4 mirror variants, each with its own patch ids
    ids = {b["patch_id"].split("_")[0] + "_" + b["patch_id"].split("_")[1]
           for r in traw for bl in r[0] for b in bl if b["box_type"] == "det"}
    assert ids == {f"{r}_{a}" for r in range(2) for a in range(4)}


def test_test_mode_with_native_consolidation_matches_jax(experiment, native_consolidation):
    """The same as ``test_test_mode_matches_jax``, with WBC and the 2D->3D
    merge in both packages' native libraries."""
    cf, net = experiment
    jres, jraw = _predict_test_set(jpred, cf, net, "jax")
    tres, traw = _predict_test_set(tpred, cf, net, "port")
    assert_same(traw, jraw)
    assert_same(tres, jres)
    assert sum(b["box_type"] == "det" for r in tres for bl in r[0] for b in bl) > 0
    if cf.dim == 2:
        assert native_consolidation.calls()["nms_2to3d"] > 0


def test_predict_patient_matches_jax(experiment):
    """One patient's merged variants: boxes and the stitched seg maps."""
    cf, net = experiment
    cf.fold_dir = os.path.join(cf.exp_dir, "fold_0")
    out = {}
    for module in (jpred, tpred):
        batch = next(port_dl.get_test_generator(cf, _Log())["test"])
        assert "patch_crop_coords" in batch
        predictor = module.Predictor(cf, net, _Log(), mode="test")
        net.load_params(module.load_checkpoint_state(os.path.join(cf.fold_dir, "3_best_checkpoint"))["params"])
        out[module] = predictor.predict_patient(batch)
    assert out[tpred]["seg_preds"].shape[1] == 4  # the identity and three mirrors
    assert_same(out[tpred], out[jpred])


def test_val_mode_matches_jax(experiment):
    """val: train_forward(is_validation=True) per chunk, GT added, WBC and
    merge per patient, monitor values averaged over chunks."""
    cf, net = experiment
    out = {}
    for module in (jpred, tpred):
        batch = next(port_dl.get_test_generator(cf, _Log())["test"])
        net.generator.manual_seed(7)  # the same matching and SHEM draws
        out[module] = module.Predictor(cf, net, _Log(), mode="val").predict_patient(batch)
    assert set(out[tpred]) == {"boxes", "seg_preds", "monitor_values"}
    assert_same(out[tpred], out[jpred])


def test_analysis_mode_matches_jax(experiment):
    """load_saved_predictions from the raw pickles: a fold's, and the
    hold-out set's over two folds."""
    cf, net = experiment
    cf.fold_dir = _fresh_fold_dir(cf, "fold_0_analysis")
    batch_gen = port_dl.get_test_generator(cf, _Log())
    tpred.Predictor(cf, net, _Log(), mode="test").predict_test_set(batch_gen, return_results=False)
    with open(os.path.join(cf.fold_dir, "raw_pred_boxes_list.pickle"), "rb") as handle:
        raw = pickle.load(handle)
    cf.hold_out_test_set = False
    fold = [m.Predictor(cf, None, _Log(), mode="analysis").load_saved_predictions(apply_wbc=True)
            for m in (jpred, tpred)]
    assert_same(fold[1], fold[0])

    # hold-out: every fold's raw list of the same patients, det boxes pooled
    cf.hold_out_test_set, cf.folds = True, [5, 6]
    for fold in cf.folds:
        os.makedirs(os.path.join(cf.exp_dir, f"fold_{fold}"), exist_ok=True)
        with open(os.path.join(cf.exp_dir, f"fold_{fold}", "raw_pred_boxes_hold_out_list.pickle"), "wb") as h:
            pickle.dump(raw, h)
    try:
        held = [m.Predictor(cf, None, _Log(), mode="analysis").load_saved_predictions(apply_wbc=True)
                for m in (jpred, tpred)]
    finally:
        cf.hold_out_test_set = False
    assert_same(held[1], held[0])
    assert sum(len(bl) for r in held[1] for bl in r[0]) > 0


def _random_dets(rng, n, dim):
    lo = rng.uniform(0, 200, (n, dim))
    hi = lo + rng.uniform(4, 50, (n, dim))
    cols = [lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]] + ([lo[:, 2], hi[:, 2]] if dim == 3 else [])
    return np.stack(cols, 1)


@pytest.mark.parametrize("dim,n,thresh,n_ens", [(2, 40, 1e-5, 4), (3, 300, 1e-5, 8), (3, 120, 0.3, 2),
                                               (2, 15, 0.5, 1)])
def test_weighted_box_clustering_matches_jax(dim, n, thresh, n_ens):
    rng = np.random.RandomState(n)
    coords = _random_dets(rng, n, dim)
    scores = np.round(rng.uniform(0.05, 1, n), 2)  # ties in the greedy order
    dets = np.concatenate([coords, scores[:, None], rng.uniform(0.3, 1, (n, 1)), rng.randint(1, 4, (n, 1))], 1)
    ids = np.array([f"0_{rng.randint(4)}_{rng.randint(9)}" for _ in range(n)])
    assert_same(list(tpred.weighted_box_clustering(dets, ids, thresh, n_ens)),
                list(jpred.weighted_box_clustering(dets, ids, thresh, n_ens)))


@pytest.mark.parametrize("n,thresh", [(60, 0.1), (300, 1e-5), (17, 0.5)])
def test_nms_2to3d_matches_jax(n, thresh):
    rng = np.random.RandomState(n)
    dets = np.concatenate([_random_dets(rng, n, 2), np.round(rng.uniform(0.05, 1, (n, 1)), 2),
                           rng.randint(0, 12, (n, 1)).astype(float)], 1)
    assert_same(list(tpred.nms_2to3D(dets, thresh)), list(jpred.nms_2to3D(dets, thresh)))


def test_mirrored_patch_crops_match_jax():
    crops = [[0, 32, 8, 40, 0, 8], [16, 48, 0, 32, 4, 12]]
    assert_same(tpred.get_mirrored_patch_crops(crops, (1, 1, 48, 40, 16)),
                jpred.get_mirrored_patch_crops(crops, (1, 1, 48, 40, 16)))
