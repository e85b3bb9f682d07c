"""The port's toy experiment against the JAX package's, on the CPU.

Exact throughout: the generators write the same images, segs and meta
files from the same seeds; each package's loader reads the other's data
directory (the port's ``info_df.pickle`` is a pandas ``DataFrame`` pickle
written without pandas; the port reads the meta files in ``os.listdir``
order, the index's row order); the configs have the same attributes and
values for every model; with one worker the train, val_sampling and
val_patient batches are equal array for array. Then ``exec --mode
train_test`` of Detection U-Net on a tiny toy set, and the convergence
tool's reading of its log.
"""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
pd = pytest.importorskip("pandas")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.toy_exp import configs as jconfigs  # noqa: E402
from experiments.toy_exp import data_loader as jdl  # noqa: E402
from experiments.toy_exp import generate_toys as jgen  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.toy_exp import configs as tconfigs  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.toy_exp import data_loader as tdl  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.toy_exp import generate_toys as tgen  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_toy_experiment, run_lidc_train  # noqa: E402
from medicaldetectiontoolkit_torch.tools import convergence  # noqa: E402

torch.set_num_threads(2)
N_TRAIN, N_TEST = 15, 3


class _Log:
    def info(self, *a, **k):
        pass


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One toy data set written by each package's generator."""
    out = {}
    for name, gen in (("jax", jgen), ("port", tgen)):
        root = str(tmp_path_factory.mktemp(name))
        gen.generate_experiment(root, "donuts_shape", N_TRAIN, N_TEST, "donuts_shape")
        out[name] = root
    return out


def _dir(root, split="train"):
    return os.path.join(root, "donuts_shape", split)


@pytest.mark.parametrize("split", ["train", "test"])
def test_generator_files_match_jax(roots, split):
    for six in range(N_TRAIN if split == "train" else N_TEST):
        a = np.load(os.path.join(_dir(roots["port"], split), f"{six}.npy"))
        b = np.load(os.path.join(_dir(roots["jax"], split), f"{six}.npy"))
        assert a.dtype == b.dtype and np.array_equal(a, b)
        metas = []
        for name in ("port", "jax"):
            with open(os.path.join(_dir(roots[name], split), f"meta_info_{six}.pickle"), "rb") as handle:
                metas.append(pickle.load(handle))
        assert metas[0][1:] == metas[1][1:] and os.path.basename(metas[0][0]) == os.path.basename(metas[1][0])
        assert metas[0][0] == os.path.join(_dir(roots["port"], split), f"{six}.npy")
    # the index: a DataFrame for pandas, its rows in each directory's listdir order of the meta files
    for name in ("port", "jax"):
        df = pd.read_pickle(os.path.join(_dir(roots[name], split), "info_df.pickle"))
        assert list(df.columns) == tgen.INDEX_COLUMNS
        assert df.values.tolist() == tgen.read_meta_info(_dir(roots[name], split))


def _cf(module, root, model="retina_unet", **env):
    env = dict({"MDT_TOY_ROOT": root, "MDT_MODEL": model, "MDT_TOY_NTRAINVAL": str(N_TRAIN)}, **env)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cf = module.configs()
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    cf.n_workers = 1
    return cf


@pytest.mark.parametrize("model", ["retina_net", "retina_unet", "mrcnn", "ufrcnn", "detection_unet"])
def test_configs_match_jax(roots, model):
    tcf, jcf = _cf(tconfigs, roots["port"], model), _cf(jconfigs, roots["port"], model)
    skip = {"source_dir", "model_path", "backbone_path"}  # the package's own files
    for name, value in vars(jcf).items():
        if name in skip:
            continue
        got = getattr(tcf, name)
        if isinstance(value, np.ndarray):
            assert np.array_equal(got, value) and got.dtype == value.dtype, name
        else:
            assert got == value and type(got) is type(value), name
    assert set(vars(tcf)) == set(vars(jcf))


@pytest.mark.parametrize("data", ["port", "jax"])
def test_each_loader_reads_either_directory(roots, data):
    tcf, jcf = _cf(tconfigs, roots[data]), _cf(jconfigs, roots[data])
    for split in ("train", "test"):
        path = _dir(roots[data], split)
        t = tdl.load_dataset(tcf, _Log(), pp_data_path=path)
        j = jdl.load_dataset(jcf, _Log(), pp_data_path=path)
        assert list(t.items()) == list(j.items())
    t = tdl.load_dataset(tcf, _Log(), subset_ixs=[0, 3, 4])
    j = jdl.load_dataset(jcf, _Log(), subset_ixs=[0, 3, 4])
    assert list(t.items()) == list(j.items()) and len(t) == 3


def _same_batch(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y), k
        elif isinstance(y, list):
            assert len(x) == len(y), k
            for u, v in zip(x, y):
                assert np.array_equal(np.asarray(u), np.asarray(v)), k
        else:
            assert x == y, k


@pytest.mark.parametrize("patch", ["320,320", "128,128"])
def test_batches_match_jax(roots, patch):
    """With one worker (seed 0): the first train and val_sampling batches,
    and every val_patient and test batch (tiled at a patch below 320)."""
    tcf = _cf(tconfigs, roots["port"], MDT_TOY_PATCH=patch, MDT_TOY_BS="4")
    jcf = _cf(jconfigs, roots["port"], MDT_TOY_PATCH=patch, MDT_TOY_BS="4")
    tg, jg = tdl.get_train_generators(tcf, _Log()), jdl.get_train_generators(jcf, _Log())
    try:
        assert tg["n_val"] == jg["n_val"]
        for key in ("train", "val_sampling"):
            for _ in range(2):
                _same_batch(next(tg[key]), next(jg[key]))
        for _ in range(tg["n_val"]):
            _same_batch(next(tg["val_patient"]), next(jg["val_patient"]))
    finally:
        for g in (tg, jg):
            for key in ("train", "val_sampling"):
                g[key].shutdown()
    tt, jt = tdl.get_test_generator(tcf, _Log()), jdl.get_test_generator(jcf, _Log())
    assert tt["n_test"] == jt["n_test"] == N_TEST
    for _ in range(N_TEST):
        _same_batch(next(tt["test"]), next(jt["test"]))


def test_exec_train_test_detection_unet_on_toys(roots, tmp_path):
    """``exec --mode train_test`` of the toy experiment's Detection U-Net on
    the CPU (small widths, 64x64 patches of the 320x320 images): checkpoints
    and results; the convergence tool reads one val line per epoch and the
    test AP."""
    env = {"MDT_MODEL": "detection_unet", "MDT_TOY_NTRAINVAL": str(N_TRAIN), "MDT_TOY_PATCH": "64,64",
           "MDT_TOY_EPOCHS": "2", "MDT_TOY_NTB": "1", "MDT_TOY_BS": "2", "MDT_TOY_MAXVAL": "1", "MDT_TOY_MAXTEST": "1"}
    cf = make_toy_experiment(roots["port"], env, {"start_filts": 4, "end_filts": 8, "n_workers": 1,
                                                  "plot_prediction_histograms": False}, exp_name=str(tmp_path / "exp"))
    out = run_lidc_train(cf, "train_test", device="cpu", exp="toy_exp")
    assert {"1_best_checkpoint", "2_best_checkpoint", "last_checkpoint"} <= set(os.listdir(os.path.join(cf.exp_dir, "fold_0")))
    assert len(out["test"]["results"]) == 1
    val, test_ap = convergence.read_aps(cf.exp_dir)
    assert [v["epoch"] for v in val] == [1, 2]
    assert set(val[0]) == {"epoch", "benign_ap", "malignant_ap", "patient_ap", "patient_auc"}
    assert test_ap is not None and 0.0 <= test_ap <= 1.0
