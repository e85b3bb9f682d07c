"""The port's LIDC experiment against the JAX package's, on the CPU: the
configs attribute by attribute, the synthetic generator array by array, and
the test loader (``PatientBatchIterator``) batch by batch on a set the JAX
generator wrote, patient order included. All exact."""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.lidc_exp import configs as jax_lidc_configs  # noqa: E402
from experiments.lidc_exp import data_loader as jax_dl  # noqa: E402
from experiments.lidc_exp.preprocessing import generate_synthetic_lidc as jax_generate  # noqa: E402
from medicaldetectiontoolkit_tpu.data import dataloader_utils as jax_dutils  # noqa: E402
from medicaldetectiontoolkit_tpu import config as jax_config  # noqa: E402
from medicaldetectiontoolkit_tpu.data.dataloader_utils import fold_generator as jax_fold_generator  # noqa: E402
from medicaldetectiontoolkit_torch import config as port_config  # noqa: E402
from medicaldetectiontoolkit_torch.data import dataloader_utils as port_dutils  # noqa: E402
from medicaldetectiontoolkit_torch.data.dataloader_utils import fold_generator  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import pack_dataset as port_pack  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import configs as port_lidc_configs  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as port_dl  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc  # noqa: E402
from medicaldetectiontoolkit_torch.testing import assert_same  # noqa: E402

# attributes that name each package's own files
PATH_ATTRS = {"source_dir", "model_path", "backbone_path"}
ENV_KEYS = ("MDT_DIM", "MDT_MODEL", "MDT_LIDC_PATCH", "MDT_LIDC_BS", "MDT_LIDC_DTYPE", "MDT_LIDC_PP",
            "MDT_LIDC_ROOT", "MDT_LIDC_EPOCHS", "MDT_LIDC_NTB", "MDT_LIDC_NVB", "MDT_DP", "MDT_SP",
            "MDT_GRAD_ACCUM", "MDT_STAGE_MODE")


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _config_vars(cf):
    return {k: v for k, v in vars(cf).items() if k not in PATH_ATTRS}


@pytest.mark.parametrize("model", ["retina_net", "retina_unet", "mrcnn", "ufrcnn", "detection_unet"])
@pytest.mark.parametrize("dim", [2, 3])
def test_lidc_configs_match_jax(clean_env, dim, model):
    clean_env.setenv("MDT_DIM", str(dim))
    clean_env.setenv("MDT_MODEL", model)
    jcf, tcf = jax_lidc_configs.configs(), port_lidc_configs.configs()
    assert_same(_config_vars(tcf), _config_vars(jcf))
    assert tcf.model_path.startswith("medicaldetectiontoolkit_torch/")


@pytest.mark.parametrize("env", [
    {"MDT_DIM": "3", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "3", "MDT_LIDC_DTYPE": "bfloat16"},
    {"MDT_DIM": "2", "MDT_LIDC_PATCH": "64,64", "MDT_DP": "2", "MDT_SP": "1", "MDT_GRAD_ACCUM": "2",
     "MDT_STAGE_MODE": "loop", "MDT_LIDC_PP": "/data/pp", "MDT_LIDC_EPOCHS": "3"},
])
def test_lidc_config_env_overrides_match_jax(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert_same(_config_vars(port_lidc_configs.configs()), _config_vars(jax_lidc_configs.configs()))


@pytest.mark.parametrize("model,dim", [("retina_unet", 3), ("mrcnn", 2)])
def test_default_configs_match_jax(clean_env, model, dim):
    assert_same(_config_vars(port_config.DefaultConfigs(model, None, dim)),
                _config_vars(jax_config.DefaultConfigs(model, None, dim)))


@pytest.mark.parametrize("n,splits,seed", [(4, 4, 0), (11, 5, 0), (23, 5, 3)])
def test_fold_generator_matches_jax(n, splits, seed):
    assert_same(fold_generator(seed, splits, n).get_fold_names(), jax_fold_generator(seed, splits, n).get_fold_names())


def test_synthetic_generator_matches_jax(tmp_path):
    kw = dict(n_patients=3, shape=(16, 40, 36), seed=5)
    jax_generate(str(tmp_path / "jax"), **kw)
    metas = generate_synthetic_lidc(str(tmp_path / "port"), **kw)
    assert not os.path.exists(tmp_path / "port" / "info_df.pickle")
    jfiles = sorted(f for f in os.listdir(tmp_path / "jax") if f != "info_df.pickle")
    assert jfiles == sorted(os.listdir(tmp_path / "port"))
    for f in jfiles:
        if f.endswith(".npy"):
            assert_same(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f))
        else:
            with open(tmp_path / "port" / f, "rb") as a, open(tmp_path / "jax" / f, "rb") as b:
                assert_same(pickle.load(a), pickle.load(b))
    assert [m["pid"] for m in metas] == [f"synth_{i:03d}" for i in range(3)]


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    """Six patients written by the JAX generator (with its info_df.pickle)."""
    out = str(tmp_path_factory.mktemp("jax_lidc"))
    jax_generate(out, n_patients=6, shape=(16, 40, 44), seed=2)
    return out


def _loader_cf(tmp_path, data_dir, dim, patch, ctx=None, merge=True, hold_out=False):
    """The attributes the test loaders read, on a fresh exp dir with the
    split of a 3-fold CV."""
    from types import SimpleNamespace

    cf = SimpleNamespace(
        dim=dim, patch_size=list(patch), n_3D_context=ctx, merge_2D_to_3D_preds=merge and dim == 2,
        class_specific_seg_flag=False, pp_data_path=data_dir, pp_test_data_path=data_dir,
        input_df_name="info_df.pickle", select_prototype_subset=None, hold_out_test_set=hold_out,
        exp_dir=str(tmp_path), fold=1, max_test_patients="all", server_env=False, data_dest=None, seed=0,
    )
    with open(tmp_path / "fold_ids.pickle", "wb") as handle:
        pickle.dump(fold_generator(0, 3, 6).get_fold_names(), handle)
    return cf


@pytest.mark.parametrize("case", [
    dict(dim=3, patch=(32, 32, 8)),                      # patched 3D
    dict(dim=3, patch=(64, 64, 16)),                     # whole patient, padded to patch size
    dict(dim=2, patch=(32, 32), ctx=1),                  # 2D, 3D context in channels, merged eval GT
    dict(dim=2, patch=(64, 64), ctx=None, merge=False),  # 2D slices of a padded patient
    dict(dim=3, patch=(32, 32, 8), hold_out=True),       # every patient of the test dir
])
def test_patient_iterator_matches_jax(jax_set, tmp_path, case):
    cf = _loader_cf(tmp_path, jax_set, **case)
    jgen, tgen = jax_dl.get_test_generator(cf, _Log()), port_dl.get_test_generator(cf, _Log())
    assert tgen["n_test"] == jgen["n_test"] == (6 if case.get("hold_out") else 2)
    # patient order: info_df's row order (the directory listing at aggregation time)
    assert tgen["test"].dataset_pids == jgen["test"].dataset_pids
    for _ in range(jgen["n_test"] + 1):  # once more: the iterator wraps around
        assert_same(next(tgen["test"]), next(jgen["test"]))


def test_load_dataset_order_is_info_df_order(jax_set, tmp_path):
    cf = _loader_cf(tmp_path, jax_set, dim=3, patch=(32, 32, 8))
    data = port_dl.load_dataset(cf, _Log())
    assert list(data) == pd.read_pickle(os.path.join(jax_set, "info_df.pickle")).pid.tolist()
    assert_same(dict(data), dict(jax_dl.load_dataset(cf, _Log())))


def test_load_dataset_stages_to_data_dest(jax_set, tmp_path):
    """--server_env with --data_dest: the patients' files are copied there
    once and read from there, in the same order."""
    cf = _loader_cf(tmp_path, jax_set, dim=3, patch=(32, 32, 8))
    cf.server_env, cf.data_dest, cf.pp_name = True, str(tmp_path / "dest"), "lidc_mdt"
    data = port_dl.load_dataset(cf, _Log())
    target = os.path.join(cf.data_dest, cf.pp_name)
    assert sorted(os.listdir(target)) == sorted(f for f in os.listdir(jax_set) if f != "info_df.pickle")
    assert all(os.path.dirname(v["data"]) == target for v in data.values())
    for pid, v in data.items():
        assert_same(np.load(v["seg"]), np.load(os.path.join(jax_set, f"{pid}_rois.npy")))
    assert [v["pid"] for v in data.values()] == [v["pid"] for v in port_dl.load_dataset(cf, _Log()).values()]


@pytest.mark.parametrize("packer", ["port", "jax"])
def test_pack_dataset_round_trip(tmp_path, packer):
    """npy files packed by one package (the port through its CLI), their
    npy deleted, unpacked by the other: the same arrays; packing again
    keeps an existing npz."""
    rng = np.random.RandomState(4)
    arrays = {"p0_img": rng.randn(5, 7, 6).astype(np.float32), "p0_rois": (rng.rand(5, 7, 6) > 0.7).astype(np.uint8),
              "p1_img": rng.randn(3, 4, 8).astype(np.float32)}
    for name, a in arrays.items():
        np.save(tmp_path / f"{name}.npy", a)
    (tmp_path / "meta_info_p0.pickle").write_bytes(b"meta")
    if packer == "port":
        port_pack.main(["--mode", "pack", "--dir", str(tmp_path), "--threads", "2"])
        port_pack.main(["--mode", "clean_npy", "--dir", str(tmp_path)])
        jax_dutils.unpack_dataset(str(tmp_path), threads=2)
    else:
        jax_dutils.pack_dataset(str(tmp_path), threads=2)
        jax_dutils.delete_npy(str(tmp_path))
        port_pack.main(["--mode", "unpack", "--dir", str(tmp_path), "--threads", "2"])
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"{n}.npy" for n in arrays] + [f"{n}.npz" for n in arrays] + ["meta_info_p0.pickle"])
    for name, a in arrays.items():
        assert_same(np.load(tmp_path / f"{name}.npy"), a)
        with np.load(tmp_path / f"{name}.npz") as z:
            assert list(z) == [name]
            assert_same(z[name], a)
    stamp = os.path.getmtime(tmp_path / "p0_img.npz")
    port_dutils.pack_dataset(str(tmp_path), threads=2)
    assert os.path.getmtime(tmp_path / "p0_img.npz") == stamp
