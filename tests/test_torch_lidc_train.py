"""The port's LIDC training generators against the JAX package's, on the CPU.

On six patients written by the JAX generator (with its ``info_df.pickle``),
``get_train_generators`` of both packages, each on an exp dir of its own,
write the same ``fold_ids.pickle`` and give the same batches: the train
pipeline (class-balanced or uniform patients, fg-biased slices in 2D with and
without ``n_3D_context``, fg-anchored pre-crops that crop or pad, mirror,
spatial augmentation, boxes) and the ``val_sampling`` pipeline (center crop,
boxes), key for key (``data``, ``seg``, ``bb_target``, ``roi_labels``,
``pid``, ``class_target``), with one loader worker on each side (with more,
the order between workers is the thread scheduler's) and the native host
library on both sides. The ``val_patient`` iterator and the hold-out split
too. All exact.
"""

import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("pandas")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.lidc_exp import data_loader as jax_dl  # noqa: E402
from experiments.lidc_exp.preprocessing import generate_synthetic_lidc as jax_generate  # noqa: E402
from medicaldetectiontoolkit_tpu.data import dataloader_utils as jax_dutils  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as port_dl  # noqa: E402
from medicaldetectiontoolkit_torch.testing import assert_same  # noqa: E402

BATCH_KEYS = ("data", "seg", "bb_target", "roi_labels", "pid", "class_target")


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


@pytest.fixture(scope="module")
def jax_set(tmp_path_factory):
    """Six patients of z 20 x y 44 x x 50, written by the JAX generator."""
    out = str(tmp_path_factory.mktemp("jax_lidc_train"))
    jax_generate(out, n_patients=6, shape=(20, 44, 50), seed=3)
    return out


def _da(dim):
    """The LIDC configs' augmentation (experiments/lidc_exp/configs.py)."""
    da = {
        "do_elastic_deform": True, "alpha": (0.0, 1500.0), "sigma": (30.0, 50.0), "do_rotation": True,
        "angle_x": (0.0, 2 * np.pi), "angle_y": (0.0, 0), "angle_z": (0.0, 0), "do_scale": True,
        "scale": (0.8, 1.1), "random_crop": False, "border_mode_data": "constant", "border_cval_data": 0,
        "order_data": 1,
    }
    if dim == 3:
        da.update(do_elastic_deform=False, angle_x=(0, 0.0), angle_y=(0, 0.0), angle_z=(0.0, 2 * np.pi))
    return da


def _cf(exp_dir, data_dir, dim, patch, pre_crop, ctx=None, head_classes=3, val_mode="val_sampling",
        hold_out=False):
    os.makedirs(exp_dir)
    return SimpleNamespace(
        dim=dim, patch_size=list(patch), pre_crop_size=list(pre_crop), n_3D_context=ctx, head_classes=head_classes,
        batch_sample_slack=0.2, batch_size=3, da_kwargs=_da(dim), class_specific_seg_flag=False, n_workers=1,
        seed=0, n_cv_splits=3, exp_dir=exp_dir, fold=1, created_fold_id_pickle=False, hold_out_test_set=hold_out,
        val_mode=val_mode, num_val_batches=2, max_val_patients=None, merge_2D_to_3D_preds=dim == 2,
        pp_data_path=data_dir, input_df_name="info_df.pickle", select_prototype_subset=None, server_env=False,
        data_dest=None,
    )


def _both(tmp_path, jax_set, **kw):
    cfs = {name: _cf(str(tmp_path / name), jax_set, **kw) for name in ("jax", "port")}
    return cfs, jax_dl.get_train_generators(cfs["jax"], _Log()), port_dl.get_train_generators(cfs["port"], _Log())


def _shutdown(*gens):
    for g in gens:
        for key in ("train", "val_sampling"):
            g[key].shutdown()


@pytest.mark.parametrize("case", [
    dict(dim=3, patch=(32, 32, 8), pre_crop=(40, 40, 12)),                    # crop in y, x, z
    dict(dim=3, patch=(32, 32, 16), pre_crop=(40, 56, 24), head_classes=2),   # pad x and z; uniform patients
    dict(dim=2, patch=(32, 32), pre_crop=(40, 40), ctx=1),                    # 3D context in channels
    dict(dim=2, patch=(32, 32), pre_crop=(44, 48), hold_out=True),            # test split trains too
])
def test_train_and_val_sampling_batches_match_jax(jax_set, tmp_path, case):
    cfs, jgen, tgen = _both(tmp_path, jax_set, **case)
    try:
        assert tgen["n_val"] == jgen["n_val"] == 2
        assert sorted(tgen) == sorted(jgen)
        with open(tmp_path / "jax" / "fold_ids.pickle", "rb") as a, open(tmp_path / "port" / "fold_ids.pickle",
                                                                         "rb") as b:
            assert_same(pickle.load(b), pickle.load(a))
        assert cfs["port"].created_fold_id_pickle and cfs["jax"].created_fold_id_pickle
        train_pids = set()
        for _ in range(3):
            tb, jb = next(tgen["train"]), next(jgen["train"])
            assert set(BATCH_KEYS) <= set(tb)
            assert_same(tb, jb)
            assert tb["data"].shape == (3, 3 if case.get("ctx") else 1, *case["patch"])
            train_pids.update(tb["pid"])
        for _ in range(2):
            tb, jb = next(tgen["val_sampling"]), next(jgen["val_sampling"])
            assert_same(tb, jb)
            assert tb["data"].shape[2:] == tuple(case["patch"])
    finally:
        _shutdown(jgen, tgen)
    assert train_pids and all(p.startswith("synth_") for p in train_pids)


def test_fold_split_is_written_once(jax_set, tmp_path):
    """A second fold reads the experiment's split instead of drawing one."""
    cf = _cf(str(tmp_path / "port"), jax_set, dim=3, patch=(32, 32, 8), pre_crop=(40, 40, 12))
    first = port_dl._fold_splits(cf, 6)
    with open(tmp_path / "port" / "fold_ids.pickle", "wb") as handle:
        pickle.dump(first[::-1], handle)
    assert_same(port_dl._fold_splits(cf, 6), first[::-1])


def test_val_patient_iterator_matches_jax(jax_set, tmp_path):
    cfs, jgen, tgen = _both(tmp_path, jax_set, dim=3, patch=(32, 32, 8), pre_crop=(40, 40, 12),
                            val_mode="val_patient")
    try:
        assert tgen["n_val"] == jgen["n_val"] == 2
        for _ in range(3):
            assert_same(next(tgen["val_patient"]), next(jgen["val_patient"]))
    finally:
        _shutdown(jgen, tgen)


def test_packed_data_set_is_unpacked_at_data_dest(jax_set, tmp_path):
    """A data set packed to ``.npz`` (the JAX package's ``pack_dataset``) is
    staged to ``cf.data_dest`` and unpacked there to the same arrays."""
    import shutil

    packed = tmp_path / "packed"
    shutil.copytree(jax_set, packed)
    jax_dutils.pack_dataset(str(packed))
    jax_dutils.delete_npy(str(packed))
    assert not any(f.endswith(".npy") for f in os.listdir(packed))
    cf = _cf(str(tmp_path / "exp"), str(packed), dim=3, patch=(32, 32, 8), pre_crop=(40, 40, 12))
    cf.server_env, cf.data_dest, cf.pp_name = True, str(tmp_path / "dest"), "lidc_mdt"
    data = port_dl.load_dataset(cf, _Log())
    assert list(data) == list(port_dl.load_dataset(_cf(str(tmp_path / "exp2"), jax_set, dim=3, patch=(32, 32, 8),
                                                       pre_crop=(40, 40, 12)), _Log()))
    for patient in data.values():
        assert os.path.dirname(patient["data"]) == os.path.join(cf.data_dest, cf.pp_name)
        for key in ("data", "seg"):
            assert_same(np.load(patient[key]), np.load(os.path.join(jax_set, os.path.basename(patient[key]))))
