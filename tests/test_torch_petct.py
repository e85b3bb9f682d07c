"""The port's PET-CT experiment against the JAX package's, on the CPU.

Exact throughout, except the train step:
  * the configs have the same attributes and values for every model and
    under the ``MDT_PETCT_*`` knobs;
  * the generators write byte-equal volumes, segs and meta files from the
    same seed; each package's loader reads the other's data directory (the
    port's ``info_df.pickle`` is a pandas ``DataFrame`` pickle written
    without pandas; the port reads the meta files in ``os.listdir`` order,
    the index's row order), giving the same patients and fold split;
  * ``get_z_crops``, ``_clear_border`` and ``collect_paths`` agree on
    synthetic CT volumes and directory trees;
  * with one loader worker, two train batches (mirror, rotation about z over
    2 pi and scale 0.8-1.1 on two channels, boxes), a ``val_sampling`` batch
    and every test patient's patch batch are equal array for array, with the
    native host library on both sides and with it off on both sides (and on
    odd volume shapes, where PET-CT's pre-crop fallback range differs from
    LIDC's);
  * one Retina U-Net train step at two input channels (2 microbatches,
    remat, ``MDT_STEM_PALLAS=1``: the stem kernels' plain versions in the
    port, the Pallas kernels in interpret mode in JAX) from the same weights
    and draws: loss and monitor values within 1e-5 relative, gradients and
    Adam moments within 1e-4 of each tensor's max, as in
    ``tests/test_torch_train.py``'s first step, except the stem's and the
    first stage's, held to 5e-3 as that file holds them on its resumed step
    (measured: 1.3e-3 in the first stage's second block, whose gradient is a
    sum over every position that cancels to a small part of its terms; the
    same with the port's cuDNN stem, so not the stem path's; 6.8e-5 in the
    stem);
  * ``exec --mode train_test`` with no validation: the ranked checkpoints
    are those JAX's ``ModelSelector`` ranks from the same train metrics, the
    hold-out test writes ``results.txt`` and the figures, ``--mode test``
    gives the same results again and ``--mode analysis`` ensembles the fold
    into ``results_hold_out.csv``.
"""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pd = pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments.pet_ct_tnm_classification import configs as jconfigs  # noqa: E402
from experiments.pet_ct_tnm_classification import data_loader as jdl  # noqa: E402
from experiments.pet_ct_tnm_classification import preprocessing as jpp  # noqa: E402
from medicaldetectiontoolkit_tpu import native as jnative  # noqa: E402
from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.utils import exp_utils as jexp_utils  # noqa: E402
from medicaldetectiontoolkit_torch import exec as port_exec  # noqa: E402
from medicaldetectiontoolkit_torch import native  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import configs as tconfigs  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import data_loader as tdl  # noqa: E402
from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import preprocessing as tpp  # noqa: E402
from medicaldetectiontoolkit_torch.models import base as tbase  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.testing import (  # noqa: E402
    assert_same, make_batch, make_config, make_petct_experiment, run_lidc_test, run_lidc_train,
)
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402
from test_torch_train import LR, check_step, jax_draws  # noqa: E402

torch.set_num_threads(2)
PATH_ATTRS = {"source_dir", "model_path", "backbone_path"}
ENV_KEYS = ("MDT_MODEL", "MDT_PETCT_ROOT", "MDT_PETCT_PP", "MDT_PETCT_PATCH", "MDT_PETCT_EPOCHS", "MDT_PETCT_NTB",
            "MDT_PETCT_BS", "MDT_DP", "MDT_SP", "MDT_GRAD_ACCUM", "MDT_STAGE_MODE", "MDT_STEM_PALLAS")
SHAPES = {"even": (12, 48, 48), "odd": (13, 47, 49)}  # z, y, x
BATCH_KEYS = ("data", "seg", "bb_target", "roi_labels", "pid", "class_target")


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def data_sets(tmp_path_factory):
    """Four patients of each shape, written by each package's generator."""
    out = {}
    for shape_name, shape in SHAPES.items():
        for name, gen in (("jax", jpp), ("port", tpp)):
            path = str(tmp_path_factory.mktemp(f"{name}_{shape_name}"))
            gen.generate_synthetic_petct(path, n_patients=4, shape=shape, seed=3)
            out[name, shape_name] = path
    return out


@pytest.fixture(params=["native", "no_native"])
def native_mode(request, monkeypatch):
    if request.param == "no_native":
        monkeypatch.setenv("MDT_NO_NATIVE", "1")
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None and jnative.get_lib() is not None
    return request.param


def _config_vars(cf):
    return {k: v for k, v in vars(cf).items() if k not in PATH_ATTRS}


@pytest.mark.parametrize("model,env", [
    ("retina_unet", {}), ("retina_net", {}), ("mrcnn", {}), ("ufrcnn", {}), ("detection_unet", {}),
    ("retina_unet", {"MDT_PETCT_ROOT": "/data/petct", "MDT_PETCT_PATCH": "64,64,16", "MDT_PETCT_EPOCHS": "7",
                     "MDT_PETCT_NTB": "3", "MDT_PETCT_BS": "2", "MDT_GRAD_ACCUM": "2"}),
    ("mrcnn", {"MDT_PETCT_PP": "/data/pp", "MDT_PETCT_PATCH": "32,32,8", "MDT_PETCT_EPOCHS": "5"}),
])
def test_configs_match_jax(clean_env, model, env):
    clean_env.setenv("MDT_MODEL", model)
    for k, v in env.items():
        clean_env.setenv(k, v)
    tcf, jcf = tconfigs.configs(), jconfigs.configs()
    assert_same(_config_vars(tcf), _config_vars(jcf))
    assert tcf.n_channels == 2 and tcf.model == model
    assert tcf.model_path.startswith("medicaldetectiontoolkit_torch/")


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_generator_files_match_jax(data_sets, shape_name):
    port, jax_dir = data_sets["port", shape_name], data_sets["jax", shape_name]
    files = sorted(os.listdir(port))
    assert files == sorted(os.listdir(jax_dir)) and len(files) == 13
    for f in files:
        if f != "info_df.pickle":
            with open(os.path.join(port, f), "rb") as a, open(os.path.join(jax_dir, f), "rb") as b:
                assert a.read() == b.read(), f
    # the index: a DataFrame for pandas, its rows in each directory's listdir order of the meta files
    for path in (port, jax_dir):
        df = pd.read_pickle(os.path.join(path, "info_df.pickle"))
        assert list(df.columns) == tpp.INDEX_COLUMNS
        rows = [[m["pid"], m["raw_pid"], m["class_target"], m["fg_slices"]] for m in tpp.read_meta_info(path)]
        assert df.values.tolist() == rows


def _cf(module, data_dir, exp_dir, model="retina_unet", **env):
    env = dict({"MDT_PETCT_PP": data_dir, "MDT_MODEL": model, "MDT_PETCT_PATCH": "32,32,8", "MDT_PETCT_BS": "3"},
               **env)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cf = module.configs()
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    os.makedirs(exp_dir, exist_ok=True)
    cf.exp_dir, cf.fold, cf.n_cv_splits, cf.n_workers, cf.created_fold_id_pickle = exp_dir, 0, 4, 1, False
    return cf


@pytest.mark.parametrize("data", ["port", "jax"])
def test_each_loader_reads_either_directory(data_sets, tmp_path, data):
    """The same patients in the same order (the index's), the same
    prototype subset and fold subsets, and the same fold split."""
    path = data_sets[data, "even"]
    tcf, jcf = _cf(tconfigs, path, str(tmp_path / "t")), _cf(jconfigs, path, str(tmp_path / "j"))
    t, j = tdl.load_dataset(tcf, _Log()), jdl.load_dataset(jcf, _Log())
    assert list(t.items()) == list(j.items())
    assert list(t) == pd.read_pickle(os.path.join(path, "info_df.pickle")).pid.tolist()
    assert list(tdl.load_dataset(tcf, _Log(), subset_ixs=[0, 3]).items()) == \
        list(jdl.load_dataset(jcf, _Log(), subset_ixs=[0, 3]).items())
    tcf.select_prototype_subset = jcf.select_prototype_subset = 2
    assert list(tdl.load_dataset(tcf, _Log()).items()) == list(jdl.load_dataset(jcf, _Log()).items())
    tcf.select_prototype_subset = jcf.select_prototype_subset = None
    gens = [tdl.get_train_generators(tcf, _Log()), jdl.get_train_generators(jcf, _Log())]
    for g in gens:
        for key in ("train", "val_sampling"):
            g[key].shutdown()
    assert gens[0]["n_val"] == gens[1]["n_val"]
    folds = []
    for cf in (tcf, jcf):
        with open(os.path.join(cf.exp_dir, "fold_ids.pickle"), "rb") as handle:
            folds.append(pickle.load(handle))
    assert_same(folds[0], folds[1])


def _same_batch(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(y, list):
            assert isinstance(x, list) and len(x) == len(y), k
            for u, v in zip(x, y):
                assert_same(np.asarray(u), np.asarray(v), k)
        else:
            assert_same(x, y, k)


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_batches_match_jax(data_sets, tmp_path, native_mode, shape_name, monkeypatch):
    """With one worker (seed 0) and the config's augmentation (rotation
    about z over 2 pi, scale 0.8-1.1), pre-crops of 40x40x10 (44x44x10 on
    the odd shapes) that crop every axis: two train batches and a
    val_sampling batch; then every test patient's batch (its patch grid of
    32x32x8)."""
    path = data_sets["port", shape_name]
    tcf, jcf = _cf(tconfigs, path, str(tmp_path / "t")), _cf(jconfigs, path, str(tmp_path / "j"))
    assert tcf.da_kwargs["do_rotation"] and tcf.da_kwargs["do_scale"] and tcf.da_kwargs["angle_z"][1] == 2 * np.pi
    for cf in (tcf, jcf):
        cf.pre_crop_size = [40, 40, 10] if shape_name == "even" else [44, 44, 10]
    fallbacks = []  # the pre-crop's fallback range (lesion at the edge), as PET-CT computes it
    real = tdl.BatchGenerator._fg_anchor_center

    def spy(self, data, seg, d, anchor, rng):
        half, reach = self.cf.pre_crop_size[d] // 2, self.cf.patch_size[d] // 2 - self.crop_margin[d]
        if max(half, anchor[d] - reach) >= min(data.shape[d + 1] - half, anchor[d] + reach):
            fallbacks.append(data.shape[d + 1] % 2)
        return real(self, data, seg, d, anchor, rng)

    monkeypatch.setattr(tdl.BatchGenerator, "_fg_anchor_center", spy)
    tg, jg = tdl.get_train_generators(tcf, _Log()), jdl.get_train_generators(jcf, _Log())
    try:
        for key, n in (("train", 2), ("val_sampling", 1)):
            for _ in range(n):
                t, j = next(tg[key]), next(jg[key])
                _same_batch({k: t[k] for k in BATCH_KEYS}, {k: j[k] for k in BATCH_KEYS})
                _same_batch(t, j)
                assert t["data"].shape == (3, 2, 32, 32, 8) and t["data"].dtype == np.float32
    finally:
        for g in (tg, jg):
            for key in ("train", "val_sampling"):
                g[key].shutdown()
    if shape_name == "odd":
        assert 1 in fallbacks  # the fallback on an odd axis was drawn
    tt, jt = tdl.get_test_generator(tcf, _Log()), jdl.get_test_generator(jcf, _Log())
    assert tt["n_test"] == jt["n_test"] == 4
    for _ in range(4):
        t, j = next(tt["test"]), next(jt["test"])
        _same_batch(t, j)
        assert t["data"].shape[1:] == (2, 32, 32, 8) and "patch_crop_coords" in t
    assert tt["test"].patient_ix == jt["test"].patient_ix == 0
    assert tt["test"].dataset_pids == jt["test"].dataset_pids


def _ct_volume(case):
    """Synthetic CT (z, y, x) in HU: air (-1000) lungs in soft tissue (40)
    with air outside the body (cleared as border components)."""
    rng = np.random.RandomState(len(case))
    n_z = {"two_lungs": 40, "one_lung": 30, "long": 170, "none": 12}[case]
    x = np.full((n_z, 96, 96), 40.0, np.float32) + rng.randn(n_z, 96, 96).astype(np.float32) * 20
    x[:, :6] = x[:, -6:] = -1000  # outside the body
    if case == "two_lungs":
        x[10:30, 30:66, 20:44] = -1000
        x[10:30, 30:66, 52:76] = -1000
    elif case == "one_lung":
        x[5:12, 30:66, 20:44] = -900
    elif case == "long":
        x[3:168, 30:66, 20:44] = -1000
        x[3:168, 30:66, 52:76] = -1000
        x[80:90, 40:50, 30:35] = 40  # holes move the components' centers on some slices
    return x


@pytest.mark.parametrize("case,kw", [("two_lungs", {}), ("two_lungs", {"min_pix": 200}), ("one_lung", {}),
                                     ("long", {}), ("none", {})])
def test_z_crops_match_jax(case, kw):
    x = _ct_volume(case)
    assert tpp.get_z_crops(x, 0, **kw) == jpp.get_z_crops(x, 0, **kw)
    for six in range(0, x.shape[0], 7):
        mask = x[six] < -600
        assert_same(tpp._clear_border(mask), jpp._clear_border(mask))


def test_collect_paths_matches_jax(tmp_path):
    for rel, files in (("TNM/p1", ["lsa_pet.nii.gz", "lsa_ct.nii.gz"]), ("TNM/p2", ["lsa_ct.nii.gz"]),
                       ("other/p3", ["lsa_pet.nii.gz"]), ("TNM/a/TNM_p4", ["x_lsa_pet"]), ("TNM/empty", [])):
        os.makedirs(tmp_path / rel)
        for f in files:
            (tmp_path / rel / f).write_bytes(b"")
    got = tpp.collect_paths(str(tmp_path))
    assert got == jpp.collect_paths(str(tmp_path)) and len(got) == 2


def _jax_step(cf):
    """One JAX train step with ``MDT_STEM_PALLAS=1`` from the port's seed-0
    weights: (batch, key, params, opt_state, step outputs)."""
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.initialize(seed=0)
    jnet = jbuild(cf, _Log())
    p0 = convert.torch_to_jax(tnet.module.state_dict(), tnet.module)
    batch, key = make_batch(cf, seed=7), jax.random.PRNGKey(11)
    params, opt_state = jax.device_put(p0), jnet._optimizer.init(jax.device_put(p0))
    before = jax.device_get((params, opt_state))
    out = jnet._train_step_fn(params, opt_state, key, jnp.float32(LR), *jnet._prep(batch))
    det = jnet._detect_fn(*out[3])
    return batch, key, before, jax.device_get((out[1], out[2], out[3], out[4], det, out[0]))


def test_train_step_at_two_channels_matches_jax(clean_env):
    """3D Retina U-Net at cin 2 (PET-CT's CT and PET), 2 microbatches of 2,
    remat, the stem conv conv0 through the stem path on both sides."""
    clean_env.setenv("MDT_STEM_PALLAS", "1")
    cf = make_config(model="retina_unet", dim=3, batch_size=4)
    cf.n_channels, cf.grad_accum_steps, cf.use_remat = 2, 2, True
    batch, key, (params, opt_state), jout = _jax_step(cf)
    assert batch["data"].shape == (4, 2, 64, 64, 8)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params, opt_state)
    tnet.current_lr = LR
    inputs = tnet._prep(batch)
    n_micro = tbase.resolve_grad_accum(cf, inputs[0].shape[0])
    _, aux = tnet._accumulate(inputs, jax_draws(key, tnet, n_micro, inputs[0].shape[0] // n_micro))
    grads = {n: p.grad.clone() for n, p in tnet.module.named_parameters()}
    tnet._update()
    stem = tnet.module.fpn.stem0[0]
    assert stem.stem_kernel and stem.conv.weight.shape[1] == 2 and not tnet.module.fpn.stem0[1].stem_kernel
    check_step(tnet, grads, aux, jout, first_step=True, loose=("fpn.stem0.", "fpn.stages.0."))


def test_exec_train_test_without_validation(tmp_path):
    """``exec --mode train_test`` of the PET-CT experiment at small width:
    no validation, so the ranking comes from the train metrics; the
    hold-out test of two patients with both ranked checkpoints; ``--mode
    test`` again; ``--mode analysis`` with fold ensembling."""
    env = {"MDT_MODEL": "retina_unet", "MDT_PETCT_PATCH": "32,32,8", "MDT_PETCT_EPOCHS": "2", "MDT_PETCT_NTB": "2",
           "MDT_PETCT_BS": "2"}
    overrides = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_workers": 1,
                 "n_cv_splits": 4, "max_test_patients": 2, "test_n_epochs": 2}
    cf = make_petct_experiment(str(tmp_path), env, overrides)
    assert not cf.do_validation and cf.hold_out_test_set and cf.ensemble_folds and cf.n_channels == 2
    out = run_lidc_train(cf, "train_test", device="cpu", exp="pet_ct_tnm_classification")
    fold_dir = os.path.join(cf.exp_dir, "fold_0")

    # JAX's ModelSelector on the same train metrics, epoch by epoch
    metrics = out["train"]["monitor_metrics"]
    assert all(len(ep) == 0 for ep in metrics["val"]["monitor_values"])
    assert [len(ep) for ep in metrics["train"]["monitor_values"]] == [0, 2, 2]
    jcf = _cf(jconfigs, cf.pp_data_path, str(tmp_path / "jax_exp"))
    jcf.fold_dir = os.path.join(jcf.exp_dir, "fold_0")
    os.makedirs(jcf.fold_dir)

    class _Net:
        params = {"w": np.zeros(1, np.float32)}

        def state_dict(self):
            return {"params": self.params}

    selector = jexp_utils.ModelSelector(jcf, _Log())
    for epoch in (1, 2):
        upto = {split: {k: (v[: epoch + 1] if k != "monitor_values" else v) for k, v in m.items()}
                for split, m in metrics.items()}
        selector.run_model_selection(_Net(), upto, epoch)
    ranking = np.load(os.path.join(fold_dir, "epoch_ranking.npy"))
    assert_same(ranking, np.load(os.path.join(jcf.fold_dir, "epoch_ranking.npy")))
    best = sorted(f for f in os.listdir(fold_dir) if f.endswith("best_checkpoint"))
    assert best == sorted(f for f in os.listdir(jcf.fold_dir) if f.endswith("best_checkpoint")) and len(best) == 2

    test = out["test"]
    assert len(test["results"]) == 2
    with open(os.path.join(cf.exp_dir, "results.txt")) as handle:
        assert "average_foreground_roi" in handle.read()
    plots = os.listdir(cf.plot_dir)
    assert {"pred_hist_0_train_rois_cl1.png", "pred_hist_0_test_patient_cl1.png"} <= set(plots), plots
    with open(os.path.join(fold_dir, "raw_pred_boxes_hold_out_list.pickle"), "rb") as handle:
        raw = pickle.load(handle)

    again = run_lidc_test(cf, device="cpu", exp="pet_ct_tnm_classification")
    assert_same(again["results"], test["results"])
    with open(os.path.join(fold_dir, "raw_pred_boxes_hold_out_list.pickle"), "rb") as handle:
        assert_same(pickle.load(handle), raw)

    source = os.path.join(REPO, "medicaldetectiontoolkit_torch", "experiments", "pet_ct_tnm_classification")
    port_exec.main(["--mode", "analysis", "--exp_source", source, "--exp_dir", cf.exp_dir, "--folds", "0"])
    with open(os.path.join(cf.exp_dir, "results_hold_out.csv")) as handle:
        lines = handle.read().splitlines()
    assert lines[0] == "patientID,predictionID,coords,score,pred_classID"
    assert {line.split(",")[0] for line in lines[1:]} <= {r[1] for r in test["results"]}


def test_convergence_tool_petct_dev(tmp_path):
    """``tools/convergence.py --exp petct --dev`` on the CPU at a small
    patch: its data, exec's dev settings (one epoch of 5 steps of 1, one
    test patient), the logged steps and the test AP."""
    from medicaldetectiontoolkit_torch.tools import convergence

    args = convergence.parse_args(["--exp", "petct", "--dev", "--patch", "32,32,8", "--n_patients", "4", "--shape",
                                   "12,48,48", "--root", str(tmp_path / "data"), "--exp_dir", str(tmp_path / "exp")])
    saved = dict(os.environ)
    try:
        out = convergence.run(args, device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert sorted(os.listdir(tmp_path / "data" / "pp_norm"))[:2] == ["info_df.pickle", "meta_info_petct_000.pickle"]
    assert out["val"] == [] and len(out["step_ms"]) == 5 and out["dev"]
    assert out["test_mean_fg_roi_ap"] is not None and 0.0 <= out["test_mean_fg_roi_ap"] <= 1.0
