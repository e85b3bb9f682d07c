"""Spatial partitioning of the port (``parallel/mesh.py``: inference over a
space group whose ranks each hold a Y slab) on the CPU.

Ranks are gloo subprocesses with a hard timeout (``testing.run_ranks``; a
rank is ``python -m medicaldetectiontoolkit_torch.testing sp_rank``):

  * four ranks run the primitives at S = 4 (one space group) and at S = 2
    (a 2 x 2 grid): ``halo_exchange`` (zeros, ``-inf`` and the edge row
    repeated), ``space_sum`` and ``gather_y`` against slicing the whole
    padded tensor (exactly; the sum within 1e-5), and the slab-aware convs
    (3x3, 7x7 at stride 2, 1x1 at stride 2, in 2D and 3D, and K3's plain
    version at strides 1 and 2), GroupNorm (one group, instance norm), the
    max pool, ``linear_up`` and ``nearest_up``, gathered, against the
    whole-tensor op within 1e-5 (float32 sums in another order; the max
    pool, ``nearest_up`` and the halos exactly);
  * two ranks run the detectors of ``testing.SP_CASES`` at S = 2: the
    gathered heads within atol 1e-5 of the port's single-process forward,
    the seg argmax equal wherever the single-process logits' top two differ
    by more than 1e-5, the detections equal as sets within 1e-5 in score and
    1e-3 voxels (``testing.same_detections``); Mask R-CNN's seg_preds (the
    union of its unmolded masks) equal. Against the JAX package's
    single-device forward on the same weights (JAX's, converted): the
    tolerance of the port's single-card parity tests (``test_torch_retina.py``,
    ``test_torch_mrcnn.py``, ``test_torch_detection_unet.py``): heads within
    1e-4 * max|ref| (Detection U-Net's softmax 1e-5 * max|ref|),
    detections equal in coords and class with scores within 1e-5, seg_preds
    equal. The 2D Retina U-Net at patch 96 runs C5 and P5 replicated;
    ``check_space_cap`` refuses with JAX's message at enable time and per
    call; ``MDT_SP_VERIFY=1`` passes on a sound forward and fails one whose
    slabs lack their neighbours' rows;
  * ``exec --mode test`` over a 2 x 2 (data x space) grid of ranks gives
    the one-process run's detections (as sets, as above) and
    ``results.txt`` scores, and ``exec
    --mode train`` under ``n_space_parallel = 2`` starts two ranks
    (``tests/test_torch_spatial_train.py`` runs them against one process)
    unless the cap refuses the patch.
"""

import os
import pickle
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_torch import exec as port_exec  # noqa: E402
from medicaldetectiontoolkit_torch import testing  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.parallel import mesh  # noqa: E402

torch.set_num_threads(2)
RANK = ["-m", "medicaldetectiontoolkit_torch.testing", "sp_rank"]
JAX_CASES = ("retina_unet", "mrcnn", "detection_unet")
EXP_SOURCE = os.path.join(REPO, "medicaldetectiontoolkit_torch", "experiments", "lidc_exp")
ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "64,64,8", "MDT_LIDC_BS": "4"}
SMALL = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4,
         "plot_prediction_histograms": False, "test_n_epochs": 2}
RUN = "import sys; from medicaldetectiontoolkit_torch import exec as e; e.main(sys.argv[1:], device='cpu')"


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def _load(out, case, world):
    return [torch.load(os.path.join(out, f"{case}_rank{r}.pt"), weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def primitives(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sp_primitives"))
    testing.run_ranks([*RANK, out, "cpu", "primitives"], world=4, timeout=120)
    return _load(out, "primitives", 4)


def _single(case, params):
    """The port's single-process heads and ``test_forward`` results of a
    case, on the weights the ranks load."""
    cf, batch, env = testing.sp_case(case)
    with testing.env_scope(env):
        net = tbuild(cf, _Log(), device="cpu")
        if params is None:
            net.initialize(seed=1)
        else:
            net.load_params(params)
        with torch.inference_mode():
            heads = testing.sp_heads_fn(net)(torch.from_numpy(batch["data"]))
        results = net.test_forward(batch, return_masks=True)
        if case == "instance_norm":  # the same forward in float64, for the error of each float32 forward
            module = net.module.double()
            for m in module.modules():
                if getattr(m, "dtype", None) == torch.float32:
                    m.dtype = torch.float64
            with torch.inference_mode():
                results = module(torch.from_numpy(batch["data"]).double())
        return cf, batch, heads, results


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The port's single-process forward (``single``), JAX's (``jax``: heads
    channel-last, results) and the two ranks' (``ranks``) of every case, and
    the ranks' cap and verify records."""
    out = str(tmp_path_factory.mktemp("sp_models"))
    jax_ref, params = {}, {}
    for case in JAX_CASES:
        cf, batch, _ = testing.sp_case(case)
        jnet = jbuild(cf, _Log())
        jnet.initialize(seed=3)
        params[case] = jax.device_get(jnet.params)
        with open(os.path.join(out, f"{case}_params.pkl"), "wb") as handle:
            pickle.dump(params[case], handle)
        img = jnp.asarray(np.moveaxis(batch["data"], 1, -1))
        if case == "mrcnn":
            heads = jnet.module.apply({"params": jnet.params}, img, method=jnet.module.extract)
        else:
            heads = jnet._predict_fn(jnet.params, img)
        jax_ref[case] = (jax.tree_util.tree_map(np.asarray, heads), jnet.test_forward(batch, return_masks=True))
    cases = (*testing.SP_CASES, "cap", "verify")
    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process makes the references
        ranks = pool.submit(testing.run_ranks, [*RANK, out, "cpu", *cases], 2, 300.0)
        single = {case: _single(case, params.get(case)) for case in testing.SP_CASES}
        ranks.result()
    return {"single": single, "jax": jax_ref, "ranks": {case: _load(out, case, 2) for case in cases}}


#############################
#   primitives              #
#############################

@pytest.mark.parametrize("n_space", [2, 4])
def test_halo_sum_and_gather_against_the_whole_tensor(primitives, n_space):
    x = testing.sp_primitives()[0][2]
    n = x.shape[2] // n_space
    seen = set()
    for res in primitives:
        r = res[n_space]["space_index"]
        seen.add(r)
        for (lo, hi, pad), got in zip(testing.SP_HALOS, res[n_space]["halo"]):
            if pad == "replicate":
                whole = torch.cat([x[:, :, :1].expand(-1, -1, lo, -1, -1), x,
                                   x[:, :, -1:].expand(-1, -1, hi, -1, -1)], dim=2)
            else:
                whole = torch.nn.functional.pad(x, (0, 0, 0, 0, lo, hi), value=pad)
            assert torch.equal(got, whole[:, :, r * n:(r + 1) * n + lo + hi]), (lo, hi, pad, r)
        torch.testing.assert_close(res[n_space]["sum"], x.sum(dim=2), rtol=0, atol=1e-5)
        assert torch.equal(res[n_space]["gather"], x)
    assert seen == set(range(n_space))


EXACT = ("maxpool_3d", "maxpool_2d", "nearest_up_3d")


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("name", [op[0] for op in testing.sp_primitives()])
def test_slab_op_against_the_whole_tensor_op(primitives, name, n_space):
    _, fn, x = next(op for op in testing.sp_primitives() if op[0] == name)
    with torch.no_grad(), testing.env_scope({"MDT_STEM_PALLAS": "1"}):
        whole = fn(x)
    if name.startswith("k3"):
        assert fn.stem_kernel  # the plain K3 took the whole image, as each slab
    for res in primitives:
        got = res[n_space]["ops"][name]
        assert got.shape == whole.shape
        if name in EXACT:
            assert torch.equal(got, whole)
        else:
            torch.testing.assert_close(got, whole, rtol=0, atol=1e-5)


def test_outside_a_spatial_forward_the_primitives_are_plain():
    x = testing.sp_primitives()[0][2]
    assert mesh.space() is None
    assert mesh.gather_y(x) is x and mesh.space_sum(x) is x and mesh.slab_of(x) is x
    assert torch.equal(mesh.halo_exchange(x, 1, 2, 0.0), torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 2)))
    assert mesh.space_fence(x, True, 2) == (x, False)


#############################
#   detectors at S = 2      #
#############################

@pytest.mark.parametrize("case", [c for c in testing.SP_CASES if c != "instance_norm"])
def test_spatial_forward_matches_the_single_process_forward(models, case):
    cf, batch, heads, results = models["single"][case]
    ranks = models["ranks"][case]
    for res in ranks:
        assert len(mesh.tensor_leaves(res["heads"])) == len(mesh.tensor_leaves(heads))
        for got, want in zip(mesh.tensor_leaves(res["heads"]), mesh.tensor_leaves(heads)):
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        seg = res["results"]["seg_preds"]
        if case == "mrcnn":
            np.testing.assert_array_equal(seg, results["seg_preds"])
            assert seg.dtype == np.uint8 and seg.sum() > 0
        else:
            seg_logits = mesh.tensor_leaves(heads)[-1].numpy()
            top2 = np.sort(seg_logits, axis=1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0] > 1e-5)[:, None]
            assert clear.mean() > 0.99
            np.testing.assert_array_equal(np.where(clear, seg, 0), np.where(clear, results["seg_preds"], 0))
        assert sum(len(b) for b in results["boxes"]) > 0
        testing.same_detections(res["results"]["boxes"], results["boxes"])
    assert all(r["stats"]["halo"]["calls"] > 0 and r["stats"]["gather"]["calls"] > 0 for r in ranks)
    if case == "detection_unet":
        assert all(r["stats"]["sum"]["calls"] > 0 for r in ranks)  # instance norm's statistics


def test_instance_norm_spatial_forward_is_as_exact_as_the_single_process_forward(models):
    """Instance norm on levels of few voxels per channel: flax's variance
    E[x^2] - E[x]^2 in float32 is ill-conditioned there, and the
    single-process float32 logits lie up to ~2e-4 from the float64 forward
    (2D patch 128), so the slabs' sums, added in another order, cannot meet
    atol 1e-5 against them. Both float32 forwards are held against the
    float64 one: the spatial forward's error at most twice the
    single-process forward's, and the seg argmax equal where the float64
    top two differ by more than 1e-3."""
    _, _, heads, exact = models["single"]["instance_norm"]
    err_single = float((heads.double() - exact).abs().max())
    assert err_single > 1e-5  # the conditioning this test is about
    top2 = np.sort(exact.numpy(), axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    for res in models["ranks"]["instance_norm"]:
        err = float((res["heads"].double() - exact).abs().max())
        assert err <= 2 * err_single, (err, err_single)
        np.testing.assert_array_equal(np.where(clear, res["results"]["seg_preds"][:, 0], 0),
                                      np.where(clear, exact.argmax(dim=1).numpy(), 0))
        assert res["stats"]["sum"]["calls"] > 0


@pytest.mark.parametrize("case", JAX_CASES)
def test_spatial_forward_matches_jax(models, case):
    """JAX's single-device forward (which JAX's own spatial path equals
    bit for bit, ``models/base.py:372-377``) at the tolerances of the
    port's single-card parity tests."""
    jheads, jres = models["jax"][case]
    for res in models["ranks"][case]:
        if case == "detection_unet":
            logits = res["heads"]
            smax = torch.softmax(logits, dim=1).numpy()
            want = np.moveaxis(np.asarray(jheads), -1, 1)
            assert np.abs(smax - want).max() <= 1e-5 * np.abs(want).max()
        else:
            for got, want in zip(mesh.tensor_leaves(res["heads"]), mesh.tensor_leaves(jheads)):
                got = got.numpy() if got.dim() == 3 else np.moveaxis(got.numpy(), 1, -1)
                assert got.shape == want.shape
                assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        np.testing.assert_array_equal(res["results"]["seg_preds"], jres["seg_preds"])
        testing.same_detections(res["results"]["boxes"], jres["boxes"], score_tol=1e-5, coord_tol=0.0)


def test_a_level_that_stops_splitting_runs_replicated(models):
    for res in models["ranks"]["replicated"]:
        # P0, P2, P3, P4 split; C4 has 3 rows per rank, so C5 / P5 run whole
        assert res["slab_levels"] == (True, True, True, True, False)
    for res in models["ranks"]["retina_unet"]:
        assert all(res["slab_levels"])


def test_the_cap_refuses_with_jax_message(models):
    for res in models["ranks"]["cap"]:
        assert res["enable"] == ("spatial axis 2 exceeds C5 Y-extent 1 for Y=32 (stride 32); use fewer 'space' "
                                 "shards")
        assert res["call"] == res["enable"]
    cf = testing.make_config(model="retina_unet", dim=2, patch_size=[128, 128])
    cf.sixth_pooling = True
    with pytest.raises(ValueError, match=r"^spatial axis 4 exceeds C5 Y-extent 2 for Y=128 \(stride 64\)"):
        mesh.check_space_cap(cf, 4, 128)


def test_sp_verify(models):
    for res in models["ranks"]["verify"]:
        assert res["sound"] > 0
        assert "verify failed" in res["broken"]


#############################
#   exec                    #
#############################

@pytest.fixture(scope="module")
def exec_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sp_exec"))
    cf = testing.make_lidc_experiment(root, ENV, dict(SMALL, n_data_parallel=2, n_space_parallel=2), n_patients=2,
                                      shape=(16, 64, 64), hold_out=True)
    argv = ["--mode", "test", "--exp_source", EXP_SOURCE, "--exp_dir", cf.exp_dir, "--folds", "0"]
    env = dict(os.environ, OMP_NUM_THREADS="2", MDT_DIST_INIT_TIMEOUT="120")
    for key in ("MDT_DIST_COORD", "MDT_DIST_NPROCS", "MDT_DIST_RANK"):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-c", RUN, *argv], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    single = os.path.join(root, "single")
    shutil.copytree(cf.exp_dir, single)
    configs = os.path.join(single, "configs.py")
    with open(configs) as handle:
        text = handle.read()
    with open(configs, "w") as handle:
        handle.write(text.replace("'n_space_parallel': 2", "'n_space_parallel': None").replace(
            "'n_data_parallel': 2", "'n_data_parallel': None"))
    os.remove(os.path.join(single, "results.txt"))
    port_exec.main(["--mode", "test", "--exp_source", EXP_SOURCE, "--exp_dir", single, "--folds", "0"],
                   device="cpu")
    return cf.exp_dir, single


def test_exec_test_over_a_data_by_space_grid_gives_the_one_process_results(exec_run):
    """``exec --mode test`` over 2 x 2 ranks: each space group of two takes
    one of the two patients, split along Y; rank 0 writes."""
    spatial, single = exec_run

    def raw(d):
        with open(os.path.join(d, "fold_0", "raw_pred_boxes_hold_out_list.pickle"), "rb") as handle:
            return pickle.load(handle)

    def scores(d):
        with open(os.path.join(d, "results.txt")) as handle:
            return [line for line in handle.read().splitlines() if line.startswith("AUC")]

    a, b = raw(spatial), raw(single)
    assert len(a) == 2 and [p for _, p in a] == [p for _, p in b]
    for (boxes_a, _), (boxes_b, _) in zip(a, b):
        testing.same_detections(boxes_a, boxes_b)
    assert sum(x["box_type"] == "det" for boxes, _ in a for el in boxes for x in el) > 0
    assert scores(spatial) and scores(spatial) == scores(single)
    with open(os.path.join(spatial, "fold_0", "exec.log")) as handle:
        log = handle.read()
    assert "spatially-partitioned inference over 2x2 (data x space) ranks: rank 0 at data 0" in log
    assert "rank 1 at" not in log and "evaluating patient synth_001" not in log  # rank 0's log, its patient


def test_exec_train_runs_under_spatial_partitioning(tmp_path, monkeypatch):
    """``exec --mode train`` with ``n_space_parallel = 2`` starts two ranks
    of itself (``tests/test_torch_spatial_train.py`` runs them and holds
    them against one process); a patch whose deepest level has fewer Y rows
    than S is refused with JAX's message before any rank starts."""
    started = []
    monkeypatch.setattr(mesh, "spawn_ranks", lambda fn, world, args=(): started.append((fn, world, args)))
    for name, patch in (("fits", "64,64,8"), ("too_deep", "32,32,8")):
        cf = testing.make_lidc_experiment(str(tmp_path / name), dict(ENV, MDT_LIDC_PATCH=patch),
                                          dict(SMALL, n_space_parallel=2), n_patients=4, seeds=(), epochs=())
        argv = ["--mode", "train", "--exp_source", EXP_SOURCE, "--exp_dir", cf.exp_dir, "--folds", "0",
                "--use_stored_settings"]
        if name == "fits":
            assert port_exec.main(argv, device="cpu") == {}
            assert started == [(port_exec.main, 2, (argv, "cpu", None))]
        else:
            with pytest.raises(ValueError, match=r"^spatial axis 2 exceeds C5 Y-extent 1 for Y=32 \(stride 32\)"):
                port_exec.main(argv, device="cpu")
            assert len(started) == 1


def test_more_ranks_than_cards_need_the_caller_to_name_gloo(monkeypatch):
    """exec starts D x S ranks one per card; two may share a card only when
    the caller of ``main`` names the gloo backend."""
    cf = testing.make_config()
    cf.n_space_parallel = 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"2 ranks .*, but 1 CUDA card.*unless the caller names the gloo backend"):
        port_exec._check_parallel(cf, "cuda")
    with pytest.raises(ValueError, match="but 1 CUDA card"):
        port_exec._check_parallel(cf, "cuda", backend="nccl")
    port_exec._check_parallel(cf, "cuda", backend="gloo")


def test_spatial_ranks_run_with_tf32_off(models):
    """Enabling spatial inference turns cuDNN's and cuBLAS's TF32 off in the
    rank's process: a slab's shape may take another conv algorithm than the
    whole image's, and TF32 would part the two forwards."""
    for case in testing.SP_CASES:
        assert [r["tf32"] for r in models["ranks"][case]] == [(False, False)] * 2
