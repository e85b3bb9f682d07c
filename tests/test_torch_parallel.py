"""Data parallelism of the port (``parallel/mesh.py``) on the CPU.

Two gloo ranks, each a subprocess with a hard timeout (``testing.run_ranks``),
take their rows of a global batch of 8 in 2 microbatches (2 rows per rank
per microbatch) and run one train step and one validation step
(``testing.dp_step``) of Retina U-Net (2D), Mask R-CNN (3D, the weights and
proposal counts under which positive RoIs are sampled) and Detection U-Net
(2D, class and false-positive weights). Each is held against the port's
single-process step on the whole batch:

  * loss and every monitor value, train and validation: 1e-6 relative (the
    same float32 terms summed in another order);
  * gradients: 1e-5 of each tensor's max; the stem and the first ResBlock
    1e-3, where sums over every position cancel (ROADMAP, Queue 3);
  * the two ranks' updated parameters equal to each other, and to the
    single-process ones where the gradient is clear of zero (1e-6; Adam's
    first step is lr * sign(g)), else within 2 lr;
  * the train step's detections, each rank's rows: equal boxes and classes
    (Retina U-Net's refinement selects its candidates over the global
    batch).

Retina U-Net runs on JAX's draws (its key tree, as ``test_torch_train.py``)
and is also held against JAX's ``_train_step_fn`` on the global batch, at
``test_torch_train.py``'s first-step tolerances. Beside: the row layout, the
identity of ``batch_sum`` outside a step, the env contract of
``maybe_initialize_distributed``, ``host_shard_info``, the port's LIDC
loaders under ``cf.input_shard = (1, 2)`` against JAX's, and the toy and
PET-CT patient slices.
"""

import os
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_torch import testing  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.ops.topk import top_k  # noqa: E402
from medicaldetectiontoolkit_torch.parallel import mesh  # noqa: E402
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
LR = 1e-3
LOOSE = ("fpn.stem", "fpn.stages.0.0.")  # the stem and the first ResBlock


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def jax_draws(rng, tnet, n_micro, m):
    """The port's draw tensors from JAX's key tree of one train step
    (``tests/test_torch_train.py``)."""
    cf = tnet.cf
    A = tnet.anchors.shape[0]
    k_pool = min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A)
    keys = jax.random.split(rng, n_micro) if n_micro > 1 else rng[None]
    match, shem = [], []
    for r in keys:
        per = jax.random.split(r, 2 * m).reshape(2, m, -1)
        match.append(jax.vmap(lambda k: jax.random.uniform(k, (A,)))(per[0]))
        shem.append(jax.vmap(lambda k: jax.random.uniform(k, (k_pool,)))(per[1]))
    return torch.from_numpy(np.array(jnp.stack(match))), torch.from_numpy(np.array(jnp.stack(shem)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results per case, the single-process results per
    case, and JAX's Retina U-Net step (monitor, mu, new params)."""
    out_dir = str(tmp_path_factory.mktemp("dp_ranks"))
    cf, batch, init = testing.dp_case("retina_unet")
    tnet = tbuild(cf, None, device="cpu")
    tnet.initialize(seed=init)
    key = jax.random.PRNGKey(5)
    draws = jax_draws(key, tnet, 2, cf.batch_size // 2)
    draws_path = os.path.join(out_dir, "draws.pt")
    torch.save(draws, draws_path)
    argv = ["-m", "medicaldetectiontoolkit_torch.testing", "dp_rank", out_dir, "cpu",
            f"retina_unet:{draws_path}", "mrcnn", "detection_unet"]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(testing.run_ranks, argv, 2, 240.0)
        single = {}
        for name in testing.DP_CASES:
            c, b, i = testing.dp_case(name)
            single[name] = testing.dp_step(c, b, i, draws=draws if name == "retina_unet" else None)
        jnet = jbuild(cf, _Log())
        p0 = convert.torch_to_jax(tnet.module.state_dict(), tnet.module)
        params = jax.device_put(p0)
        jout = jnet._train_step_fn(params, jnet._optimizer.init(params), key, jnp.float32(LR), *jnet._prep(batch))
        new_params, opt_state, monitor = jax.device_get(jout[:3])
        adam = convert._adam_state(opt_state)
        jax_step = ({k: float(v) for k, v in monitor.items()}, convert.jax_to_torch(adam.mu, tnet.module),
                    convert.jax_to_torch(new_params, tnet.module))
        ranks.result()
    rank_results = {name: [torch.load(os.path.join(out_dir, f"{name}_rank{r}.pt"), weights_only=False)
                           for r in range(2)] for name in testing.DP_CASES}
    return rank_results, single, jax_step


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _check_params(p, want, grad):
    """Updated params: 1e-6 where the gradient is clear of zero, else 2 lr."""
    clear = grad.abs() > 1e-3 * grad.abs().max()
    diff = (p - want).abs()
    assert float(torch.where(clear, diff, 0.0).max()) <= 1e-6
    assert float(diff.max()) <= 2 * LR + 1e-6


@pytest.mark.parametrize("case", testing.DP_CASES)
def test_two_ranks_equal_the_single_card_step(case, runs):
    rank_results, single, _ = runs
    ref = single[case]
    for r, res in enumerate(rank_results[case]):
        assert list(res["rows"]) == list(mesh.shard_rows(8, r, 2, 2))
        for key in ("train", "val"):
            assert set(res[key]) == set(ref[key])
            for k, v in ref[key].items():
                np.testing.assert_allclose(res[key][k], v, rtol=1e-6, err_msg=f"{case} {key} {k}")
        for name, g in ref["grads"].items():
            assert _rel_err(res["grads"][name], g) <= (1e-3 if name.startswith(LOOSE) else 1e-5), (case, name)
            _check_params(res["params"][name], ref["params"][name], g)
        for row, dets in zip(res["rows"], res["dets"]):
            want = ref["dets"][row]
            assert [(d["box_coords"].tolist(), d["box_pred_class_id"]) for d in dets] == \
                [(d["box_coords"].tolist(), d["box_pred_class_id"]) for d in want], (case, row)
            assert all(abs(d["box_score"] - w["box_score"]) <= 1e-5 for d, w in zip(dets, want))
    a, b = rank_results[case]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), (case, name)
        assert torch.equal(a["grads"][name], b["grads"][name]), (case, name)
    if case == "mrcnn":  # positive RoIs were sampled: the box loss ran
        assert ref["train"]["mrcnn_bbox_loss"] > 0
    assert sum(len(d) for d in ref["dets"]) > 0


def test_two_rank_retina_unet_step_matches_jax(runs):
    """The 2-rank step against JAX's ``_train_step_fn`` on the global
    batch, at ``test_torch_train.py``'s first-step tolerances (monitor 1e-5
    relative; gradient = optax's mu / 0.1 within 1e-4 of each max)."""
    rank_results, _, (monitor, mu, want_p) = runs
    for res in rank_results["retina_unet"]:
        for k, v in monitor.items():
            np.testing.assert_allclose(res["train"][k], v, rtol=1e-5, err_msg=k)
        for name, g in res["grads"].items():
            assert _rel_err(g, mu[name] / 0.1) <= 1e-4, name
            _check_params(res["params"][name], want_p[name], mu[name])


def test_shard_rows_layout():
    """Microbatch k holds global rows [4k, 4k + 4); rank r its rows
    [4k + 2r, 4k + 2r + 2) (``base.accum_backward``'s split, JAX's)."""
    assert mesh.shard_rows(8, 0, 2, 2).tolist() == [0, 1, 4, 5]
    assert mesh.shard_rows(8, 1, 2, 2).tolist() == [2, 3, 6, 7]
    assert mesh.shard_rows(8, 3, 4, 1).tolist() == [6, 7]
    assert mesh.shard_rows(6, 1, 2, 1).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="microbatch of 3 rows .* over 2 ranks"):
        mesh.shard_rows(6, 0, 2, 2)
    cf = testing.make_config(batch_size=4)
    batch = testing.make_batch(cf, seed=0)
    part = mesh.shard_batch(batch, 1, 2, 2)
    assert part["pid"] == ["1", "3"]
    np.testing.assert_array_equal(part["data"], batch["data"][[1, 3]])
    assert [b.tolist() for b in part["bb_target"]] == [batch["bb_target"][i].tolist() for i in (1, 3)]


def test_batch_sums_are_the_identity_outside_a_step():
    t = torch.randn(3, 5, requires_grad=True)
    assert mesh.current() is None
    assert mesh.batch_sum(t) is t
    assert torch.equal(mesh.batch_mean(t), t.mean())
    flat = torch.tensor([0.5, 0.9, 0.9, 0.1, 0.7])
    scores, idx, own = mesh.batch_top_k(flat, 3, 1)
    want = top_k(flat, 3)
    assert own is None and torch.equal(scores, want[0]) and torch.equal(idx, want[1])
    with pytest.raises(RuntimeError, match="process group"):
        mesh.DataParallel()


def test_maybe_initialize_distributed_env_contract(monkeypatch):
    """As JAX's (``tests/test_exp_utils.py``): all three of MDT_DIST_COORD,
    _NPROCS and _RANK opt in; with them a world of 1 comes up over gloo on
    the CPU and ``host_shard_info`` reads it."""
    for k in ("MDT_DIST_COORD", "MDT_DIST_NPROCS", "MDT_DIST_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed(device="cpu") is False
    monkeypatch.setenv("MDT_DIST_COORD", f"127.0.0.1:{mesh.free_port()}")
    monkeypatch.setenv("MDT_DIST_NPROCS", "1")
    assert mesh.maybe_initialize_distributed(device="cpu") is False  # no rank
    monkeypatch.setenv("MDT_DIST_RANK", "0")
    monkeypatch.setenv("MDT_DIST_INIT_TIMEOUT", "30")
    assert mesh.maybe_initialize_distributed(device="cpu") is True
    try:
        assert mesh.dist.get_backend() == "gloo"
        assert mesh.rank_and_world() == (0, 1) and mesh.host_shard_info() == (0, 1)
        dp = mesh.DataParallel()
        assert (dp.rank, dp.world) == (0, 1)
    finally:
        mesh.dist.destroy_process_group()
    assert mesh.rank_and_world() == (0, 1)


def test_host_shard_info_and_local_batch():
    cf = testing.make_config(batch_size=8)
    assert mesh.host_shard_info(cf) == (0, 1) and mesh.host_shard_info() == (0, 1)
    assert mesh.local_batch_size(cf) == 8
    cf.input_shard = (1, 2)
    assert mesh.host_shard_info(cf) == (1, 2)
    assert mesh.local_batch_size(cf) == 4
    cf.batch_size = 5
    with pytest.raises(ValueError, match="batch_size 5 .* over 2 ranks"):
        mesh.local_batch_size(cf)


def _lidc_cf(exp_dir, data_dir, batch_size, val_mode):
    """The loader settings of ``tests/test_torch_lidc_train.py``'s 3D case,
    on rank 1 of 2 (``cf.input_shard``), one worker (with more, the order
    between workers is the thread scheduler's)."""
    os.makedirs(exp_dir)
    da = {"do_elastic_deform": False, "alpha": (0.0, 1500.0), "sigma": (30.0, 50.0), "do_rotation": True,
          "angle_x": (0, 0.0), "angle_y": (0, 0.0), "angle_z": (0.0, 2 * np.pi), "do_scale": True,
          "scale": (0.8, 1.1), "random_crop": False, "border_mode_data": "constant", "border_cval_data": 0,
          "order_data": 1}
    return SimpleNamespace(
        dim=3, patch_size=[32, 32, 8], pre_crop_size=[40, 40, 12], n_3D_context=None, head_classes=3,
        batch_sample_slack=0.2, batch_size=batch_size, da_kwargs=da, class_specific_seg_flag=False, n_workers=1,
        seed=0, n_cv_splits=3, exp_dir=exp_dir, fold=1, created_fold_id_pickle=False, hold_out_test_set=False,
        val_mode=val_mode, num_val_batches=2, max_val_patients=None, merge_2D_to_3D_preds=False,
        pp_data_path=data_dir, pp_test_data_path=data_dir, input_df_name="info_df.pickle",
        select_prototype_subset=None, server_env=False, data_dest=None, max_test_patients="all",
        input_shard=(1, 2))


def test_lidc_loaders_take_the_rank_share(tmp_path):
    """The port's LIDC loaders under ``cf.input_shard = (1, 2)`` against
    JAX's: JAX's loader feeds ``cf.batch_size`` patches per host, the port's
    ``cf.batch_size / W`` of the global batch, so JAX runs at half the
    port's batch; then the batches (worker seeds ``rank * n_workers + w``)
    are equal array for array, and the test and val_patient iterators hold
    the same patient slice ``pids[1::2]``."""
    pytest.importorskip("pandas")
    from experiments.lidc_exp import data_loader as jdl
    from experiments.lidc_exp.preprocessing import generate_synthetic_lidc
    from medicaldetectiontoolkit_torch.experiments.lidc_exp import data_loader as pdl

    data = str(tmp_path / "data")
    generate_synthetic_lidc(data, n_patients=9, shape=(20, 44, 50), seed=3)
    cfs = {"jax": _lidc_cf(str(tmp_path / "jax"), data, 2, "val_patient"),
           "port": _lidc_cf(str(tmp_path / "port"), data, 4, "val_patient")}
    jgen, pgen = jdl.get_train_generators(cfs["jax"], _Log()), pdl.get_train_generators(cfs["port"], _Log())
    try:
        for key in ("train", "val_sampling"):
            for _ in range(2):
                pb, jb = next(pgen[key]), next(jgen[key])
                assert pb["data"].shape[0] == 2
                testing.assert_same(pb, jb)
        pids = pgen["val_patient"].dataset_pids
        assert pids == jgen["val_patient"].dataset_pids and len(pids) == 1
        assert pgen["n_val"] == len(pids)  # this rank's slice (JAX counts every val patient)
    finally:
        for gens in (jgen, pgen):
            for key in ("train", "val_sampling"):
                gens[key].shutdown()
    for cf in cfs.values():
        cf.n_workers = 3
    seeds = [[rng.get_state()[1][0] for rng in dl.create_data_gen_pipeline({}, cfs[name], True)._rngs]
             for name, dl in (("jax", jdl), ("port", pdl))]
    assert seeds[0] == seeds[1] == [np.random.RandomState(s).get_state()[1][0] for s in (3, 4, 5)]
    jtest, ptest = jdl.get_test_generator(cfs["jax"], _Log()), pdl.get_test_generator(cfs["port"], _Log())
    every = [v["pid"] for v in pdl.load_dataset(cfs["port"], _Log(), pickle.load(
        open(tmp_path / "port" / "fold_ids.pickle", "rb"))[1][2]).values()]
    assert ptest["test"].dataset_pids == jtest["test"].dataset_pids == every[1::2]
    assert ptest["n_test"] == jtest["n_test"] == len(every[1::2])


def test_toy_and_petct_iterators_take_the_rank_slice(tmp_path):
    """The toy and PET-CT patient iterators on rank 1 of 2: ``pids[1::2]``,
    and ``n_test`` counts that slice."""
    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import data_loader as petct_dl
    from medicaldetectiontoolkit_torch.experiments.toy_exp import data_loader as toy_dl

    for dl in (toy_dl, petct_dl):
        data = {f"p{i}": {"pid": f"p{i}"} for i in range(5)}
        cf = SimpleNamespace(input_shard=(1, 2), patch_size=[32, 32], dim=2)
        assert dl.PatientBatchIterator(data, cf).dataset_pids == ["p1", "p3"]
        cf.input_shard = None
        assert len(dl.PatientBatchIterator(data, cf).dataset_pids) == 5
