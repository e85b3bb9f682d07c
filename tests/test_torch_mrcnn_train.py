"""Two-stage training of the port against the JAX package's train step on
the CPU: the same weights (the port's init, converted), the same batch and
JAX's own draws (its key tree: ``_next_rng`` -> ``split(rng, n_micro)`` ->
``split(r, 3*m).reshape(3, m, -1)``; ``rngs[0]`` matching, ``rngs[1]`` RPN
SHEM, ``rngs[2]`` -> ``split`` -> ``rng_pos``, ``rng_neg``, where
``rng_neg`` draws both the RoI SHEM pool and the negatives), then the step
on both sides.

Cases: ``detection_target_layer`` per element (with GTs, with none, 12 GT
instances on 8 mask slots) and ``_prep``'s ``max_gt_masks`` cap; the three
second-stage losses; a train step of mrcnn and ufrcnn in 2D and 3D (3D
mrcnn with 2 microbatches, remat and ``MDT_STEM_PALLAS=1``); a validation
step with masks; ``exec --mode train_test`` of mrcnn on a synthetic LIDC
experiment, and a JAX-written mrcnn checkpoint loaded by the port.

Tolerances (those of ``tests/test_torch_train.py``):
  * loss and monitor values: 1e-5 relative (means of the same float32
    terms); the second-stage losses fed the same inputs: 1e-6 relative;
  * gradients and Adam moments, per tensor, relative to the tensor's max:
    1e-4 (the step's first);
  * updated params where the gradient is clear of zero and of one sign on
    both sides: 1e-6 absolute (Adam's first step is lr * sign(g)); elsewhere
    2 lr;
  * sampled RoIs, proposals and detection targets: slots, classes and
    masks equal; boxes and deltas within 1e-5 relative plus 1e-6 absolute
    (the decode's ``exp`` from another math library); detections equal in
    coords and class, scores within 1e-5; the results dict likewise (boxes
    of the proposals and RoIs within 1e-4 pixels).
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.models import mrcnn as jmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.models import mrcnn as tmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
LR = 1e-3
CASES = ["mrcnn_2d", "ufrcnn_2d", "mrcnn_3d", "ufrcnn_3d"]


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


# the port's init seed and each case's batch seed: random heads score small
# anchors first, so that positive RoIs (IoU >= 0.5 in 2D, 0.3 in 3D) are
# sampled only for some weights and batches; these sample them in every case
# (and in both microbatches of mrcnn_3d), so the box and mask losses run
INIT_SEED = 4
BATCH_SEED = {"mrcnn_2d": 1, "ufrcnn_2d": 1, "mrcnn_3d": 1, "ufrcnn_3d": 3}


def _config(case):
    model, dim = case.split("_")
    cf = make_config(model=model, dim=int(dim[0]), batch_size=4 if case == "mrcnn_3d" else 2, retina_scales=False)
    # more candidates and proposals than the defaults (500, 50), so that
    # some clear the positive IoU
    cf.pre_nms_limit, cf.post_nms_rois_training = 2000, 300
    if case == "mrcnn_3d":
        cf.grad_accum_steps, cf.use_remat = 2, True
    return cf


def _uniform(keys, n):
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def dtl_draws(keys, P, k_pool):
    """The draws of ``detection_target_layer`` from its per-element keys:
    (pos (m, P), SHEM (m, k_pool), neg (m, P)); rng_neg draws twice."""
    pos_neg = jax.vmap(jax.random.split)(keys)
    return _uniform(pos_neg[:, 0], P), _uniform(pos_neg[:, 1], k_pool), _uniform(pos_neg[:, 1], P)


def jax_draws(rng, tnet, n_micro, m):
    """The port's five draw tensors from JAX's key tree of one step."""
    cf = tnet.cf
    A, P = tnet.anchors.shape[0], cf.post_nms_rois_training
    k_rpn = min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A)
    k_roi = min(cf.shem_poolsize * tmrcnn.roi_slots(cf)[1], P)
    keys = jax.random.split(rng, n_micro) if n_micro > 1 else rng[None]
    out = []
    for r in keys:
        per = jax.random.split(r, 3 * m).reshape(3, m, -1)
        out.append((_uniform(per[0], A), _uniform(per[1], k_rpn), *dtl_draws(per[2], P, k_roi)))
    return tuple(torch.from_numpy(np.stack(parts)) for parts in zip(*out))


@functools.lru_cache(maxsize=None)
def jax_run(case):
    """One JAX train step from the port's seed-``INIT_SEED`` weights: (cf,
    batch, key, JAX detector, numpy (params, opt_state) before the step, step
    outputs)."""
    cf = _config(case)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.initialize(seed=INIT_SEED)
    jnet = jbuild(cf, _Log())
    p0 = convert.torch_to_jax(tnet.module.state_dict(), tnet.module)
    batch = make_batch(cf, seed=BATCH_SEED[case])
    key = jax.random.PRNGKey(5)
    old = os.environ.get("MDT_STEM_PALLAS")
    os.environ["MDT_STEM_PALLAS"] = "1" if case == "mrcnn_3d" else "0"
    try:
        params, opt_state = jax.device_put(p0), jnet._optimizer.init(jax.device_put(p0))
        before = jax.device_get((params, opt_state))
        out = jax.device_get(jnet._train_step_fn(params, opt_state, key, jnp.float32(LR), *jnet._prep(batch)))
    finally:
        if old is None:
            os.environ.pop("MDT_STEM_PALLAS")
        else:
            os.environ["MDT_STEM_PALLAS"] = old
    return cf, batch, key, jnet, before, out


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _port_net(cf, params, opt_state=None):
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params, opt_state)
    tnet.current_lr = LR
    return tnet


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _check_outs(t_small, jouts):
    """Detections, proposals and sampled RoIs of one step against JAX's."""
    np.testing.assert_array_equal(t_small["det_mask"].numpy(), jouts["det_mask"])
    np.testing.assert_array_equal(t_small["det"].numpy()[..., :-1], jouts["det"][..., :-1])
    _close(t_small["det"].numpy()[..., -1], jouts["det"][..., -1], rtol=0, atol=1e-5)
    for key in ("sampled_valid", "sampled_class"):
        np.testing.assert_array_equal(t_small[key].numpy(), jouts[key], err_msg=key)
    _close(t_small["sampled_rois"].numpy(), jouts["sampled_rois"])
    _close(t_small["out_proposals"].numpy(), jouts["out_proposals"], atol=1e-4)


def _check_results(tres, jres):
    assert set(tres) == set(jres)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    for k in jres["monitor_values"]:
        np.testing.assert_allclose(tres["monitor_values"][k], jres["monitor_values"][k], rtol=1e-5)
    assert tres["seg_preds"].shape == jres["seg_preds"].shape and tres["seg_preds"].dtype == jres["seg_preds"].dtype
    for tb, jb in zip(tres["boxes"], jres["boxes"]):
        assert [b["box_type"] for b in tb] == [b["box_type"] for b in jb]
        for t, j in zip(tb, jb):
            if t["box_type"] in ("prop", "pos_class", "neg_class"):
                _close(t["box_coords"], j["box_coords"], atol=1e-4)
            else:
                np.testing.assert_array_equal(t["box_coords"], j["box_coords"])
            if "box_score" in j:
                assert abs(t["box_score"] - j["box_score"]) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_jax(case, monkeypatch):
    cf, batch, key, jnet, (params, opt_state), jout = jax_run(case)
    new_params, j_opt, j_monitor, j_outs = jout
    monkeypatch.setenv("MDT_STEM_PALLAS", "1" if case == "mrcnn_3d" else "0")
    tnet = _port_net(cf, params, opt_state)
    tnet.draws = lambda n_micro, m: jax_draws(key, tnet, n_micro, m)
    handles = tnet.train_forward_dispatch(batch)
    grads = {n: p.grad.clone() for n, p in tnet.module.named_parameters()}
    monitor = handles[1]
    if case == "mrcnn_3d":
        assert tnet.module.fpn.stem1.stem_kernel and tnet.module.fpn.stem1.remat
    assert set(monitor) == set(j_monitor)
    for k, v in j_monitor.items():
        np.testing.assert_allclose(float(monitor[k]), float(v), rtol=1e-5, err_msg=k)
    assert float(monitor["mrcnn_bbox_loss"]) > 0  # positives were sampled
    if case.startswith("mrcnn"):
        assert float(monitor["mrcnn_mask_loss"]) > 0

    adam = convert._adam_state(j_opt)
    mu, nu = convert.jax_to_torch(adam.mu, tnet.module), convert.jax_to_torch(adam.nu, tnet.module)
    want_p = convert.jax_to_torch(new_params, tnet.module)
    for name, p in tnet.module.named_parameters():
        st = tnet.optimizer.state[p]
        assert _rel_err(grads[name], mu[name] / 0.1) <= 1e-4, name  # optax's first moment is (1 - b1) * g
        assert _rel_err(st["exp_avg_sq"], nu[name]) <= 1e-4, name
        g_t, g_j = st["exp_avg"], mu[name]
        clear = (torch.sign(g_t) == torch.sign(g_j)) & (g_j.abs() > 1e-3 * g_j.abs().max())
        diff = (p.detach() - want_p[name]).abs()
        assert float(torch.where(clear, diff, 0.0).max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR + 1e-6, name

    _check_outs(handles[3], j_outs)
    if j_outs["seg_preds"] is not None:
        assert (handles[5].numpy() != j_outs["seg_preds"]).mean() <= 1e-4  # argmax near-ties of the seg logits
    jres = jnet.train_forward_convert((j_monitor, j_outs, False), batch)
    _check_results(tnet.train_forward_convert(handles, batch), jres)
    # without the full-volume seg copy: a float32 zero volume, as in JAX
    res = tnet.train_forward_convert(handles, batch, need_seg_preds=False)
    assert res["seg_preds"].dtype == np.float32 and not res["seg_preds"].any()


def test_validation_step_matches_jax():
    """A validation step (no update, masks returned) from the same weights
    and JAX's draws: monitor values, detections, sampled RoIs, the raw masks
    and the results dict."""
    cf, batch, _, jnet, (params, _), _ = jax_run("mrcnn_2d")
    key = jax.random.PRNGKey(9)
    j_monitor, j_outs = jax.device_get(jnet._loss_eval_fn(jax.device_put(params), key, *jnet._prep(batch),
                                                          with_masks=True))
    tnet = _port_net(cf, params)
    tnet.draws = lambda n_micro, m: jax_draws(key, tnet, n_micro, m)
    before = {k: v.clone() for k, v in tnet.module.state_dict().items()}
    handles = tnet.train_forward_dispatch(batch, is_validation=True)
    for k, v in tnet.module.state_dict().items():
        assert torch.equal(v, before[k])
    for k, v in j_monitor.items():
        np.testing.assert_allclose(float(handles[1][k]), float(v), rtol=1e-5, err_msg=k)
    _check_outs(handles[3], j_outs)
    masks = handles[4].numpy()  # (b, max_inst, C, *mask_shape)
    assert np.abs(masks - np.moveaxis(j_outs["det_masks_raw"], -1, 2)).max() <= 1e-5
    _check_results(tnet.train_forward_convert(handles, batch), jnet.train_forward_convert((j_monitor, j_outs, True),
                                                                                          batch))


def _dtl_inputs(seed, dim, gt, gt_ids, G=4, n_mask_slots=None, P=6, proposals=None):
    """One element's inputs of ``detection_target_layer`` (as
    ``tests/test_mrcnn.py::TestDetectionTargetLayer``)."""
    rng = np.random.RandomState(seed)
    if proposals is None:
        lo = rng.rand(P, dim) * 0.6
        proposals = np.concatenate([lo[:, :2], lo[:, :2] + 0.1 + rng.rand(P, 2) * 0.3] + (
            [lo[:, 2:], lo[:, 2:] + 0.2 + rng.rand(P, 1) * 0.3] if dim == 3 else []), axis=1).astype(np.float32)
        proposals[:len(gt)] = gt + rng.randn(*gt.shape).astype(np.float32) * 0.01  # near matches
    P = len(proposals)
    gt_boxes = np.zeros((G, 2 * dim), np.float32)
    ids, valid = np.zeros((G,), np.int32), np.zeros((G,), bool)
    gt_boxes[:len(gt)], ids[:len(gt)], valid[:len(gt)] = gt, gt_ids, True
    spatial = (32, 32) if dim == 2 else (32, 32, 8)
    n_mask_slots = G if n_mask_slots is None else n_mask_slots
    masks = np.zeros((n_mask_slots, *spatial), np.uint8)
    for i, g in enumerate(gt[:n_mask_slots]):
        masks[(i, *[slice(int(g[k] * spatial[k // 2]), int(g[k + 2] * spatial[k // 2])) for k in (0, 1)])] = 1
    scores = rng.rand(P, 3).astype(np.float32)
    return [proposals, np.ones((P,), bool), scores, gt_boxes, ids, valid, masks]


def _dtl_both(cf, inputs_list, seed=0):
    """JAX's layer per element against the port's over the batch of them."""
    P = inputs_list[0][0].shape[0]
    k_pool = min(cf.shem_poolsize * tmrcnn.roi_slots(cf)[1], P)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(inputs_list))
    fn = jax.jit(lambda k, *a: jmrcnn.detection_target_layer(k, *a, cf))
    want = [jax.device_get(fn(k, *[jnp.asarray(a) for a in inp])) for k, inp in zip(keys, inputs_list)]
    batched = [torch.from_numpy(np.stack(parts)) for parts in zip(*inputs_list)]
    draws = [torch.from_numpy(d) for d in dtl_draws(keys, P, k_pool)]
    got = tmrcnn.detection_target_layer(draws, *batched, cf)
    names = ("rois", "slot_valid", "target_class", "target_deltas", "target_masks", "pos_mask", "mask_pos")
    for b, w in enumerate(want):
        for name, t, j in zip(names, got, w):
            if name in ("rois", "target_deltas"):
                _close(t[b].numpy(), j)
            else:
                np.testing.assert_array_equal(t[b].numpy(), j, err_msg=f"element {b}: {name}")
    return [[t[b].numpy() for t in got] for b in range(len(want))]


@pytest.mark.parametrize("dim", [2, 3])
def test_detection_target_layer_matches_jax(dim):
    """Two elements with GTs, one with none (all negative)."""
    cf = make_config("mrcnn", dim=dim, retina_scales=False)
    gt = np.array([[0.1, 0.1, 0.3, 0.3] + ([0.2, 0.6] if dim == 3 else []),
                   [0.5, 0.4, 0.8, 0.7] + ([0.1, 0.5] if dim == 3 else [])], np.float32)
    inputs = [_dtl_inputs(s, dim, gt[:n], [2, 1][:n], P=10) for s, n in ((0, 2), (1, 1), (2, 0))]
    out = _dtl_both(cf, inputs)
    assert out[0][5].sum() >= 1 and out[0][4].any()  # positives with mask targets
    assert out[2][5].sum() == 0 and (out[2][2] == 0).all() and out[2][1].sum() >= 1  # no GT: negatives only


def test_detection_target_layer_mask_slots_match_jax():
    """12 GT instances on 8 mask slots (``tests/test_mrcnn.py``'s case):
    every positive's mask target is its own instance's; those past the slots
    get no mask supervision."""
    cf = make_config("mrcnn", dim=2, retina_scales=False)
    cf.train_rois_per_image = 24
    gt = np.array([[r * 0.25 + 0.02, c * 0.33 + 0.02, r * 0.25 + 0.20, c * 0.33 + 0.28]
                   for r in range(4) for c in range(3)], np.float32)
    (rois, _, tclass, _, tmasks, pos, mask_pos), = _dtl_both(
        cf, [_dtl_inputs(0, 2, gt, [1] * 12, G=12, n_mask_slots=8, proposals=gt.copy())])
    assert pos.sum() == 12 and mask_pos.sum() == 8 and (tclass[pos] == 1).all()
    for s in np.flatnonzero(pos):
        a = int(np.argmin(np.abs(gt - rois[s]).sum(axis=1)))
        assert mask_pos[s] == (a < 8) and (tmasks[s].mean() > 0.6 if a < 8 else not tmasks[s].any())


def test_prep_caps_gt_masks_as_jax():
    """``cf.max_gt_masks`` below ``max_gt_boxes``: the uint8 mask slots."""
    cf = make_config("mrcnn", dim=3, batch_size=2, retina_scales=False)
    cf.max_gt_masks = 1
    batch = make_batch(cf, seed=4)
    batch["roi_masks"] = [np.concatenate([m, 1 - m]) for m in batch["roi_masks"]]  # 2 masks per element
    want = np.asarray(jbuild(cf, _Log())._prep(batch)[4])
    tnet = tbuild(cf, _Log(), device="cpu")
    got = tnet._prep(batch)[4]
    assert got.dtype == torch.uint8 and got.shape == (2, 1, *cf.patch_size)
    np.testing.assert_array_equal(got.numpy(), want)


def test_second_stage_losses_match_jax():
    rng = np.random.RandomState(3)
    S, C = 12, 3
    target_class = rng.randint(0, C, S).astype(np.int32)
    valid, pos = rng.rand(S) > 0.2, rng.rand(S) > 0.5
    logits = rng.randn(S, C).astype(np.float32)
    t_deltas, p_deltas = rng.randn(S, 6).astype(np.float32), rng.randn(S, C, 6).astype(np.float32) * 2
    t_masks = (rng.rand(S, 6, 5, 3) > 0.5).astype(np.float32)
    p_masks = rng.rand(S, 6, 5, 3, C).astype(np.float32)
    p_masks[0, 0, 0, 0] = [0.0, 1.0, 0.5]  # the clipped ends
    j, t = jnp.asarray, torch.from_numpy
    pairs = [
        (jmrcnn.mrcnn_class_loss(j(target_class), j(logits), j(valid)),
         tmrcnn.mrcnn_class_loss(t(target_class), t(logits), t(valid))),
        (jmrcnn.mrcnn_bbox_loss(j(t_deltas), j(p_deltas), j(target_class), j(pos)),
         tmrcnn.mrcnn_bbox_loss(t(t_deltas), t(p_deltas), t(target_class), t(pos))),
        (jmrcnn.mrcnn_mask_loss(j(t_masks), j(p_masks), j(target_class), j(pos)),
         tmrcnn.mrcnn_mask_loss(t(t_masks), t(np.moveaxis(p_masks, -1, 1).copy()), t(target_class), t(pos))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    empty = np.zeros(S, bool)
    assert float(tmrcnn.mrcnn_bbox_loss(t(t_deltas), t(p_deltas), t(target_class), t(empty))) == 0.0


def test_exec_train_test_mrcnn(tmp_path):
    """``exec --mode train_test`` with ``MDT_MODEL=mrcnn`` on the CPU: the
    monitor values, the ranked checkpoints, ``last_checkpoint`` and the test
    results are written; a best checkpoint written by the JAX package loads
    into the port."""
    import pickle

    from medicaldetectiontoolkit_tpu.utils.exp_utils import save_checkpoint as jax_save
    from medicaldetectiontoolkit_torch.testing import make_lidc_experiment, run_lidc_train
    from medicaldetectiontoolkit_torch.utils import exp_utils

    env = {"MDT_DIM": "3", "MDT_MODEL": "mrcnn", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "2",
           "MDT_LIDC_EPOCHS": "2", "MDT_LIDC_NTB": "1", "MDT_LIDC_NVB": "1"}
    small = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4,
             "n_workers": 1, "plot_prediction_histograms": False, "post_nms_rois_inference": 50,
             "roi_chunk_size": 100}
    cf = make_lidc_experiment(str(tmp_path), env, small, n_patients=6, seeds=(), epochs=())
    out = run_lidc_train(cf, "train_test", device="cpu")
    metrics = out["train"]["monitor_metrics"]
    values = [m for split in ("train", "val") for ep in metrics[split]["monitor_values"][1:] for m in ep]
    assert len(values) == 2 * (1 + 1) and all(set(m) == {"loss", "class_loss"} for m in values)
    assert all(np.isfinite(v) for m in values for v in m.values())
    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    ranking = np.load(os.path.join(fold_dir, "epoch_ranking.npy"))
    assert sorted(ranking.tolist()) == [1, 2]
    assert {f"{e}_best_checkpoint" for e in ranking} | {"last_checkpoint"} <= set(os.listdir(fold_dir))
    last = exp_utils.load_checkpoint_state(os.path.join(fold_dir, "last_checkpoint"))
    assert last["epoch"] == 2 and len(last["opt_state"]["state"]) == len(last["params"])
    with open(os.path.join(cf.exp_dir, "fold_ids.pickle"), "rb") as handle:
        n_test = len(pickle.load(handle)[0][2])
    assert len(out["test"]["results"]) == n_test
    assert os.path.isfile(os.path.join(cf.exp_dir, "results.txt"))

    # a best checkpoint written by the JAX package (its save_checkpoint, flax
    # names) loads into the port and gives its weights back
    net = tbuild(cf, _Log(), device="cpu")
    net.initialize(seed=3)
    ckpt = os.path.join(str(tmp_path), "jax_best")
    jax_save(ckpt, {"params": net.jax_params(), "epoch": 1})
    other = tbuild(cf, _Log(), device="cpu")
    other.load_params(exp_utils.load_checkpoint_state(ckpt)["params"])
    for k, v in net.module.state_dict().items():
        assert torch.equal(v, other.module.state_dict()[k])
