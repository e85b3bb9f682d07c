"""Detection U-Net of the port against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
and their counterparts in the port. Tolerances:
  * ``fused_seg_loss`` with a false-positive weight and uneven class weights:
    the port within 1e-6 relative of the float64 value of the formulas, and
    within 1e-5 of JAX's (XLA's float32 weighted CE sits up to 3.7e-6 from
    the float64 value on these inputs, the port's within 1e-7); with the
    defaults, the port's result is bit-equal to its previous formula;
  * ``get_coords`` and ``_boxes_from_softmax`` on the same mask / softmax:
    equal arrays, slices, component masks, classes; scores within 1e-7;
  * a forward of JAX's weights, converted: softmax within 1e-5 of its max;
  * a train step without and with accumulation (2 x 2), JAX's step from the
    port's weights: loss 1e-5 relative; gradients and Adam moments 1e-4 of
    each tensor's max, 5e-3 for the stem and the first ResBlock's convs
    (sums over every position that cancel, ``tests/test_torch_train.py``);
    params as ``tests/test_torch_train.py`` holds them after a first step.
    The batch dice is per microbatch on both sides.
The exec runs, the snapshot loading and the stem routing run the port alone.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.models import detection_unet as jdet  # noqa: E402
from medicaldetectiontoolkit_tpu.ops import losses as jlosses  # noqa: E402
from medicaldetectiontoolkit_torch import models as tmodels  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.models import detection_unet as tdet  # noqa: E402
from medicaldetectiontoolkit_torch.ops import losses as tlosses  # noqa: E402
from medicaldetectiontoolkit_torch.ops import stem_conv  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_batch, make_config, make_lidc_experiment  # noqa: E402
from medicaldetectiontoolkit_torch.testing import run_lidc_train  # noqa: E402
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
LR = 1e-3
# the convs whose gradient sums cancel most (see the module docstring)
EARLY = ("fpn.stem0.", "fpn.stem1.", "fpn.stages.0.0.conv1.", "fpn.stages.0.0.conv2.")


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def _previous_fused_seg_loss(seg_logits, seg, n_classes):
    """The port's ``fused_seg_loss`` before it took weights, its sums
    accumulated in float64 and the dice and CE formed in float64, then
    rounded to float32, as the port's are since its spatial form adds the Y
    slabs' sums (``ops/losses.py``)."""
    lab = seg[:, 0]
    chans = [seg_logits[:, c].to(torch.float32) for c in range(n_classes)]
    mx = chans[0]
    for c in range(1, n_classes):
        mx = torch.maximum(mx, chans[c])
    lse = mx + torch.log(sum(torch.exp(ch - mx) for ch in chans))
    intersect, psum, count, lp_y = [], [], [], 0.0
    for c in range(n_classes):
        m = (lab == c).to(torch.float32)
        logp_c = chans[c] - lse
        probs_c = torch.exp(logp_c)
        intersect.append((probs_c * m).sum(dtype=torch.float64))
        psum.append(probs_c.sum(dtype=torch.float64))
        count.append(m.sum(dtype=torch.float64))
        lp_y = lp_y + logp_c * m
    denom = torch.stack(psum) + torch.stack(count)
    dice = (2.0 * torch.stack(intersect) + 1e-6) / (denom + 1e-6)
    return (1.0 - dice[1:].mean()).float(), (-(lp_y.sum(dtype=torch.float64) / lp_y.numel())).float()


def _seg_loss_f64(logits, seg, fp_weight, class_weights):
    """(1 - mean fg batch dice, weighted CE) in float64, from the formulas."""
    x = logits.astype(np.float64)
    lab = seg[:, 0]
    logp = x - np.log(np.exp(x).sum(1, keepdims=True))
    onehot = np.stack([lab == c for c in range(x.shape[1])], 1)
    axes = (0,) + tuple(range(2, x.ndim))
    p = np.exp(logp)
    dice = (2 * (p * onehot).sum(axes) + 1e-6) / ((fp_weight * p + onehot).sum(axes) + 1e-6)
    w = np.ones(x.shape[1]) if class_weights is None else np.asarray(class_weights, np.float64)
    lp_y, w_vox = (logp * onehot).sum(1), w[lab]
    return 1 - dice[1:].mean(), -(lp_y * w_vox).sum() / w_vox.sum()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("fp_weight, class_weights", [(1.0, None), (2.5, None), (0.5, [0.2, 1.0, 3.0]),
                                                     (1.0, [1.0, 4.0, 0.5])])
def test_fused_seg_loss_matches_jax(dim, fp_weight, class_weights):
    rng = np.random.RandomState(dim)
    shape = (2, 12, 10) + ((6,) if dim == 3 else ())
    logits = rng.randn(shape[0], 3, *shape[1:]).astype(np.float32) * 2
    seg = rng.randint(0, 3, (shape[0], 1, *shape[1:])).astype(np.int32)
    t = tlosses.fused_seg_loss(torch.from_numpy(logits), torch.from_numpy(seg), 3, false_positive_weight=fp_weight,
                               class_weights=class_weights)
    j = jlosses.fused_seg_loss(jnp.asarray(np.moveaxis(logits, 1, -1)), jnp.asarray(seg), 3,
                               false_positive_weight=fp_weight, class_weights=class_weights)
    want = _seg_loss_f64(logits, seg, fp_weight, class_weights)
    for a, b, w in zip(t, j, want):
        np.testing.assert_allclose(float(a), w, rtol=1e-6)  # the port against the exact value
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    if fp_weight == 1.0 and class_weights is None:
        for a, b in zip(t, _previous_fused_seg_loss(torch.from_numpy(logits), torch.from_numpy(seg), 3)):
            assert torch.equal(a, b)


def _masks(dim):
    """A batch of three (y 16 < x 22): a size tie between two components
    beside a larger one; components on the borders (first and last row,
    column and slice); an empty mask."""
    shape = (3, 16, 22) + ((8,) if dim == 3 else ())
    m = np.zeros(shape, np.uint8)
    z = (slice(2, 5),) if dim == 3 else ()
    m[(0, slice(2, 5), slice(2, 5)) + z] = 1  # 9 (x3) voxels
    m[(0, slice(10, 13), slice(8, 11)) + z] = 1  # the same size
    m[(0, slice(11, 16), slice(14, 21)) + z] = 1  # larger
    zb = (slice(0, 2),) if dim == 3 else ()
    m[(1, slice(0, 3), slice(0, 4)) + zb] = 1
    m[(1, slice(13, 16), slice(18, 22)) + ((slice(6, 8),) if dim == 3 else ())] = 1
    m[(1, slice(8, 9), slice(21, 22)) + zb] = 1
    return m


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_components", [2, 5])
def test_get_coords_matches_jax(dim, n_components):
    mask = _masks(dim)
    tc, tr = tdet.get_coords(mask, n_components, dim)
    jc, jr = jdet.get_coords(mask, n_components, dim)
    assert len(tc) == len(jc) == 3
    for a, b in zip(tc, jc):
        assert type(a) is type(b)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b == []
    for a, b in zip(tr, jr):
        assert len(a) == len(b)
        for (sa, ma), (sb, mb) in zip(a, b):
            assert sa == sb
            np.testing.assert_array_equal(ma, mb)
    assert len(tr[0]) == min(3, n_components) and tr[2] == []
    # the in-plane clip is to shape[-2] (y's 16): in 2D it cuts the x coords
    # of the components on x's far border (x 17..21 and 20..21) to 16 too
    want = [[12, 16, 16, 16], [0, 0, 3, 4], [7, 16, 9, 16]] if dim == 2 else \
        [[12, 17, 16, 22, 6, 8], [0, 0, 3, 4, 0, 2], [7, 20, 9, 22, 0, 2]]
    assert tc[1].tolist() == want[:n_components]


def _softmax(rng, shape):
    """A smooth random softmax (b, 3, *spatial): components of every class."""
    from scipy import ndimage

    logits = ndimage.gaussian_filter(rng.randn(*shape), sigma=[0, 0] + [2] * (len(shape) - 2)) * 8
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("aggregation", ["max", "median"])
def test_boxes_from_softmax_matches_jax(dim, aggregation):
    cf = make_config(model="detection_unet", dim=dim)
    cf.aggregation_operation = aggregation
    cf.n_roi_candidates = 4
    spatial = (24, 20) + ((8,) if dim == 3 else ())
    smax = _softmax(np.random.RandomState(7 + dim), (2, 3, *spatial))
    tboxes = tbuild(cf, _Log(), device="cpu")._boxes_from_softmax(smax)
    jboxes = jbuild(cf, _Log())._boxes_from_softmax(np.ascontiguousarray(np.moveaxis(smax, 1, -1)))
    assert sum(map(len, jboxes)) > 4
    for tb, jb in zip(tboxes, jboxes):
        assert len(tb) == len(jb)
        for t, j in zip(tb, jb):
            assert t.keys() == j.keys()
            np.testing.assert_array_equal(t["box_coords"], j["box_coords"])
            assert t["box_coords"].dtype == j["box_coords"].dtype
            assert t["box_pred_class_id"] == j["box_pred_class_id"] and t["box_type"] == j["box_type"]
            assert abs(t["box_score"] - j["box_score"]) <= 1e-7


def _config(dim, n_micro=1):
    cf = make_config(model="detection_unet", dim=dim, batch_size=4 if n_micro > 1 else 2)
    cf.grad_accum_steps = n_micro
    cf.fp_dice_weight = 1.5
    cf.wce_weights = [0.5, 1.0, 2.0]
    return cf


@pytest.mark.parametrize("dim", [2, 3])
def test_forward_with_jax_weights_matches_jax(dim):
    """JAX's initialised params, converted into the port: the same softmax,
    and ``jax_params`` gives JAX's tree back."""
    cf = _config(dim)
    jnet = jbuild(cf, _Log())
    jnet.initialize(seed=3)
    params = jax.device_get(jnet.params)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params)
    batch = make_batch(cf, seed=2)
    jsmax = np.asarray(jnet._predict_fn(jnet.params, jnp.asarray(np.moveaxis(batch["data"], 1, -1))))
    with torch.no_grad():
        tsmax = tdet.channel_softmax(tnet.module(torch.from_numpy(batch["data"]))).numpy()
    assert float(np.abs(tsmax - np.moveaxis(jsmax, -1, 1)).max()) <= 1e-5 * float(np.abs(jsmax).max())
    back = convert._flatten(tnet.jax_params())
    flat = convert._flatten(params)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg="/".join(k))


@functools.lru_cache(maxsize=None)
def jax_step(dim, n_micro):
    """JAX's train step from the port's seed-0 weights: (cf, batch, params
    and opt_state before, outputs)."""
    cf = _config(dim, n_micro)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.initialize(seed=0)
    p0 = convert.torch_to_jax(tnet.module.state_dict(), tnet.module)
    jnet = jbuild(cf, _Log())
    batch = make_batch(cf, seed=1)
    params, opt_state = jax.device_put(p0), jnet._optimizer.init(jax.device_put(p0))
    before = jax.device_get((params, opt_state))
    img = jnp.asarray(np.moveaxis(batch["data"], 1, -1))
    out = jnet._train_step_fn(params, opt_state, jnp.float32(LR), img, jnp.asarray(batch["seg"], jnp.int32))
    return cf, batch, before, jax.device_get(out)


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("dim, n_micro", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_train_step_matches_jax(dim, n_micro, monkeypatch):
    """One step of the port from JAX's params and fresh Adam state equals
    JAX's step; in 3D the port's stem takes the plain stem kernels
    (``MDT_STEM_PALLAS=1``), remat on."""
    monkeypatch.setenv("MDT_STEM_PALLAS", "1")
    cf, batch, (params, opt_state), (new_params, new_opt, jloss, jsmax) = jax_step(dim, n_micro)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params, opt_state)
    tnet.current_lr = LR
    loss, smax = tnet._accumulate(*tnet._prep(batch))
    grads = {n: p.grad.clone() for n, p in tnet.module.named_parameters()}
    tnet._update()
    if dim == 3:
        assert tnet.module.fpn.stem0[0].stem_kernel and tnet.module.fpn.stem0[0].remat
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(np.abs(smax.numpy() - np.moveaxis(jsmax, -1, 1)).max()) <= 1e-5

    adam = convert._adam_state(new_opt)
    mu, nu = convert.jax_to_torch(adam.mu, tnet.module), convert.jax_to_torch(adam.nu, tnet.module)
    want_p = convert.jax_to_torch(new_params, tnet.module)
    for name, p in tnet.module.named_parameters():
        rel = 5e-3 if name.startswith(EARLY) else 1e-4
        st = tnet.optimizer.state[p]
        assert _rel_err(grads[name], mu[name] / 0.1) <= rel, name  # optax's first moment is (1 - b1) g
        assert _rel_err(st["exp_avg"], mu[name]) <= rel, name
        assert _rel_err(st["exp_avg_sq"], nu[name]) <= rel, name
        clear = (torch.sign(st["exp_avg"]) == torch.sign(mu[name])) & (mu[name].abs() > 1e-3 * mu[name].abs().max())
        diff = (p.detach() - want_p[name]).abs()
        assert float(torch.where(clear, diff, 0.0).max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR + 1e-6, name

    # the results dict from the same softmax and loss on both sides
    jnet = jbuild(cf, _Log())
    jres = jnet.train_forward_convert((jloss, jsmax), batch)
    tres = tnet.train_forward_convert((loss, torch.from_numpy(np.ascontiguousarray(np.moveaxis(jsmax, -1, 1))),
                                       None), batch)
    assert list(tres) == list(jres)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    np.testing.assert_array_equal(tres["seg_preds"], jres["seg_preds"])
    for tb, jb in zip(tres["boxes"], jres["boxes"]):
        assert [b["box_type"] for b in tb] == [b["box_type"] for b in jb]
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t["box_coords"], j["box_coords"])
            if "box_score" in j:
                assert abs(t["box_score"] - j["box_score"]) <= 1e-7


def test_adam_state_round_trip():
    """JAX's Adam state after a step -> the port's optimizer -> JAX's
    fields again, equal; the step count carries over."""
    cf, _, _, (new_params, new_opt, _, _) = jax_step(2, 1)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(new_params, new_opt)
    assert all(float(tnet.optimizer.state[p]["step"]) == 1 for p in tnet.module.parameters())
    count, mu, nu = convert.torch_adam_to_jax(tnet.optimizer.state_dict(), tnet.module)
    adam = convert._adam_state(new_opt)
    assert int(count) == int(adam.count)
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        g, w = convert._flatten(got), convert._flatten(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


def test_stem_pallas_routes_conv0_to_the_plain_stem(monkeypatch):
    """``MDT_STEM_PALLAS=1``: the 3D Detection U-Net's conv0 (cin 1) takes
    the plain versions of K3/K4 on the CPU: twice K3 (forward and remat
    recompute) and once K4 per train step, K3 once per validation step and
    test forward; no other conv takes them."""
    monkeypatch.setenv("MDT_STEM_PALLAS", "1")
    calls = {"fwd": 0, "wgrad": 0}
    real_fwd, real_wgrad = stem_conv.stem_conv3d, stem_conv.stem_wgrad

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def wgrad(*a, **k):
        calls["wgrad"] += 1
        return real_wgrad(*a, **k)

    monkeypatch.setattr(stem_conv, "stem_conv3d", fwd)
    monkeypatch.setattr(stem_conv, "stem_wgrad", wgrad)
    cf = make_config(model="detection_unet", dim=3, batch_size=2)
    net = tbuild(cf, _Log(), device="cpu")
    net.initialize(seed=0)
    batch = make_batch(cf, seed=0)
    res = net.train_forward(batch)
    assert calls == {"fwd": 2, "wgrad": 1} and np.isfinite(res["loss"])
    net.train_forward(batch, is_validation=True)
    net.test_forward(batch)
    assert calls == {"fwd": 4, "wgrad": 1}
    stems = [m for m in net.module.modules() if isinstance(m, type(net.module.seg_head)) and m.stem_kernel]
    assert stems == [net.module.fpn.stem0[0]]


ENV = {"MDT_DIM": "3", "MDT_MODEL": "detection_unet", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "4",
       "MDT_LIDC_EPOCHS": "2", "MDT_LIDC_NTB": "2", "MDT_LIDC_NVB": "1"}
SMALL = {"start_filts": 4, "end_filts": 8, "n_cv_splits": 4, "n_workers": 1, "plot_prediction_histograms": False}


def test_exec_train_test_and_resume_on_lidc(tmp_path):
    """``exec --mode train_test`` of 3D Detection U-Net on a tiny synthetic
    LIDC set on the CPU: checkpoints, ranking, the test's results; then
    ``--resume_to_checkpoint`` trains a third epoch only."""
    cf = make_lidc_experiment(str(tmp_path), ENV, SMALL, seeds=(), epochs=())
    out = run_lidc_train(cf, "train_test", device="cpu")
    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    files = os.listdir(fold_dir)
    assert {"1_best_checkpoint", "2_best_checkpoint", "last_checkpoint", "epoch_ranking.npy"} <= set(files)
    assert os.path.isfile(os.path.join(cf.exp_dir, "results.txt"))
    assert out["test"]["results"] and all(np.isfinite(v) for ep in out["train"]["monitor_metrics"]["train"]
                                          ["monitor_values"] for m in ep for v in m.values())
    cf = make_lidc_experiment(str(tmp_path), dict(ENV, MDT_LIDC_EPOCHS="3"), SMALL, seeds=(), epochs=())
    resumed = run_lidc_train(cf, "train", device="cpu", resume=os.path.join(fold_dir, "last_checkpoint"))
    assert sorted(resumed["times"]["epoch_s"]) == [3]


def test_build_model_loads_the_exp_dirs_snapshot(tmp_path):
    """An exp dir's model and backbone snapshots win over the installed
    modules; the installed registry and modules are restored after."""
    import sys

    cf = make_lidc_experiment(str(tmp_path), ENV, SMALL, seeds=(), epochs=())
    assert cf.model_source_path == os.path.join(cf.exp_dir, "model.py")
    installed = tbuild(cf, _Log(), device="cpu")
    assert type(installed) is tdet.DetectionUNetDetector  # an unchanged snapshot is the installed code
    with open(cf.model_source_path, "a") as handle:
        handle.write("\nDetectionUNetDetector.frozen_marker = 'model'\n")
    with open(cf.backbone_source_path, "a") as handle:
        handle.write("\nFPN.frozen_marker = 'backbone'\n")
    backbone = sys.modules["medicaldetectiontoolkit_torch.models.backbone"]
    net = tbuild(cf, _Log(), device="cpu")
    assert type(net).frozen_marker == "model" and type(net) is not tdet.DetectionUNetDetector
    assert net.module.fpn.frozen_marker == "backbone"
    assert sys.modules["medicaldetectiontoolkit_torch.models.backbone"] is backbone
    assert not hasattr(backbone.FPN, "frozen_marker")
    assert tmodels._REGISTRY["detection_unet"] is tdet.DetectionUNetDetector
    assert sorted(tmodels._REGISTRY) == ["detection_unet", "mrcnn", "retina_net", "retina_unet", "ufrcnn"]
    net.load_params(installed.jax_params())  # the same param layout


def test_without_card_exec_raises_unless_cpu(tmp_path, monkeypatch):
    """Without a visible card ``exec``'s train mode raises for Detection
    U-Net instead of running on the CPU; ``device="cpu"`` runs it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cf = make_lidc_experiment(str(tmp_path), dict(ENV, MDT_LIDC_EPOCHS="1", MDT_LIDC_NTB="1"), SMALL, seeds=(),
                              epochs=())
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        run_lidc_train(cf, "train", device=None)
    assert sorted(run_lidc_train(cf, "train", device="cpu")["times"]["epoch_s"]) == [1]
