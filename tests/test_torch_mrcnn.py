"""Port Mask R-CNN inference against the JAX detector on the CPU.

Tolerances:
  * heads fed the same inputs from converted params: within 1e-4 * max|ref|
    (float32 convs and matmuls summed in another order); the mask head's
    sigmoid probabilities within 1e-5 absolute;
  * ``proposal_layer`` fed the same RPN outputs: keep slots and scores
    exactly (the same top-k tie order and NMS); boxes within 1e-6 relative
    plus 1e-6 (normalised) or 1e-4 (pixels) absolute, since the decode's
    ``exp`` comes from another math library and may differ in the last bit;
  * ``refine_detections`` fed the same inputs: coords, classes, scores and
    masks exactly (decoded boxes are rounded to whole pixels);
  * full ``test_forward`` from converted params: RPN heads within 1e-4 *
    max|ref|; detections equal in coords and class, scores within 1e-5;
    ``seg_preds`` (the union of the unmolded masks) equal, at these seeds;
  * chunked against unchunked second stage: within 1e-5 absolute (the
    classifier's convs and matmuls on another batch size), RoIs exactly;
  * through the ``Predictor`` in test mode: as ``test_forward``, per box.
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
from medicaldetectiontoolkit_tpu.predictor import Predictor  # noqa: E402
from medicaldetectiontoolkit_tpu.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.models import mrcnn as tmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch.ops.anchors import generate_pyramid_anchors  # noqa: E402

torch.set_num_threads(2)


class _Log:
    def info(self, *a, **k):
        pass


@functools.lru_cache(maxsize=None)
def nets(model, dim):
    """(cf, JAX detector, port detector on the CPU) sharing converted params."""
    cf = make_config(model=model, dim=dim, retina_scales=False)
    jnet = jbuild(cf, _Log())
    jnet.initialize(seed=dim)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(jax.device_get(jnet.params))
    return cf, jnet, tnet


def cl(t):
    """port channel-first (n, c, *sp) -> JAX channel-last numpy."""
    return np.moveaxis(t.numpy(), 1, -1)


def assert_rel(got, want, rel=1e-4):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("dim", [2, 3])
def test_heads_match_jax(dim):
    cf, jnet, tnet = nets("mrcnn", dim)
    params = jnet.params
    m = tnet.module
    rng = np.random.RandomState(dim)
    kw = dict(dim=dim, relu=cf.relu, weight_init=cf.weight_init)

    x = rng.randn(2, cf.end_filts, *(8, 8, 4)[:dim]).astype(np.float32)
    jl, jd = jmrcnn.RPNHead(n_features=cf.n_rpn_features, n_anchors_per_pos=3, **kw).apply(
        {"params": params["rpn"]}, jnp.asarray(np.moveaxis(x, 1, -1)))
    with torch.inference_mode():
        tl, td = m.rpn(torch.from_numpy(x))
    assert_rel(tl.numpy(), np.asarray(jl))
    assert_rel(td.numpy(), np.asarray(jd))

    head = dict(end_filts=cf.end_filts, head_classes=cf.head_classes, norm=cf.norm, **kw)
    pooled = rng.rand(5, cf.end_filts, *cf.pool_size).astype(np.float32)
    jlog, jbox = jmrcnn.ClassifierHead(pool_size=tuple(cf.pool_size), **head).apply(
        {"params": params["classifier"]}, jnp.asarray(np.moveaxis(pooled, 1, -1)))
    with torch.inference_mode():
        tlog, tbox = m.classifier(torch.from_numpy(pooled))
    assert_rel(tlog.numpy(), np.asarray(jlog))
    assert_rel(tbox.numpy(), np.asarray(jbox))

    pooled = rng.rand(3, cf.end_filts, *cf.mask_pool_size).astype(np.float32)
    jmask = jmrcnn.MaskHead(**head).apply({"params": params["mask"]}, jnp.asarray(np.moveaxis(pooled, 1, -1)))
    with torch.inference_mode():
        tmask = m.mask(torch.from_numpy(pooled))
    assert tmask.shape == (3, cf.head_classes, *cf.mask_shape)
    np.testing.assert_allclose(cl(tmask), np.asarray(jmask), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_proposal_layer_same_inputs(dim):
    cf = make_config(model="mrcnn", dim=dim, retina_scales=False)
    anchors = generate_pyramid_anchors(cf).to(torch.float32).numpy()
    rng = np.random.RandomState(10 + dim)
    A = anchors.shape[0]
    # fg probabilities on a 1/64 grid: many ties, so the top-k tie order counts
    probs = (np.round(rng.rand(2, A) * 64) / 64).astype(np.float32)
    deltas = (rng.randn(2, A, 2 * dim) * 0.5).astype(np.float32)
    P = cf.post_nms_rois_inference
    want = jax.jit(lambda p, d, a: jmrcnn.proposal_layer(p, d, a, cf, P))(probs, deltas, jnp.asarray(anchors))
    got = tmrcnn.proposal_layer(torch.from_numpy(probs), torch.from_numpy(deltas), torch.from_numpy(anchors), cf, P)
    (jn, jo, jv), (tn, to, tv) = [np.asarray(w) for w in want], [g.numpy() for g in got]
    assert tn.shape == jn.shape == (2, P, 2 * dim) and to.shape == jo.shape and tv.dtype == bool
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() > P // 2
    np.testing.assert_array_equal(to[..., -1], jo[..., -1])
    np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to[..., :-1], jo[..., :-1], rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_refine_detections_same_inputs(dim):
    cf = make_config(model="mrcnn", dim=dim, retina_scales=False)
    rng = np.random.RandomState(20 + dim)
    bsz, P, C = 2, 40, cf.head_classes
    R = bsz * P
    lo = rng.rand(R, dim) * 0.7
    hi = lo + rng.rand(R, dim) * 0.3
    rois = np.concatenate([lo[:, :2], hi[:, :2]] + ([lo[:, 2:], hi[:, 2:]] if dim == 3 else []), 1).astype(np.float32)
    rois[-5:] = 0.0  # padded proposal slots: zero boxes, refined like the rest
    logits = (np.round(rng.randn(R, C) * 8) / 4).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    deltas = (rng.randn(R, C, 2 * dim) * 0.2).astype(np.float32)
    bix = np.repeat(np.arange(bsz, dtype=np.int32), P)
    jdet, jmask = jax.jit(lambda r, p, d, b: jmrcnn.refine_detections(r, p, d, b, cf, bsz))(rois, probs, deltas, bix)
    tdet, tmask = tmrcnn.refine_detections(torch.from_numpy(rois), torch.from_numpy(probs),
                                           torch.from_numpy(deltas), torch.from_numpy(bix), cf, bsz)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tdet.numpy(), np.asarray(jdet))
    assert tmask.sum() > 0


def assert_box_lists_match(tboxes, jboxes, score_atol=1e-5):
    assert len(tboxes) == len(jboxes)
    for tb, jb in zip(tboxes, jboxes):
        assert len(tb) == len(jb)
        for t, j in zip(tb, jb):
            assert set(t) == set(j)
            np.testing.assert_array_equal(t["box_coords"], j["box_coords"])
            assert abs(t["box_score"] - j["box_score"]) <= score_atol
            for k in set(t) - {"box_coords", "box_score"}:
                assert t[k] == j[k], (k, t[k], j[k])


def check_test_forward(model, dim, return_masks, seed=11):
    cf, jnet, tnet = nets(model, dim)
    batch = make_batch(cf, seed=seed)
    img = jnp.asarray(np.moveaxis(batch["data"], 1, -1))
    jmaps, jlog, jdel, jseg = jnet.module.apply({"params": jnet.params}, img, method=jnet.module.extract)
    with torch.inference_mode():
        tmaps, tlog, tdel, tseg = tnet.module.extract(torch.from_numpy(batch["data"]))
    assert_rel(tlog.numpy(), np.asarray(jlog))
    assert_rel(tdel.numpy(), np.asarray(jdel))
    for t, j in zip(tmaps, jmaps):
        assert_rel(cl(t), np.asarray(j))
    if jseg is None:
        assert tseg is None
    else:
        assert_rel(cl(tseg), np.asarray(jseg))

    jres = jnet.test_forward(batch, return_masks=return_masks)
    tres = tnet.test_forward(batch, return_masks=return_masks)
    assert tres["seg_preds"].shape == jres["seg_preds"].shape == (cf.batch_size, 1, *cf.patch_size)
    assert tres["seg_preds"].dtype == jres["seg_preds"].dtype
    np.testing.assert_array_equal(tres["seg_preds"], jres["seg_preds"])
    assert sum(len(b) for b in tres["boxes"]) > 0
    assert_box_lists_match(tres["boxes"], jres["boxes"])
    return jres, tres


@pytest.mark.parametrize("return_masks", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_test_forward_matches_jax(dim, return_masks):
    jres, tres = check_test_forward("mrcnn", dim, return_masks)
    if return_masks:
        assert tres["seg_preds"].dtype == np.uint8 and tres["seg_preds"].sum() > 0
    else:
        assert tres["seg_preds"].dtype == np.float32 and not tres["seg_preds"].any()


def test_handles_carry_masks_on_the_device():
    cf, _, tnet = nets("mrcnn", 2)
    batch = make_batch(cf, seed=3)
    with_masks, (det, det_mask, masks, seg) = tnet.test_forward_dispatch(batch)
    assert with_masks and seg is None
    max_inst = cf.model_max_instances_per_batch_element
    assert det.shape == (cf.batch_size, max_inst, 6) and det_mask.shape == (cf.batch_size, max_inst)
    assert masks.shape == (cf.batch_size, max_inst, cf.head_classes, *cf.mask_shape)
    with_masks, (_, _, masks, seg) = tnet.test_forward_dispatch(batch, return_masks=False)
    assert not with_masks and masks is None and seg is None


def test_second_stage_chunking_matches_unchunked():
    cf, _, tnet = nets("mrcnn", 2)
    img = torch.from_numpy(np.random.RandomState(0).rand(cf.batch_size, 1, *cf.patch_size).astype(np.float32))
    saved = cf.roi_chunk_size
    try:
        with torch.inference_mode():
            maps, rpn_logits, rpn_deltas, _ = tnet.module.extract(img)
            rois, _, _ = tnet._proposals(rpn_logits, rpn_deltas)
            cf.roi_chunk_size = None
            ref = tnet._second_stage_all(maps, rois)
            cf.roi_chunk_size = 32  # does not divide R = 100: the padded path
            got = tnet._second_stage_all(maps, rois)
    finally:
        cf.roi_chunk_size = saved
    for r, g in zip(ref[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-5)
    for r, g in zip(ref[2:], got[2:]):
        assert torch.equal(r, g)


def test_predictor_test_mode_matches_jax(tmp_path):
    """Patched 2D patient, more patches than batch_size, mirror TTA, masks
    returned: the Predictor's pipelined dispatch/convert tiling over the port."""
    cf, jnet, tnet = nets("mrcnn", 2)
    cf.fold_dir = str(tmp_path)
    cf.fold = 0
    cf.test_n_epochs = 1
    cf.test_aug = True
    cf.return_masks_in_test = True
    np.save(os.path.join(cf.fold_dir, "epoch_ranking.npy"), np.array([1]))

    ps = cf.patch_size
    full = np.random.RandomState(3).rand(2, 1, 96, 96).astype(np.float32)  # (slices, c, y, x)
    crops = [[y, y + ps[0], x, x + ps[1], z, z + 1] for z in range(2) for y in (0, 32) for x in (0, 32)]
    data = np.stack([full[c[4], :, c[0]:c[1], c[2]:c[3]] for c in crops])
    assert data.shape[0] > cf.batch_size

    def run(net):
        batch = {"data": data.copy(), "pid": "p0", "original_img_shape": full.shape, "patch_crop_coords": crops}
        return Predictor(cf, net, _Log(), mode="test").predict_patient(batch)

    try:
        jres, tres = run(jnet), run(tnet)
    finally:
        cf.return_masks_in_test = False
    np.testing.assert_array_equal(tres["seg_preds"], jres["seg_preds"])
    assert sum(len(b) for b in tres["boxes"]) > 0
    assert_box_lists_match(tres["boxes"], jres["boxes"])
