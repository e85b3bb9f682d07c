"""Port RetinaNet / Retina U-Net inference against the JAX detectors on the CPU.

Tolerances:
  * ``refine_detections`` fed the same head outputs: boxes, classes and
    masks exactly; scores within 1e-6 (softmax ``exp`` from another math
    library may differ in the last bit);
  * full ``test_forward`` from converted params: head outputs within
    1e-4 * max|ref| (float32 convs summed in another order); seg_preds equal;
    detections equal in coords and class at these fixed seeds, scores within
    1e-5 (the head differences, through the softmax);
  * through the ``Predictor`` in test mode: the same, per box.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.models.retina_net import refine_detections as jrefine  # noqa: E402
from medicaldetectiontoolkit_tpu.predictor import Predictor  # noqa: E402
from medicaldetectiontoolkit_tpu.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.models.retina_net import refine_detections as trefine  # noqa: E402
from medicaldetectiontoolkit_torch.ops.anchors import generate_pyramid_anchors  # noqa: E402

torch.set_num_threads(2)


class _Log:
    def info(self, *a, **k):
        pass


@functools.lru_cache(maxsize=None)
def nets(model, dim):
    """(cf, JAX detector, port detector on the CPU) sharing converted params."""
    cf = make_config(model=model, dim=dim)
    jnet = jbuild(cf, _Log())
    jnet.initialize(seed=dim)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(jax.device_get(jnet.params))
    return cf, jnet, tnet


@pytest.mark.parametrize("dim,pre_nms_limit", [(2, 500), (2, 10**6), (3, 500)])
def test_refine_detections_same_heads(dim, pre_nms_limit):
    cf = make_config(model="retina_net", dim=dim)
    cf.pre_nms_limit = pre_nms_limit
    anchors = generate_pyramid_anchors(cf).to(torch.float32).numpy()
    rng = np.random.RandomState(dim)
    A = anchors.shape[0]
    # logits on a 0.25 grid: many exactly tied probabilities, so the top-k
    # tie order (lower flat index first) is exercised
    logits = (np.round(rng.randn(2, A, cf.head_classes) * 8) / 4).astype(np.float32)
    deltas = (rng.randn(2, A, 2 * dim) * 0.2).astype(np.float32)

    jdet, jmask = jax.jit(lambda a, c, d: jrefine(a, c, d, cf))(jnp.asarray(anchors), logits, deltas)
    tdet, tmask = trefine(torch.from_numpy(anchors), torch.from_numpy(logits), torch.from_numpy(deltas), cf)
    jdet, jmask, tdet, tmask = np.asarray(jdet), np.asarray(jmask), tdet.numpy(), tmask.numpy()
    assert tdet.shape == jdet.shape and tmask.dtype == bool
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(tdet[..., : 2 * dim + 1], jdet[..., : 2 * dim + 1])
    np.testing.assert_allclose(tdet[..., -1], jdet[..., -1], rtol=0, atol=1e-6)
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


@pytest.mark.parametrize("model,dim", [("retina_net", 2), ("retina_unet", 2), ("retina_net", 3), ("retina_unet", 3)])
def test_test_forward_matches_jax(model, dim):
    cf, jnet, tnet = nets(model, dim)
    batch = make_batch(cf, seed=11)
    jheads = jnet._predict_fn(jnet.params, jnp.asarray(np.moveaxis(batch["data"], 1, -1)))
    with torch.inference_mode():
        theads = tnet._predict(torch.from_numpy(batch["data"]))
    for jh, th in zip(jheads, theads):
        if jh is None:
            assert th is None
            continue
        th = th.numpy() if th.dim() == 3 else np.moveaxis(th.numpy(), 1, -1)  # seg logits: channel-first
        jh = np.asarray(jh)
        assert th.shape == jh.shape
        assert np.abs(th - jh).max() <= 1e-4 * np.abs(jh).max()

    jres, tres = jnet.test_forward(batch), tnet.test_forward(batch)
    assert tres["seg_preds"].shape == jres["seg_preds"].shape == (2, 1, *cf.patch_size)
    assert tres["seg_preds"].dtype == jres["seg_preds"].dtype
    np.testing.assert_array_equal(tres["seg_preds"], jres["seg_preds"])
    assert sum(len(b) for b in tres["boxes"]) > 0
    assert_box_lists_match(tres["boxes"], jres["boxes"])


def test_predictor_test_mode_matches_jax(tmp_path):
    """Patched 2D patient, more patches than batch_size, mirror TTA: the
    Predictor's pipelined dispatch/convert tiling over the port."""
    cf, jnet, tnet = nets("retina_unet", 2)
    cf.fold_dir = str(tmp_path)
    cf.fold = 0
    cf.test_n_epochs = 1
    cf.test_aug = True
    np.save(os.path.join(cf.fold_dir, "epoch_ranking.npy"), np.array([1]))

    ps = cf.patch_size
    full = np.random.RandomState(3).rand(2, 1, 96, 96).astype(np.float32)  # (slices, c, y, x)
    crops = [[y, y + ps[0], x, x + ps[1], z, z + 1] for z in range(2) for y in (0, 32) for x in (0, 32)]
    data = np.stack([full[c[4], :, c[0]:c[1], c[2]:c[3]] for c in crops])
    assert data.shape[0] > cf.batch_size

    def run(net):
        batch = {"data": data.copy(), "pid": "p0", "original_img_shape": full.shape, "patch_crop_coords": crops}
        return Predictor(cf, net, _Log(), mode="test").predict_patient(batch)

    jres, tres = run(jnet), run(tnet)
    np.testing.assert_array_equal(tres["seg_preds"], jres["seg_preds"])
    assert sum(len(b) for b in tres["boxes"]) > 0
    assert_box_lists_match(tres["boxes"], jres["boxes"])
