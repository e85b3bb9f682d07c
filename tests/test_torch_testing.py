"""The port's ``testing`` helpers against the JAX package's.

Tolerance: exact. ``make_config`` must give the JAX values for every
attribute it sets, ``make_batch`` the same arrays from the same seed, and a
detector built from either config must give the same results on the same
weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from medicaldetectiontoolkit_tpu import testing as jtesting  # noqa: E402
from medicaldetectiontoolkit_torch import testing as ttesting  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model  # noqa: E402

torch.set_num_threads(2)

CASES = [
    dict(model="retina_net", dim=2),
    dict(model="retina_unet", dim=2, retina_scales=False),
    dict(model="retina_unet", dim=3),
    dict(model="retina_net", dim=3, patch_size=[32, 64, 16], start_filts=6, end_filts=12, batch_size=3),
]


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("kwargs", CASES)
def test_make_config_matches_jax(kwargs):
    tcf, jcf = ttesting.make_config(**kwargs), jtesting.make_config(**kwargs)
    for name, value in vars(tcf).items():
        assert _equal(value, getattr(jcf, name)), name


def test_slice_config_is_the_bench_geometry():
    cf = ttesting.make_slice_config("bfloat16")
    assert (cf.model, cf.dim, cf.patch_size, cf.start_filts, cf.end_filts, cf.batch_size) == (
        "retina_unet", 3, [128, 128, 64], 18, 36, 8)
    assert (cf.n_rpn_features, cf.pre_nms_limit, cf.model_max_instances_per_batch_element) == (64, 50000, 30)
    assert cf.compute_dtype == "bfloat16" and cf.operate_stride1 and cf.n_anchors_per_pos == 9
    assert ttesting.make_slice_config().compute_dtype == "float32"


@pytest.mark.parametrize("kwargs", CASES)
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_matches_jax(kwargs, seed):
    tb = ttesting.make_batch(ttesting.make_config(**kwargs), seed=seed)
    jb = jtesting.make_batch(jtesting.make_config(**kwargs), seed=seed)
    for key, value in tb.items():
        assert _equal(value, jb[key]), key


class _Log:
    def info(self, *a, **k):
        pass


@pytest.mark.parametrize("model,dim", [("retina_unet", 2), ("retina_net", 3)])
def test_detector_from_either_config_agrees(model, dim):
    tcf, jcf = ttesting.make_config(model=model, dim=dim), jtesting.make_config(model=model, dim=dim)
    a, b = build_model(tcf, _Log(), device="cpu"), build_model(jcf, _Log(), device="cpu")
    a.initialize(seed=3)
    b.load_state_dict(a.state_dict())
    torch.testing.assert_close(a.anchors, b.anchors, rtol=0, atol=0)
    batch = ttesting.make_batch(tcf, seed=1)
    ra, rb = a.test_forward(batch), b.test_forward(batch)
    np.testing.assert_array_equal(ra["seg_preds"], rb["seg_preds"])
    assert _equal(ra["boxes"], rb["boxes"])
