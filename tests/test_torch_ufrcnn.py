"""Port U-Faster R-CNN+ inference against the JAX detector on the CPU.

Tolerances, as ``tests/test_torch_mrcnn.py``: RPN heads, pyramid maps and
the P0 seg logits within 1e-4 * max|ref| (float32 convs summed in another
order); detections equal in coords and class, scores within 1e-5;
``seg_preds`` (the argmax of the seg head) equal, at these seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from medicaldetectiontoolkit_torch.testing import make_batch  # noqa: E402
from test_torch_mrcnn import check_test_forward, nets  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("dim", [2, 3])
def test_test_forward_matches_jax(dim):
    jres, tres = check_test_forward("ufrcnn", dim, return_masks=True)
    assert tres["seg_preds"].dtype == np.uint8
    assert tres["seg_preds"].max() > 0  # three seg classes, argmaxed


@pytest.mark.parametrize("dim", [2, 3])
def test_no_mask_head_and_a_float32_seg_head(dim):
    """frcnn_mode drops the mask head; the seg head runs in float32 whatever
    the compute dtype; masks are never returned."""
    cf, _, tnet = nets("ufrcnn", dim)
    assert tnet.module.mask is None and tnet.module.final_conv.dtype == torch.float32
    with_masks, (_, _, masks, seg) = tnet.test_forward_dispatch(make_batch(cf, seed=2), return_masks=True)
    assert with_masks and masks is None
    assert seg.dtype == torch.uint8 and seg.shape == (cf.batch_size, 1, *cf.patch_size)
