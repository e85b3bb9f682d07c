"""The port's anchor matching against ``jax.vmap`` of the JAX package's
``gt_anchor_matching``, fed JAX's own uniform draws.

Tolerances: matches exactly; delta targets within 1e-6 absolute (the same
float32 operations, ``log`` from another math library). The GTs of an
element have distinct best anchors, since the order in which XLA's scatter
writes duplicate indices is unspecified.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.ops.matching import gt_anchor_matching as jmatch  # noqa: E402
from medicaldetectiontoolkit_torch.ops import boxes as box_ops  # noqa: E402
from medicaldetectiontoolkit_torch.ops.anchors import generate_pyramid_anchors  # noqa: E402
from medicaldetectiontoolkit_torch.ops.matching import gt_anchor_matching  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_config  # noqa: E402

torch.set_num_threads(2)


def _gts(rng, dim, ps, bsz, G, n_valid):
    """(b, G, 2*dim) boxes, class ids in {1, 2}, valid masks: n_valid[b]
    random boxes per element, the rest zero padding."""
    boxes = np.zeros((bsz, G, 2 * dim), np.float32)
    ids = np.zeros((bsz, G), np.int32)
    valid = np.zeros((bsz, G), bool)
    for b, n in enumerate(n_valid):
        for g in range(n):
            lo = rng.uniform(0, 0.7, dim) * np.asarray(ps)
            hi = lo + rng.uniform(0.08, 0.3, dim) * np.asarray(ps)
            cols = [lo[0], lo[1], hi[0], hi[1]] + ([lo[2], hi[2]] if dim == 3 else [])
            boxes[b, g] = np.round(cols)
            ids[b, g] = rng.randint(1, 3)
            valid[b, g] = True
    return boxes, ids, valid


@pytest.mark.parametrize("dim,max_pos,G,n_valid", [
    (2, 32, 8, (3, 0, 8)),     # an element without GTs; G = one chunk
    (2, 6, 12, (5, 12, 1)),    # heavy positive subsampling; two GT chunks
    (3, 32, 8, (2, 4, 0)),
    (3, 4, 10, (3, 9, 1)),
])
def test_matching_matches_jax(dim, max_pos, G, n_valid):
    cf = make_config(model="retina_net", dim=dim)
    anchors = generate_pyramid_anchors(cf).to(torch.float32)
    A = anchors.shape[0]
    rng = np.random.RandomState(dim * 10 + G)
    boxes, ids, valid = _gts(rng, dim, cf.patch_size, len(n_valid), G, n_valid)
    # distinct best anchors per element (see the module docstring)
    best = torch.argmax(box_ops.pairwise_iou(anchors, torch.from_numpy(boxes)), dim=1).numpy()
    for b, n in enumerate(n_valid):
        assert len(set(best[b, :n])) == n
    std = np.asarray(cf.rpn_bbox_std_dev, np.float32)
    neg_iou = 0.1 if dim == 2 else 0.01

    keys = jax.random.split(jax.random.PRNGKey(G), len(n_valid))
    jm, jd = jax.vmap(lambda r, gb, gi, gv: jmatch(r, jnp.asarray(anchors.numpy()), gb, gi, gv, 0.5, neg_iou,
                                                   max_pos, std))(keys, boxes, ids, valid)
    rand = np.array(jax.vmap(lambda r: jax.random.uniform(r, (A,)))(keys))

    tm, td = gt_anchor_matching(torch.from_numpy(rand), anchors, torch.from_numpy(boxes), torch.from_numpy(ids),
                                torch.from_numpy(valid), 0.5, neg_iou, max_pos, torch.from_numpy(std))
    assert tm.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    n_pos = (tm > 0).sum(1).numpy()
    assert (n_pos <= max_pos // 2).all() and n_pos.max() > 0
    for b, n in enumerate(n_valid):
        if n == 0:
            assert (tm[b] == -1).all()
