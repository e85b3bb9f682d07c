"""The port's one-stage losses and SHEM against the JAX package's
(``jax.vmap`` over the batch where JAX takes one element), fed JAX's own
uniform draws.

Tolerances: the SHEM selections and masks exactly (ties included: every
top-k breaks them toward the lower index); loss values within 1e-5 relative
(the same float32 operations, ``exp``/``log`` and sums from other
libraries).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.ops import losses as jl  # noqa: E402
from medicaldetectiontoolkit_torch.ops import losses as tl  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got.numpy() if hasattr(got, "numpy") else got, np.asarray(want), rtol=rtol, atol=1e-6)


def test_elementwise_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 50, 3) * 3).astype(np.float32)
    labels = rng.randint(-1, 4, (2, 50)).astype(np.int32)  # -1 and 3 are outside [0, 3): zero loss
    _close(tl.softmax_ce(_t(logits), _t(labels)), jl.softmax_ce(logits, labels))
    assert (tl.softmax_ce(_t(logits), _t(labels))[(_t(labels) < 0) | (_t(labels) > 2)] == 0).all()
    pred, target = rng.randn(2, 50, 6).astype(np.float32) * 2, rng.randn(2, 50, 6).astype(np.float32)
    _close(tl.smooth_l1(_t(pred), _t(target)), jl.smooth_l1(pred, target))
    mask = rng.rand(3, 50, 6) < 0.3
    mask[1] = False  # an empty mask: the default
    values = rng.randn(3, 50, 6).astype(np.float32)
    _close(tl.masked_mean(_t(values), _t(mask)), jax.vmap(jl.masked_mean)(values, mask))
    _close(tl.softmax(_t(logits)), jax.nn.softmax(logits, axis=-1))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n_pos,max_count,poolsize", [((3, 0, 40), 8, 4), ((1, 5, 2), 16, 10), ((30, 2, 4), 6, 3)])
def test_shem_select_matches_jax(n_pos, max_count, poolsize, ties):
    rng = np.random.RandomState(max_count)
    N = 300
    scores = rng.rand(3, N).astype(np.float32)
    if ties:  # a saturated softmax: few distinct scores
        scores = np.round(scores * 4) / 4
    neg_mask = rng.rand(3, N) < 0.5
    neg_mask[2, 20:] = False  # fewer negatives than the pool
    n_pos = np.asarray(n_pos, np.int32)
    keys = jax.random.split(jax.random.PRNGKey(max_count), 3)
    want = jax.vmap(lambda r, s, m, n: jl.shem_select(r, s, m, n, max_count, poolsize))(keys, scores, neg_mask, n_pos)
    k_pool = min(poolsize * max_count, N)
    rand = jax.vmap(lambda r: jax.random.uniform(r, (k_pool,)))(keys)
    got = tl.shem_select(_t(rand), _t(scores), _t(neg_mask), _t(n_pos), max_count, poolsize)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum() > 0


@pytest.mark.parametrize("saturated", [False, True])
def test_anchor_losses_match_jax(saturated):
    rng = np.random.RandomState(1)
    A, C, bsz = 400, 3, 2
    logits = (rng.randn(bsz, A, C) * (40 if saturated else 2)).astype(np.float32)
    matches = rng.choice([-1, -1, -1, 0, 1, 2], size=(bsz, A)).astype(np.int32)
    tdeltas = (rng.randn(bsz, A, 6) * (matches > 0)[..., None]).astype(np.float32)
    pdeltas = rng.randn(bsz, A, 6).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), bsz)
    poolsize, max_neg = 10, 16
    jloss, jsel = jax.vmap(lambda r, m, c: jl.anchor_class_loss(r, m, c, poolsize, max_neg))(keys, matches, logits)
    rand = jax.vmap(lambda r: jax.random.uniform(r, (min(poolsize * max_neg, A),)))(keys)
    tloss, tsel = tl.anchor_class_loss(_t(rand), _t(matches), _t(logits), poolsize, max_neg)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    _close(tloss, jloss)
    _close(tl.anchor_bbox_loss(_t(tdeltas), _t(pdeltas), _t(matches)),
           jax.vmap(jl.anchor_bbox_loss)(tdeltas, pdeltas, matches))


@pytest.mark.parametrize("spatial,n_classes", [((16, 12), 2), ((8, 6, 4), 2), ((8, 6, 4), 3)])
def test_fused_seg_loss_matches_jax(spatial, n_classes):
    rng = np.random.RandomState(len(spatial) + n_classes)
    logits = (rng.randn(2, n_classes, *spatial) * 2).astype(np.float32)  # the port's channel-first layout
    seg = rng.randint(0, n_classes, (2, 1, *spatial)).astype(np.int32)
    jdice, jce = jl.fused_seg_loss(jnp.asarray(np.moveaxis(logits, 1, -1)), seg, n_classes)
    tdice, tce = tl.fused_seg_loss(_t(logits), _t(seg), n_classes)
    _close(tdice, jdice)
    _close(tce, jce)
