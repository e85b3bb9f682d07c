"""The port's differentiable pyramid RoIAlign against JAX's on the CPU.

``PyramidRoIAlign`` (on CPU tensors: the plain forward and the plain
backward, ``pyramid_roi_align_backward_plain``) against ``jax.vjp`` of the
JAX package's ``pyramid_roi_align`` (on the CPU its XLA form, whose custom
VJP is the autodiff of that form), on the same maps, boxes and cotangent.
The cases cover 2D and 3D, RoIs on every level, level indices -1 and
n_levels (zero crops, zero gradient), boxes past the map (clamped
coordinates, where both corners are one voxel), zero-size boxes and crop 1
(the centre formula).

Tolerances, relative to the max |gradient| of each level:
  * float32: 1e-5 (the same scatter-adds of the same float32 products,
    summed in another order);
  * bfloat16 maps: 1e-2. Both sides accumulate each level's gradient in
    bfloat16 (JAX's scatter-add in the maps' dtype; torch's index_put on a
    bf16 tensor likewise), in another order: sums near a rounding boundary
    land one bf16 ulp (2^-8 of the value) apart, and a few such steps add up.
The forward crops agree within 1e-5 of their max (float32 in both; XLA:CPU
may contract a lerp's multiply and add, as ``tests/test_torch_roi_align.py``
states).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.ops import roi_align_pallas as jpallas  # noqa: E402
from medicaldetectiontoolkit_torch.ops import roi_align as troi  # noqa: E402

torch.set_num_threads(2)


def _case(dim, seed, C=3, B=2, L=3, R=12):
    """Maps (channel-first numpy) of L levels halving from 16 (z from 8), and
    R RoIs: random boxes on every level, two boxes past the map, a zero-size
    box, and level indices -1 and L."""
    rng = np.random.RandomState(seed)
    maps = []
    for lvl in range(L):
        sp = [16 >> lvl, 12 >> lvl] + ([max(8 >> lvl, 1)] if dim == 3 else [])
        maps.append(rng.randn(B, C, *sp).astype(np.float32))
    lo = rng.rand(R, dim) * 0.6
    hi = lo + 0.05 + rng.rand(R, dim) * 0.4
    boxes = np.zeros((R, 2 * dim), np.float32)
    boxes[:, [0, 1] + ([4] if dim == 3 else [])] = lo
    boxes[:, [2, 3] + ([5] if dim == 3 else [])] = hi
    boxes[0, :] = [-0.3, -0.2, 1.4, 1.3] + ([-0.5, 1.2] if dim == 3 else [])  # clamped on every side
    boxes[1, :] = [0.95, 0.9, 1.2, 1.1] + ([0.9, 1.3] if dim == 3 else [])  # past the far edge
    boxes[2, 2], boxes[2, 3] = boxes[2, 0], boxes[2, 1]  # zero size in y and x
    bix = rng.randint(0, B, R).astype(np.int32)
    levels = (np.arange(R) % L).astype(np.int32)
    levels[3], levels[4] = -1, L
    return maps, boxes, bix, levels


def _jax_vjp(maps, boxes, bix, levels, crop, cot, dtype=jnp.float32):
    fms = [jnp.asarray(np.moveaxis(m, 1, -1), dtype) for m in maps]
    out, vjp = jax.vjp(lambda f: jpallas.pyramid_roi_align(f, jnp.asarray(boxes), jnp.asarray(bix),
                                                           jnp.asarray(levels), crop), fms)
    (grads,) = vjp(jnp.asarray(np.moveaxis(cot, 1, -1)))
    return np.moveaxis(np.asarray(out), -1, 1), [np.moveaxis(np.asarray(g.astype(jnp.float32)), -1, 1) for g in grads]


def _port_grad(maps, boxes, bix, levels, crop, cot, dtype=torch.float32):
    fms = [torch.from_numpy(m).to(dtype).requires_grad_() for m in maps]
    out = troi.pyramid_roi_align_auto(fms, torch.from_numpy(boxes), torch.from_numpy(bix),
                                      torch.from_numpy(levels), crop)
    grads = torch.autograd.grad(out, fms, torch.from_numpy(cot))
    assert all(g.dtype == dtype and g.shape == f.shape for g, f in zip(grads, fms))
    return out.detach().numpy(), [g.float().numpy() for g in grads]


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("dim,crop", [(2, (5, 4)), (2, (1, 1)), (3, (4, 3, 2)), (3, (7, 1, 3)), (3, (1, 1, 1))])
def test_backward_matches_jax_vjp(dim, crop):
    maps, boxes, bix, levels = _case(dim, seed=dim + sum(crop))
    cot = np.random.RandomState(7).randn(len(boxes), maps[0].shape[1], *crop).astype(np.float32)
    j_out, j_grads = _jax_vjp(maps, boxes, bix, levels, crop, cot)
    t_out, t_grads = _port_grad(maps, boxes, bix, levels, crop, cot)
    assert t_out.dtype == np.float32 and _rel(t_out, j_out) <= 1e-5
    assert not t_out[[3, 4]].any()  # no level: zeros
    for t, j in zip(t_grads, j_grads):
        assert float(np.abs(j).max()) > 0  # every level gets some gradient
        assert _rel(t, j) <= 1e-5


def test_no_level_gives_no_gradient():
    """RoIs whose level lies outside the pyramid (JAX's P6 override routes
    some to level 5) add nothing, exactly."""
    maps, boxes, bix, levels = _case(3, seed=1)
    levels[:] = -1
    levels[5:] = len(maps)
    cot = np.ones((len(boxes), maps[0].shape[1], 3, 3, 2), np.float32)
    _, grads = _port_grad(maps, boxes, bix, levels, (3, 3, 2), cot)
    assert all(not g.any() for g in grads)


def test_plain_backward_is_the_function_backward():
    maps, boxes, bix, levels = _case(2, seed=3)
    cot = np.random.RandomState(1).randn(len(boxes), maps[0].shape[1], 3, 3).astype(np.float32)
    _, via_function = _port_grad(maps, boxes, bix, levels, (3, 3), cot)
    direct = troi.pyramid_roi_align_backward_plain(
        torch.from_numpy(cot), [torch.from_numpy(m) for m in maps], torch.from_numpy(boxes), torch.from_numpy(bix),
        torch.from_numpy(levels), (3, 3))
    for a, b in zip(via_function, direct):
        np.testing.assert_array_equal(a, b.numpy())


def test_boxes_and_indices_get_no_gradient():
    maps, boxes, bix, levels = _case(2, seed=4)
    fms = [torch.from_numpy(m).requires_grad_() for m in maps]
    tboxes = torch.from_numpy(boxes).requires_grad_()
    out = troi.pyramid_roi_align_auto(fms, tboxes, torch.from_numpy(bix), torch.from_numpy(levels), (2, 2))
    out.sum().backward()
    assert tboxes.grad is None and all(f.grad is not None for f in fms)
    with torch.no_grad():  # no graph: the forward alone
        assert not troi.pyramid_roi_align_auto(fms, tboxes, torch.from_numpy(bix), torch.from_numpy(levels),
                                               (2, 2)).requires_grad


@pytest.mark.parametrize("dim,crop", [(2, (5, 4)), (3, (4, 3, 2))])
def test_bf16_maps_match_jax_vjp(dim, crop):
    """bf16 maps: float32 crops, bf16 gradients on both sides."""
    maps, boxes, bix, levels = _case(dim, seed=11 + dim)
    cot = np.random.RandomState(2).randn(len(boxes), maps[0].shape[1], *crop).astype(np.float32)
    j_out, j_grads = _jax_vjp(maps, boxes, bix, levels, crop, cot, jnp.bfloat16)
    t_out, t_grads = _port_grad(maps, boxes, bix, levels, crop, cot, torch.bfloat16)
    assert _rel(t_out, j_out) <= 1e-5
    for t, j in zip(t_grads, j_grads):
        assert _rel(t, j) <= 1e-2
