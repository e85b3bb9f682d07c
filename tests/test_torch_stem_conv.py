"""The port's stem conv (plain K3 and K4, ``StemConv3dFunction``, the gate,
the ``ConvND`` routing) against the JAX package's, which runs its Pallas
kernels in interpret mode here.

Tolerances:
  * forward, float32: 2e-5 absolute and relative, as JAX's own test holds
    its kernel against ``nn.Conv`` (``test_stem_conv_pallas.py:49-55``): the
    same float32 products summed in another order (taps here, a banded GEMM
    there);
  * forward, bfloat16: 1e-2 relative to max|ref|: both sum in float32 and
    round twice (the cast, then the bias add), so an output whose float32
    sums fall on either side of a rounding boundary differs by one bf16 ulp
    (2^-8 relative);
  * gradients, float32: 3e-4, JAX's tolerance for its VJP against
    ``nn.Conv`` (``test_stem_conv_pallas.py:74``);
  * dw in bfloat16: 3e-2 relative to max|dw|: JAX casts each band entry of
    dT to bf16 and sums the band's diagonals in bf16 (``:329-331``), the port
    sums in float32 and casts once;
  * the gate: exactly ``stem_pallas_viable``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import backbone as jbb  # noqa: E402
from medicaldetectiontoolkit_tpu.ops.stem_conv_pallas import stem_conv3d as jstem  # noqa: E402
from medicaldetectiontoolkit_tpu.ops.stem_conv_pallas import stem_pallas_viable  # noqa: E402
from medicaldetectiontoolkit_torch.models import backbone as tbb  # noqa: E402
from medicaldetectiontoolkit_torch.ops import stem_conv  # noqa: E402

torch.set_num_threads(2)

SHAPES = [  # (B, Y, X, Z, cin), k, sy, sx: the cases of test_stem_conv_pallas.py:32-39
    ((2, 12, 14, 8, 1), 7, 2, 2),
    ((1, 13, 11, 6, 1), 7, 2, 2),
    ((2, 10, 10, 8, 2), 5, 2, 2),
    ((1, 8, 8, 4, 1), 3, 1, 1),
]


def _inputs(shape, k, seed, cout=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(k, k, k, shape[-1], cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


def _to_torch(x, w, b, dtype=torch.float32):
    """Channel-last JAX operands -> the port's channel-first tensors."""
    return (torch.from_numpy(np.moveaxis(x, -1, 1).copy()).to(dtype),
            torch.from_numpy(np.transpose(w, (4, 3, 0, 1, 2)).copy()).to(dtype),
            torch.from_numpy(b).to(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,sy,sx", SHAPES)
def test_forward_matches_jax_kernel(shape, k, sy, sx, dtype):
    x, w, b = _inputs(shape, k, seed=0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jstem(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt), sy, sx, True), np.float32)
    got = stem_conv.stem_conv3d(*_to_torch(x, w, b, getattr(torch, dtype)), sy, sx)
    assert got.dtype == getattr(torch, dtype)
    got = np.moveaxis(got.float().numpy(), 1, -1)
    assert got.shape == want.shape == (shape[0], -(-shape[1] // sy), -(-shape[2] // sx), shape[3], 6)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("shape,k,sy,sx", [SHAPES[0], SHAPES[1], SHAPES[2]])
def test_gradients_match_jax_vjp(shape, k, sy, sx):
    """dx, dw and db of ``StemConv3dFunction`` against ``jax.grad`` through
    ``stem_conv3d``'s custom VJP (the wgrad kernel in interpret mode)."""
    x, w, b = _inputs(shape, k, seed=1)
    g = np.random.RandomState(2).randn(shape[0], -(-shape[1] // sy), -(-shape[2] // sx), shape[3], 6)
    g = g.astype(np.float32)
    want = jax.grad(lambda *a: jnp.vdot(jstem(*a, sy, sx, True), g), argnums=(0, 1, 2))(x, w, b)

    xt, wt, bt = [t.requires_grad_() for t in _to_torch(x, w, b)]
    out = stem_conv.StemConv3dFunction.apply(xt, wt, bt, sy, sx)
    out.backward(torch.from_numpy(np.moveaxis(g, -1, 1).copy()))
    got = (np.moveaxis(xt.grad.numpy(), 1, -1), np.transpose(wt.grad.numpy(), (2, 3, 4, 1, 0)), bt.grad.numpy())
    for name, a, c in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a, np.asarray(c), atol=3e-4, rtol=3e-4, err_msg=name)


def test_bfloat16_weight_gradient_matches_jax():
    shape, k, sy, sx = SHAPES[0]
    x, w, b = _inputs(shape, k, seed=3)
    g = np.random.RandomState(4).randn(shape[0], 6, 7, shape[3], 6).astype(np.float32)
    bf = jnp.bfloat16
    want = jax.grad(lambda w_: jnp.vdot(jstem(jnp.asarray(x, bf), w_, jnp.asarray(b, bf), sy, sx, True)
                                        .astype(jnp.float32), g), argnums=0)(jnp.asarray(w, bf))
    xt, wt, bt = _to_torch(x, w, b, torch.bfloat16)
    wt.requires_grad_()
    out = stem_conv.StemConv3dFunction.apply(xt, wt, bt, sy, sx)
    out.float().backward(torch.from_numpy(np.moveaxis(g, -1, 1).copy()))
    assert wt.grad.dtype == torch.bfloat16
    got = np.transpose(wt.grad.float().numpy(), (2, 3, 4, 1, 0))
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_wgrad_reference_is_the_conv_weight_gradient():
    """The plain K4 against autograd of ``F.conv3d`` (pad k//2, float32)."""
    for (B, Y, X, Z, cin), k, sy, sx in SHAPES:
        x, w, b = _to_torch(*_inputs((B, Y, X, Z, cin), k, seed=5))
        w.requires_grad_()
        out = torch.nn.functional.conv3d(x, w, b, (sy, sx, 1), k // 2)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(6))
        out.backward(g)
        np.testing.assert_allclose(stem_conv.stem_wgrad_reference(x, g, k, sy, sx).numpy(), w.grad.numpy(),
                                   atol=3e-4, rtol=3e-4)


def test_gate_equals_jax():
    shapes = [(2, 128, 128, 64, 1), (4, 64, 64, 8, 2), (1, 32, 32, 256, 1), (2, 16, 16, 64, 3),
              (1, 64, 64, 128, 2), (1, 16, 16, 16, 18)]
    for shape, k, stride, pad in itertools.product(
            shapes, (1, 3, 5, 7), [(1, 1, 1), (2, 2, 1), (2, 2, 2), (1, 2, 1), (3, 3, 1)], (0, 1, 2, 3)):
        tshape = (shape[0], shape[4], *shape[1:4])  # the port sees (B, cin, Y, X, Z)
        ok = stem_conv.stem_viable((tshape[0], *tshape[2:], tshape[1]), k, stride, pad)
        assert ok == stem_pallas_viable(shape, k, stride, pad), (shape, k, stride, pad)


def test_no_third_device():
    x = torch.empty((1, 1, 4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no stem conv implementation"):
        stem_conv.stem_conv3d(x, torch.empty((2, 1, 3, 3, 3), device="meta"), torch.empty(2, device="meta"), 1, 1)


@pytest.mark.parametrize("cin,ks,stride,pad,routed", [
    (1, 7, (2, 2, 1), 3, True),   # Retina Net's C1 stem
    (1, 3, (1, 1, 1), 1, True),   # Retina U-Net's first stem0 conv
    (3, 3, (1, 1, 1), 1, False),  # cin > 2
    (1, 1, (1, 1, 1), 0, False),  # 1x1
])
def test_convnd_routing_matches_jax(monkeypatch, cin, ks, stride, pad, routed):
    """With ``MDT_STEM_PALLAS=1`` the same convs take the stem kernels in
    both packages; converted params give JAX's output either way."""
    monkeypatch.setenv("MDT_STEM_PALLAS", "1")
    x = np.random.RandomState(7).randn(2, 12, 12, 8, cin).astype(np.float32)
    jmod = jbb.ConvND(dim=3, features=4, ks=ks, stride=stride, pad=pad, relu="relu")
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    assert set(params) == {"Conv_0"}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    tmod = tbb.ConvND(3, cin, 4, ks=ks, stride=stride, pad=pad, relu="relu")
    with torch.no_grad():
        tmod.conv.weight.copy_(torch.from_numpy(np.transpose(params["Conv_0"]["kernel"], (4, 3, 0, 1, 2)).copy()))
        tmod.conv.bias.copy_(torch.from_numpy(np.array(params["Conv_0"]["bias"])))
        got = np.moveaxis(tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).numpy(), 1, -1)
    assert tmod.stem_kernel is routed
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)

    monkeypatch.delenv("MDT_STEM_PALLAS")
    with torch.no_grad():
        tmod(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert tmod.stem_kernel is False
