"""Port FPN (torch) against the JAX FPN at ``testing.make_config`` size, with
params converted from the JAX init.

Tolerances:
  * float32: every pyramid level within 1e-4 * max|ref|: the same convs
    summed in another order by XLA:CPU and ATen/oneDNN;
  * bfloat16: within 5e-2 * max|ref|: params are cast at each conv in both,
    but bf16 rounding happens at other sites (conv accumulation, bias add,
    up-sampling), and the error compounds over ~60 conv layers;
  * one conv + GroupNorm layer: 1e-5 * max|ref| (statistics summed in
    another order);
  * nearest up-sampling and max pooling: exact; linear up-sampling, edges
    included: 1e-6 absolute on unit-scale inputs (XLA contracts axis by axis
    with computed, renormalised weights; ATen weights all corners in one
    sum).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import backbone as jbb  # noqa: E402
from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.testing import make_config  # noqa: E402
from medicaldetectiontoolkit_torch.models import backbone as tbb  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402

torch.set_num_threads(2)


class _Log:
    def info(self, *a, **k):
        pass


def jax_fpn_like(module):
    """A JAX FPN with the attributes the JAX RetinaModule gives its FPN_0."""
    return jbb.FPN(
        dim=module.dim, n_channels=module.n_channels, start_filts=module.start_filts,
        end_filts=module.end_filts, res_architecture=module.res_architecture, norm=module.norm,
        relu=module.relu, sixth_pooling=module.sixth_pooling, operate_stride1=module.operate_stride1,
        weight_init=module.weight_init, dtype=module.dtype,
    )


CONFIGS = {
    # name: (model, dim, overrides)
    "unet3d_f32": ("retina_unet", 3, {}),
    "unet3d_bf16": ("retina_unet", 3, {"compute_dtype": "bfloat16"}),
    "unet2d_f32": ("retina_unet", 2, {}),
    "unet2d_bf16": ("retina_unet", 2, {"compute_dtype": "bfloat16"}),
    "net2d_batchnorm": ("retina_net", 2, {"norm": "batch_norm"}),
    "net2d_p6_leaky": ("retina_net", 2, {"sixth_pooling": True, "relu": "leaky_relu"}),
}


@functools.lru_cache(maxsize=None)
def jax_init(model, dim, sixth_pooling, norm, relu):
    """JAX init params (independent of the compute dtype, so shared by the
    float32 and bfloat16 cases)."""
    cf = make_config(model=model, dim=dim)
    cf.sixth_pooling, cf.norm, cf.relu = sixth_pooling, norm, relu
    if sixth_pooling:
        cf.patch_size = [128, 128]
    return jax.device_get(jbuild(cf, _Log()).init_params(seed=3))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fpn_matches_jax(name):
    model, dim, overrides = CONFIGS[name]
    cf = make_config(model=model, dim=dim)
    for k, v in overrides.items():
        setattr(cf, k, v)
    if cf.sixth_pooling:
        cf.patch_size = [128, 128]
    jnet = jbuild(cf, _Log())
    params = jax_init(model, dim, cf.sixth_pooling, cf.norm, cf.relu)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params)

    x = np.random.RandomState(1).rand(2, 1, *cf.patch_size).astype(np.float32)
    ref = jax.jit(jax_fpn_like(jnet.module).apply)({"params": params["FPN_0"]}, jnp.asarray(np.moveaxis(x, 1, -1)))
    with torch.inference_mode():
        got = tnet.module.fpn(torch.from_numpy(x).to(tnet.module.dtype))
    assert len(got) == len(ref)
    rel = 5e-2 if cf.compute_dtype == "bfloat16" else 1e-4
    for lvl, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r, np.float32)
        g = np.moveaxis(g.float().numpy(), 1, -1)
        assert g.shape == r.shape, (lvl, g.shape, r.shape)
        err, scale = np.abs(g - r).max(), np.abs(r).max()
        assert err <= rel * scale, (lvl, err, scale)


@pytest.mark.parametrize("norm", ["instance_norm", "batch_norm"])
@pytest.mark.parametrize("dim", [2, 3])
def test_conv_norm_matches_jax(dim, norm):
    """One ConvND with GroupNorm. Checked per layer rather than through the
    FPN: instance norm over the deepest levels' few voxels per channel is
    ill-conditioned (E[x^2] - E[x]^2), so any change of summation order is
    amplified there in both frameworks alike."""
    rng = np.random.RandomState(dim)
    x = rng.randn(2, 3, *(12, 10, 6)[:dim]).astype(np.float32)
    jmod = jbb.ConvND(dim=dim, features=5, ks=3, pad=1, norm=norm, relu="leaky_relu")
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), xj)["params"])
    params["GroupNorm_0"] = {"scale": rng.rand(5).astype(np.float32) + 0.5, "bias": rng.randn(5).astype(np.float32)}
    want = np.asarray(jmod.apply({"params": params}, xj))

    tmod = tbb.ConvND(dim, 3, 5, ks=3, pad=1, norm=norm, relu="leaky_relu")
    k = params["Conv_0"]["kernel"]
    with torch.no_grad():
        tmod.conv.weight.copy_(torch.from_numpy(np.transpose(k, (dim + 1, dim) + tuple(range(dim))).copy()))
        tmod.conv.bias.copy_(torch.tensor(params["Conv_0"]["bias"]))
        tmod.norm.weight.copy_(torch.from_numpy(params["GroupNorm_0"]["scale"]))
        tmod.norm.bias.copy_(torch.from_numpy(params["GroupNorm_0"]["bias"]))
        got = np.moveaxis(tmod(torch.from_numpy(x)).numpy(), 1, -1)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("dim", [2, 3])
def test_resampling_helpers_match_jax(dim):
    rng = np.random.RandomState(dim)
    shape = (2, 5, 4, 3, 3)[: dim + 2]  # (b, c, y, x, (z)), odd extents
    x = rng.randn(*shape).astype(np.float32)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    xt = torch.from_numpy(x)
    to_cl = lambda t: np.moveaxis(t.numpy(), 1, -1)  # noqa: E731

    up2 = (2,) * dim
    np.testing.assert_array_equal(to_cl(tbb.nearest_up(xt, up2)), np.asarray(jbb._nearest_up(xj, up2)))
    np.testing.assert_array_equal(to_cl(tbb.maxpool(xt - 5.0, dim)), np.asarray(jbb._maxpool(xj - 5.0, dim)))

    aniso = (2, 2, 1) if dim == 3 else (2, 2)
    got, want = to_cl(tbb.linear_up(xt, aniso)), np.asarray(jbb._linear_up(xj, aniso))
    assert got.shape == want.shape
    # edge voxels: half-pixel sampling clamps at the border (no zero or
    # reflect padding), so the (y, x) corners reproduce the input corners
    xcl = np.moveaxis(x, 1, -1)
    for yi, xi in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        for out in (got, want):
            np.testing.assert_allclose(out[:, yi, xi], xcl[:, yi, xi], rtol=0, atol=1e-6)
    for ax in (1, 2):
        for edge in (0, -1):
            np.testing.assert_allclose(np.take(got, edge, axis=ax), np.take(want, edge, axis=ax), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
