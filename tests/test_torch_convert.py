"""JAX param tree <-> port state_dict conversion.

Round trips must be the identity (exact): the converter only renames,
transposes, flips and (un)stacks arrays. A "loop"-mode FPN tree (per-block
ResBlocks, no stacked axis) must also load and compute the same FPN. The
two-stage trees are checked against the JAX detectors' own tree structure
(``jax.eval_shape`` of their init) filled with seeded values. A flax
ConvTranspose and the converted torch transposed conv agree within 1e-5
(float32 sums in another order); without the kernel flip they do not.
"""

import functools

import flax.linen as fnn
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import backbone as jbb  # noqa: E402
from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_tpu.testing import make_config  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)


class _Log:
    def info(self, *a, **k):
        pass


def assert_trees_equal(a, b, path=""):
    assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (f"{path}/{k}", a[k].shape, b[k].shape)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


@functools.lru_cache(maxsize=None)
def _jax_init(model, dim):
    jnet = jbuild(make_config(model=model, dim=dim), _Log())
    return jnet, jax.device_get(jnet.init_params(seed=0))


def jax_params(cf, stage_mode):
    """JAX init of the detector; with "loop", FPN_0 is re-initialised as a
    loop-mode FPN (the JAX RetinaModule itself always builds "unroll")."""
    jnet, params = _jax_init(cf.model, cf.dim)
    params = dict(params)
    if stage_mode == "loop":
        m = jnet.module
        fpn = jbb.FPN(dim=m.dim, n_channels=m.n_channels, start_filts=m.start_filts, end_filts=m.end_filts,
                      res_architecture=m.res_architecture, norm=m.norm, relu=m.relu,
                      sixth_pooling=m.sixth_pooling, operate_stride1=m.operate_stride1, stage_mode="loop")
        x = jnp.zeros((1, *cf.patch_size, cf.n_channels), jnp.float32)
        params["FPN_0"] = jax.device_get(jax.jit(fpn.init)(jax.random.PRNGKey(1), x)["params"])
        return params, fpn
    return params, None


@pytest.mark.parametrize("stage_mode", ["unroll", "loop"])
@pytest.mark.parametrize("model,dim", [("retina_unet", 2), ("retina_unet", 3), ("retina_net", 2)])
def test_round_trip_is_identity(model, dim, stage_mode):
    cf = make_config(model=model, dim=dim)
    params, loop_fpn = jax_params(cf, stage_mode)
    net = tbuild(cf, _Log(), device="cpu")
    sd = convert.jax_to_torch(params, net.module)
    assert set(sd) == set(net.module.state_dict())
    back = convert.torch_to_jax(sd, net.module, stage_mode=stage_mode)
    assert_trees_equal(params, back)

    # torch -> JAX -> torch as well, through the detector's own API
    net.initialize(seed=4)
    state = net.state_dict()["params"]
    net.load_params(convert.torch_to_jax(state, net.module, stage_mode=stage_mode))
    for k, v in net.state_dict()["params"].items():
        assert torch.equal(v, state[k]), k

    if loop_fpn is not None and dim == 2 and model == "retina_unet":
        net.load_params(params)
        x = np.random.RandomState(2).rand(1, 1, *cf.patch_size).astype(np.float32)
        want = jax.jit(loop_fpn.apply)({"params": params["FPN_0"]}, jnp.asarray(np.moveaxis(x, 1, -1)))
        with torch.inference_mode():
            got = net.module.fpn(torch.from_numpy(x))
        for g, w in zip(got, want):
            w = np.asarray(w)
            # float32 convs summed in another order (see test_torch_backbone.py)
            assert np.abs(np.moveaxis(g.numpy(), 1, -1) - w).max() <= 1e-4 * np.abs(w).max()


def test_rejects_foreign_or_incomplete_trees():
    cf = make_config(model="retina_unet", dim=2)
    params, _ = jax_params(cf, "unroll")
    net = tbuild(cf, _Log(), device="cpu")
    extra = dict(params, Extra_0={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not used"):
        convert.jax_to_torch(extra, net.module)
    missing = dict(params)
    del missing["DenseHead_1"]
    with pytest.raises(KeyError, match="DenseHead_1"):
        convert.jax_to_torch(missing, net.module)
    # a retina_net tree lacks the seg head of retina_unet
    other = tbuild(make_config(model="retina_net", dim=2), _Log(), device="cpu")
    with pytest.raises(ValueError, match="ConvND_0"):
        convert.jax_to_torch(params, other.module)


@functools.lru_cache(maxsize=None)
def _two_stage_tree(model, dim, norm):
    """(cf, JAX param tree with seeded values) of a two-stage detector: the
    structure and shapes of its init (``jax.eval_shape``, nothing compiled)."""
    cf = make_config(model=model, dim=dim, retina_scales=False)
    cf.norm = norm
    shapes = jax.eval_shape(lambda: jbuild(cf, _Log()).init_params(seed=0))
    rng = np.random.RandomState(dim)
    return cf, jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("model,dim,norm", [("mrcnn", 2, None), ("mrcnn", 3, None), ("mrcnn", 2, "batch_norm"),
                                            ("ufrcnn", 2, None), ("ufrcnn", 3, "instance_norm")])
def test_two_stage_round_trip_is_identity(model, dim, norm):
    cf, params = _two_stage_tree(model, dim, norm)
    assert {"fpn", "rpn", "classifier"} <= set(params)
    assert ("mask" in params) == (model == "mrcnn") and ("final_conv" in params) == (model == "ufrcnn")
    net = tbuild(cf, _Log(), device="cpu")
    sd = convert.jax_to_torch(params, net.module)
    assert set(sd) == set(net.module.state_dict())
    assert_trees_equal(params, convert.torch_to_jax(sd, net.module))

    net.initialize(seed=4)
    state = net.state_dict()["params"]
    net.load_params(convert.torch_to_jax(state, net.module))
    for k, v in net.state_dict()["params"].items():
        assert torch.equal(v, state[k]), k


def test_two_stage_rejects_the_other_tree():
    _, mrcnn_params = _two_stage_tree("mrcnn", 2, None)
    ufrcnn = tbuild(make_config(model="ufrcnn", dim=2, retina_scales=False), _Log(), device="cpu")
    with pytest.raises((KeyError, ValueError), match="fpn/"):  # ufrcnn's FPN has the stride-1 levels
        convert.jax_to_torch(mrcnn_params, ufrcnn.module)
    cf = make_config(model="mrcnn", dim=2, retina_scales=False)
    cf.frcnn_mode = True  # no mask head
    no_mask = tbuild(cf, _Log(), device="cpu")
    with pytest.raises(ValueError, match="mask/"):
        convert.jax_to_torch(mrcnn_params, no_mask.module)


@pytest.mark.parametrize("dim", [2, 3])
def test_conv_transpose_kernel_is_flipped(dim):
    """flax's ConvTranspose (transpose_kernel=False) does not flip its kernel,
    torch's transposed conv does: the converter reverses every spatial axis."""
    rng = np.random.RandomState(dim)
    layer = fnn.ConvTranspose(4, kernel_size=(2,) * dim, strides=(2,) * dim)
    x = rng.randn(2, *(3, 4, 5)[:dim], 3).astype(np.float32)
    p = jax.device_get(layer.init(jax.random.PRNGKey(dim), jnp.asarray(x))["params"])
    p = dict(p, bias=rng.randn(4).astype(np.float32))
    want = np.asarray(layer.apply({"params": p}, jnp.asarray(x)))
    up = torch.nn.functional.conv_transpose2d if dim == 2 else torch.nn.functional.conv_transpose3d
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))

    def run(kernel):
        w = torch.from_numpy(np.ascontiguousarray(kernel))
        return np.moveaxis(up(xt, w, torch.from_numpy(p["bias"]), stride=2).numpy(), 1, -1)

    kernel = np.asarray(p["kernel"])
    got = run(convert._to_torch_layout(kernel, "deconv"))
    assert got.shape == want.shape == (2, *(6, 8, 10)[:dim], 4)
    assert np.abs(got - want).max() <= 1e-5
    unflipped = np.transpose(kernel, (dim, dim + 1) + tuple(range(dim)))
    assert np.abs(run(unflipped) - want).max() > 0.1
    np.testing.assert_array_equal(convert._to_jax_layout(convert._to_torch_layout(kernel, "deconv"), "deconv"), kernel)
