"""JAX param tree <-> port state_dict conversion.

Round trips must be the identity (exact): the converter only renames,
transposes and (un)stacks arrays. A "loop"-mode FPN tree (per-block
ResBlocks, no stacked axis) must also load and compute the same FPN.
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
