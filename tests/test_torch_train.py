"""One-stage training of the port against the JAX package's train step on
the CPU: the same weights (the port's init, converted), the same batch and
JAX's own draws (its key tree: ``_next_rng`` -> ``split(rng, n_micro)`` ->
``split(r, 2*m).reshape(2, m, -1)``), then the step on both sides.

Cases: 2D retina_net without accumulation or remat; 3D retina_unet with 2
microbatches, remat and ``MDT_STEM_PALLAS=1`` (the stem kernels' plain
versions in the port, the Pallas kernels in interpret mode in JAX); a resume
from JAX's params and optimizer state after one step.

Tolerances:
  * loss and monitor values: 1e-5 relative (heads agree to ~1e-6; the
    losses are means of the same float32 terms);
  * gradients and Adam moments, per tensor, relative to the tensor's max:
    1e-4 on the first step (measured: 6e-6); 5e-3 on the resumed step
    (measured: up to 1.8e-3, in the stem and the first ResBlock's first two
    convs only, where a gradient is a sum over every position that cancels
    to a small part of its terms, so another summation order moves it most);
  * updated params, where the gradient is clear of zero and of one sign on
    both sides: 1e-6 absolute after the first step (Adam's first step is
    lr * sign(g)), 1e-6 + 5e-2 lr after the resumed one (its update is lr *
    mu / sqrt(nu), where the moments' relative error grows wherever mu is
    small against sqrt(nu); measured 2.1e-2 lr); elsewhere 2 lr, since a
    gradient near zero may flip sign between the two frameworks;
  * detections after the step: coords, classes and masks equal, scores
    within 1e-5; the results dict of ``train_forward_convert`` likewise.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_torch.models import base as tbase  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.testing import make_batch, make_config  # noqa: E402
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
LR = 1e-3


class _Log:
    def info(self, *a, **k):
        pass


def _config(case):
    if case == "retina_net_2d":
        return make_config(model="retina_net", dim=2, batch_size=2)
    cf = make_config(model="retina_unet", dim=3, batch_size=4)
    cf.grad_accum_steps, cf.use_remat = 2, True
    return cf


def jax_draws(rng, tnet, n_micro, m):
    """The port's draw tensors from JAX's key tree of one train step."""
    cf = tnet.cf
    A = tnet.anchors.shape[0]
    k_pool = min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A)
    keys = jax.random.split(rng, n_micro) if n_micro > 1 else rng[None]
    match, shem = [], []
    for r in keys:
        per = jax.random.split(r, 2 * m).reshape(2, m, -1)
        match.append(jax.vmap(lambda k: jax.random.uniform(k, (A,)))(per[0]))
        shem.append(jax.vmap(lambda k: jax.random.uniform(k, (k_pool,)))(per[1]))
    return torch.from_numpy(np.array(jnp.stack(match))), torch.from_numpy(np.array(jnp.stack(shem)))


@functools.lru_cache(maxsize=None)
def jax_run(case):
    """Two JAX train steps from the port's seed-0 weights: (cf, batches,
    keys, JAX detector, numpy params before each step, step outputs)."""
    import os

    cf = _config(case)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.initialize(seed=0)
    jnet = jbuild(cf, _Log())
    p0 = convert.torch_to_jax(tnet.module.state_dict(), tnet.module)
    batches = [make_batch(cf, seed=s) for s in (1, 2)]
    keys = [jax.random.PRNGKey(s) for s in (5, 6)]
    old = os.environ.get("MDT_STEM_PALLAS")
    os.environ["MDT_STEM_PALLAS"] = "1" if case == "retina_unet_3d" else "0"
    try:
        params, opt_state = jax.device_put(p0), jnet._optimizer.init(jax.device_put(p0))
        before, outs = [], []
        for batch, key in zip(batches, keys):
            before.append((jax.device_get(params), jax.device_get(opt_state)))
            out = jnet._train_step_fn(params, opt_state, key, jnp.float32(LR), *jnet._prep(batch))
            det = jnet._detect_fn(*out[3])
            outs.append(jax.device_get((out[1], out[2], out[3], out[4], det, out[0])))
            params, opt_state = out[0], out[1]
    finally:
        if old is None:
            os.environ.pop("MDT_STEM_PALLAS")
        else:
            os.environ["MDT_STEM_PALLAS"] = old
    return cf, batches, keys, jnet, before, outs


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def port_step(cf, params, opt_state, batch, key, monkeypatch, stem):
    """One port step from JAX (params, opt_state); returns (net, grads,
    aux)."""
    monkeypatch.setenv("MDT_STEM_PALLAS", "1" if stem else "0")
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params, opt_state)
    tnet.current_lr = LR
    inputs = tnet._prep(batch)
    n_micro = tbase.resolve_grad_accum(cf, inputs[0].shape[0])
    _, aux = tnet._accumulate(inputs, jax_draws(key, tnet, n_micro, inputs[0].shape[0] // n_micro))
    grads = {n: p.grad.clone() for n, p in tnet.module.named_parameters()}
    tnet._update()
    return tnet, grads, aux, inputs


def check_step(tnet, grads, aux, jout, first_step, loose=()):
    """The port's step against JAX's, at the module docstring's tolerances;
    tensors whose names start with a prefix in ``loose`` are held to the
    resumed step's 5e-3 on the first step as well."""
    rel_all, p_atol = (1e-4, 1e-6) if first_step else (5e-3, 1e-6 + 5e-2 * LR)
    opt_state, monitor, heads, anchor_info, det, new_params = jout
    for k, v in monitor.items():
        np.testing.assert_allclose(float(aux["monitor"][k]), float(v), rtol=1e-5, err_msg=k)

    adam = convert._adam_state(opt_state)
    mu, nu = convert.jax_to_torch(adam.mu, tnet.module), convert.jax_to_torch(adam.nu, tnet.module)
    want_p = convert.jax_to_torch(new_params, tnet.module)
    for name, p in tnet.module.named_parameters():
        rel = 5e-3 if name.startswith(tuple(loose)) else rel_all
        st = tnet.optimizer.state[p]
        assert _rel_err(st["exp_avg"], mu[name]) <= rel, name
        assert _rel_err(st["exp_avg_sq"], nu[name]) <= rel, name
        if first_step:  # optax's first moment is (1 - b1) * g
            assert _rel_err(grads[name], mu[name] / 0.1) <= rel, name
        g_t, g_j = st["exp_avg"], mu[name]
        clear = (torch.sign(g_t) == torch.sign(g_j)) & (g_j.abs() > 1e-3 * g_j.abs().max())
        diff = (p.detach() - want_p[name]).abs()
        assert float(torch.where(clear, diff, 0.0).max()) <= p_atol, name
        assert float(diff.max()) <= 2 * LR + 1e-6, name

    with torch.no_grad():
        t_det, t_mask, t_seg = tnet._finalize_outputs(*aux["heads"])
    j_det, j_mask, j_seg = det
    np.testing.assert_array_equal(t_mask.numpy(), j_mask)
    np.testing.assert_array_equal(t_det.numpy()[..., :-1], j_det[..., :-1])
    np.testing.assert_allclose(t_det.numpy()[..., -1], j_det[..., -1], rtol=0, atol=1e-5)
    if j_seg is not None:
        assert (t_seg.numpy() != j_seg).mean() <= 1e-4  # argmax near-ties of the seg logits
    for t, j in zip(aux["anchor_info"], anchor_info):
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("case", ["retina_net_2d", "retina_unet_3d"])
def test_train_step_matches_jax(case, monkeypatch):
    cf, batches, keys, jnet, before, outs = jax_run(case)
    tnet, grads, aux, inputs = port_step(cf, *before[0], batches[0], keys[0], monkeypatch,
                                         stem=case == "retina_unet_3d")
    if case == "retina_unet_3d":
        assert tnet.module.fpn.stem0[0].stem_kernel and not tnet.module.fpn.stem0[1].stem_kernel
        assert tnet.module.fpn.stem0[0].remat
    check_step(tnet, grads, aux, outs[0], first_step=True)

    # the results dict, from the same handles on both sides
    jo = outs[0]
    j_img_shape = (inputs[0].shape[0], *inputs[0].shape[2:], inputs[0].shape[1])  # channel-last
    jres = jnet.train_forward_convert((j_img_shape, jo[1], jo[3], *jo[4]), batches[0])
    with torch.no_grad():
        # on the CPU the host copies are the tensors themselves, with no event to wait for
        handles = (tuple(inputs[0].shape), aux["monitor"], aux["anchor_info"], *tnet._finalize_outputs(*aux["heads"]),
                   None)
    tres = tnet.train_forward_convert(handles, batches[0])
    assert set(tres) == set(jres)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=1e-5)
    assert tres["seg_preds"].shape == jres["seg_preds"].shape and tres["seg_preds"].dtype == jres["seg_preds"].dtype
    for tb, jb in zip(tres["boxes"], jres["boxes"]):
        assert [b["box_type"] for b in tb] == [b["box_type"] for b in jb]
        for t, j in zip(tb, jb):
            np.testing.assert_array_equal(t["box_coords"], j["box_coords"])
            if "box_score" in j:
                assert abs(t["box_score"] - j["box_score"]) <= 1e-5
    assert sum(b["box_type"] == "pos_anchor" for b in tres["boxes"][0]) > 0


def test_resume_from_jax_optimizer_state(monkeypatch):
    """The port's step from JAX's params and Adam state after one step
    equals JAX's second step."""
    cf, batches, keys, _, before, outs = jax_run("retina_net_2d")
    tnet, grads, aux, _ = port_step(cf, *before[1], batches[1], keys[1], monkeypatch, stem=False)
    assert all(float(tnet.optimizer.state[p]["step"]) == 2 for p in tnet.module.parameters())
    check_step(tnet, grads, aux, outs[1], first_step=False)


def test_adam_state_round_trip():
    cf, _, _, _, before, _ = jax_run("retina_net_2d")
    params, opt_state = before[1]
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.load_params(params, opt_state)
    count, mu, nu = convert.torch_adam_to_jax(tnet.optimizer.state_dict(), tnet.module)
    adam = convert._adam_state(opt_state)
    assert count == int(adam.count) == 1
    for a, b in zip(jax.tree_util.tree_leaves((mu, nu)), jax.tree_util.tree_leaves((adam.mu, adam.nu))):
        np.testing.assert_array_equal(a, b)


def test_train_forward_contract_and_state_dict():
    """``train_forward`` through the port's own draws: the reference results
    dict; a validation step leaves the weights alone; ``state_dict`` carries
    the optimizer state into another detector."""
    cf = make_config(model="retina_unet", dim=2, batch_size=4)
    cf.grad_accum_steps = 2
    net = tbuild(cf, _Log(), device="cpu")
    net.initialize(seed=1)
    batch = make_batch(cf, seed=3)
    res = net.train_forward(batch)
    assert np.isfinite(res["loss"]) and "seg dice" in res["logger_string"]
    assert len(res["boxes"]) == 4 and res["seg_preds"].shape == (4, 1, *cf.patch_size)
    assert res["seg_preds"].dtype == np.uint8
    assert net.train_forward(batch, need_seg_preds=False)["seg_preds"].dtype == np.float32
    state = net.state_dict()
    val = net.train_forward(batch, is_validation=True)
    assert np.isfinite(val["loss"])
    for k, v in net.module.state_dict().items():
        assert torch.equal(v, state["params"][k])
    other = tbuild(cf, _Log(), device="cpu")
    other.load_state_dict(state)
    steps = {float(s["step"]) for s in other.optimizer.state.values()}
    assert steps == {2.0} and len(other.optimizer.state) == len(list(net.module.parameters()))


def test_no_card_no_default_device(monkeypatch):
    """Without a visible CUDA card a detector needs ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbuild(make_config(model="retina_net", dim=2), _Log())
