"""Spatially partitioned training of the port (``parallel/mesh.py``: train
and validation steps over a space group whose ranks each hold a Y slab) on
the CPU.

Ranks are gloo subprocesses with a hard timeout (``testing.run_ranks``; a
rank is ``python -m medicaldetectiontoolkit_torch.testing sp_rank``); one
set of two ranks computes every S = 2 case and one set of four the S = 4
primitives and the 2 x 2 grid, while this process makes the references:

  * the backward of each primitive (``testing.sp_grad_primitives``, float64,
    at S = 2 and S = 4): halos with zeros, ``-inf`` and the edge row
    repeated (the convs, the max pools, ``linear_up`` and windows along Y),
    ``space_sum`` inside GroupNorm(1) and instance norm, ``gather_y`` and a
    level that ``space_fence`` gathers and runs replicated. The loss is a
    scalar of the gathered outputs seeded with 1/S on every rank; each
    rank's slab of the input gradient equals the whole-tensor gradient's
    slab within 1e-10 of its max, and the ranks' parameter gradient shares
    add up to the whole one. An identity backward for ``space_sum`` gives
    GroupNorm a gradient more than 1e-2 of its max off;
  * a validation step, a train step and a second validation step
    (``testing.sp_train_step``) at S = 2 of each ``testing.SP_CASES``
    case, remat on and off, against the port's single-process steps on the
    same weights and draws: losses and monitor values 1e-6 relative (the
    second validation step, after Adam, 1e-5); gradients 1e-5 of each
    tensor's max, the stem and the first ResBlock 1e-3, where sums over
    every position cancel (``tests/test_torch_parallel.py``'s rule);
    updated parameters 1e-6 where the gradient is clear of zero and of one
    sign on both sides, else within 2 lr (Adam's first step is lr *
    sign(g)). Instance norm is held as strictly, the stem included: its
    GroupNorm sums are float64 on one process as on the slabs
    (``backbone._flax_group_norm``). A conv bias's gradient is the sum of
    its output gradient over the batch and every position, which instance
    norm cancels to 0 ahead of it (to the image's edges ahead of a padded
    conv), so it is held within 1e-5 of the larger of its max and its
    terms' (the sum of their magnitudes, per channel); where it is 0 within
    that, Adam's step on its rounding is lr either way, and the updated
    values are held within 2 lr. The backward collectives ran, and with
    remat the forward's halos and sums again;
  * the same on a 2 x 2 (data x space) grid of four ranks, a global batch
    of 4 in 2 microbatches;
  * the S = 2 train steps of 3D Retina U-Net, 3D Mask R-CNN, 2D Detection
    U-Net and the replicated 2D Retina U-Net against JAX's single-device
    step (``_train_step_fn``; JAX's own spatial step equals it,
    ``tests/test_parallel.py``), on JAX's draws and the port's weights
    converted: ``tests/test_torch_train.py``'s first-step tolerances.
    Instance norm is not among them: flax sums its statistics in float32,
    and over the deepest level's few voxels per channel that rounding moves
    its gradients there by up to a quarter of their max;
  * ``exec --mode train_test`` over S = 2 ranks that exec starts itself, and
    ``--mode train --resume_to_checkpoint`` to a second epoch with
    ``val_patient`` validation, against one process, each loader of two
    worker threads (the ranks of a space group must draw the same batches
    in the same order): per-epoch losses within 1e-5 relative,
    ``last_checkpoint`` and ``results.txt`` written by rank 0 alone.
"""

import contextlib
import os
import pickle
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("pandas")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu.models import build_model as jbuild  # noqa: E402
from medicaldetectiontoolkit_torch import models as tmodels  # noqa: E402
from medicaldetectiontoolkit_torch import testing  # noqa: E402
from medicaldetectiontoolkit_torch.models import build_model as tbuild  # noqa: E402
from medicaldetectiontoolkit_torch.models import mrcnn as tmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch.parallel import mesh  # noqa: E402
from medicaldetectiontoolkit_torch.utils import convert  # noqa: E402

torch.set_num_threads(2)
RANK = ["-m", "medicaldetectiontoolkit_torch.testing", "sp_rank"]
LR = 1e-3
LOOSE = ("fpn.stem", "fpn.stages.0.0.")  # the stem and the first ResBlock
EARLY = ("fpn.stem0.", "fpn.stem1.", "fpn.stages.0.0.conv1.", "fpn.stages.0.0.conv2.")
JAX_CASES = ("retina_unet", "mrcnn", "detection_unet", "replicated")
GRAD_NAMES = [op[0] for op in testing.sp_grad_primitives()]
EXP_SOURCE = os.path.join(REPO, "medicaldetectiontoolkit_torch", "experiments", "lidc_exp")
ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "64,64,8", "MDT_LIDC_BS": "2",
       "MDT_LIDC_EPOCHS": "1", "MDT_LIDC_NTB": "2", "MDT_LIDC_NVB": "1"}
SMALL = {"start_filts": 4, "end_filts": 8, "n_rpn_features": 8, "pre_nms_limit": 500, "n_cv_splits": 4,
         "n_workers": 2, "plot_prediction_histograms": False, "test_n_epochs": 1, "max_test_patients": 1}
RUN = "import sys; from medicaldetectiontoolkit_torch import exec as e; e.main(sys.argv[1:], device='cpu')"


class _Log:
    def info(self, *a, **k):
        pass

    warning = info


def _load(out, case, world):
    return [torch.load(os.path.join(out, f"{case}_rank{r}.pt"), weights_only=False) for r in range(world)]


#############################
#   JAX's draws and step    #
#############################

def _uniform(keys, n):
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def jax_draws(rng, tnet, n_micro, m):
    """The port's draw tensors from JAX's key tree of one train step
    (``tests/test_torch_train.py``, ``tests/test_torch_mrcnn_train.py``)."""
    cf = tnet.cf
    A = tnet.anchors.shape[0]
    k_pool = min(cf.shem_poolsize * (cf.rpn_train_anchors_per_image // 2), A)
    keys = jax.random.split(rng, n_micro) if n_micro > 1 else rng[None]
    out = []
    for r in keys:
        if cf.model == "mrcnn":
            P = cf.post_nms_rois_training
            k_roi = min(cf.shem_poolsize * tmrcnn.roi_slots(cf)[1], P)
            per = jax.random.split(r, 3 * m).reshape(3, m, -1)
            pos_neg = jax.vmap(jax.random.split)(per[2])
            out.append((_uniform(per[0], A), _uniform(per[1], k_pool), _uniform(pos_neg[:, 0], P),
                        _uniform(pos_neg[:, 1], k_roi), _uniform(pos_neg[:, 1], P)))
        else:
            per = jax.random.split(r, 2 * m).reshape(2, m, -1)
            out.append((_uniform(per[0], A), _uniform(per[1], k_pool)))
    return tuple(torch.from_numpy(np.stack(parts)) for parts in zip(*out))


def _jax_step(case, key):
    """JAX's single-device train step from the port's weights of ``case``:
    (monitor, optax's first moment, new params) as torch state dicts. Its
    3D stem is XLA's conv (``MDT_STEM_PALLAS`` off), which the port's plain
    K3 equals within these tolerances."""
    cf, batch, init, _ = testing.sp_train_case(case)
    tnet = tbuild(cf, _Log(), device="cpu")
    tnet.initialize(seed=init)
    jnet = jbuild(cf, _Log())
    params = jax.device_put(convert.torch_to_jax(tnet.module.state_dict(), tnet.module))
    opt_state = jnet._optimizer.init(params)
    with testing.env_scope({"MDT_STEM_PALLAS": "0"}):
        if cf.model == "detection_unet":
            img = jnp.asarray(np.moveaxis(batch["data"], 1, -1))
            new_params, opt_state, loss, _ = jax.device_get(jnet._train_step_fn(
                params, opt_state, jnp.float32(LR), img, jnp.asarray(batch["seg"], jnp.int32)))
            monitor = {"loss": loss}
        else:
            new_params, opt_state, monitor = jax.device_get(jnet._train_step_fn(
                params, opt_state, key, jnp.float32(LR), *jnet._prep(batch))[:3])
    adam = convert._adam_state(opt_state)
    return ({k: float(v) for k, v in monitor.items()}, convert.jax_to_torch(adam.mu, tnet.module),
            convert.jax_to_torch(new_params, tnet.module))


@contextlib.contextmanager
def _conv_bias_terms():
    """Inside, the port's convs record, per conv bias, the sum over the
    batch and positions of the magnitude of their output gradient (the
    terms whose sum the bias's gradient is); yields a function giving, per
    parameter name, the largest over the channels."""
    sums, nets = {}, []
    build, convs = tmodels.build_model, (F.conv2d, F.conv3d)

    def recording(conv):
        def run(x, w, b=None, *args, **kwargs):
            y = conv(x, w, b, *args, **kwargs)
            if b is not None and y.requires_grad:
                dims = [d for d in range(y.dim()) if d != 1]
                y.register_hook(lambda g: sums.__setitem__(id(b), sums.get(id(b), 0.0) + g.abs().sum(dim=dims)))
            return y
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodels, "build_model", lambda *a, **k: nets.append(build(*a, **k)) or nets[-1])
        mp.setattr(F, "conv2d", recording(convs[0]))
        mp.setattr(F, "conv3d", recording(convs[1]))
        yield lambda: {n: float(sums[id(p)].max()) for n, p in nets[-1].module.named_parameters() if id(p) in sums}


def _single(case, draws):
    """The port's single-process steps of ``case`` (``testing.sp_train_step``);
    for instance norm with ``terms``, its conv biases' (``_conv_bias_terms``)."""
    cf, batch, init, env = testing.sp_train_case(case)
    with testing.env_scope(env):
        if case != "instance_norm":
            return testing.sp_train_step(cf, batch, init, draws=draws)
        with _conv_bias_terms() as terms:
            out = testing.sp_train_step(cf, batch, init, draws=draws)
        out["terms"] = terms()
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read, made at once: the ranks' results
    (``ranks``: per case, per rank), the port's single-process steps
    (``single``), JAX's steps (``jax``) and the two exec runs (``exec``:
    their exp dirs). The ranks and the spatial exec runs go on in threads
    while this process makes the references and the one-process exec run."""
    out = str(tmp_path_factory.mktemp("sp_train"))
    key = jax.random.PRNGKey(5)
    draws = {}
    for case in (*testing.SP_CASES, testing.SP_GRID_CASE):
        cf, _, init, _ = testing.sp_train_case(case)
        if cf.model == "detection_unet":
            continue
        tnet = tbuild(cf, _Log(), device="cpu")
        n_micro = cf.grad_accum_steps
        draws[case] = jax_draws(key, tnet, n_micro, cf.batch_size // n_micro)
        torch.save(draws[case], os.path.join(out, f"{case}_draws.pt"))

    def ranks():
        testing.run_ranks([*RANK, out, "cpu", *(f"train:{c}" for c in testing.SP_CASES)], 2, 400.0)
        testing.run_ranks([*RANK, out, "cpu", "grad_primitives", f"train:{testing.SP_GRID_CASE}"], 4, 300.0)

    exp_runs = _ExecRuns(str(tmp_path_factory.mktemp("sp_exec")))
    with ThreadPoolExecutor(2) as pool:
        done = [pool.submit(ranks), pool.submit(exp_runs.spatial)]
        single = {case: _single(case, draws.get(case)) for case in (*testing.SP_CASES, testing.SP_GRID_CASE)}
        jax_ref = {case: _jax_step(case, key) for case in JAX_CASES}
        exp_runs.single()
        for future in done:
            future.result()
    result = {f"train:{c}": _load(out, f"train_{c}", 2) for c in testing.SP_CASES}
    result[f"train:{testing.SP_GRID_CASE}"] = _load(out, f"train_{testing.SP_GRID_CASE}", 4)
    result["grad_primitives"] = _load(out, "grad_primitives", 4)
    return {"ranks": result, "single": single, "jax": jax_ref, "exec": exp_runs}


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _check_params(p, want, grad, name, other=None):
    """Updated params: 1e-6 where the gradient is clear of zero (and of one
    sign with ``other``, the other side's gradient, where given), else 2 lr."""
    clear = grad.abs() > 1e-3 * grad.abs().max()
    if other is not None:
        clear &= torch.sign(grad) == torch.sign(other)
    diff = (p - want).abs()
    assert float(torch.where(clear, diff, 0.0).max()) <= 1e-6, name
    assert float(diff.max()) <= 2 * LR + 1e-6, name


def _check_step(got, ref, case):
    for key, rtol in (("val", 1e-6), ("train", 1e-6), ("val_after", 1e-5)):
        assert set(got[key]) == set(ref[key])
        for k, v in ref[key].items():
            np.testing.assert_allclose(got[key][k], v, rtol=rtol, err_msg=f"{case} {key} {k}")
    terms = ref.get("terms", {})
    for name, g in ref["grads"].items():
        err = float((got["grads"][name] - g).abs().max())
        top = float(g.abs().max())
        loose = name.startswith(LOOSE) and case != "instance_norm"
        tol = (1e-3 if loose else 1e-5) * max(top, terms.get(name, 0.0))
        assert err <= tol, (case, name, err, tol)
        if top <= 1e-5 * terms.get(name, 0.0):  # 0 within rounding: Adam's step on it is lr either way
            assert float((got["params"][name] - ref["params"][name]).abs().max()) <= 2 * LR + 1e-6, name
        else:
            _check_params(got["params"][name], ref["params"][name], g, name, other=got["grads"][name])


#############################
#   backward primitives     #
#############################

@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("name", GRAD_NAMES)
def test_backward_primitive_gives_the_whole_tensor_gradient(runs, name, n_space):
    _, fn, x, params = next(op for op in testing.sp_grad_primitives() if op[0] == name)
    xx = x.clone().requires_grad_(True)
    out = fn(xx)
    want = torch.autograd.grad((testing.sp_grad_weight(out.shape) * out).sum(), [xx, *params], allow_unused=True)
    n = x.shape[2] // n_space
    shares = [torch.zeros_like(p) for p in params]
    ranks = runs["ranks"]["grad_primitives"]
    for res in ranks:
        r = res[n_space]["space_index"]
        gx, gp = res[n_space]["grads"][name]
        rows = slice(r * n, (r + 1) * n)
        others = torch.ones(x.shape[2], dtype=torch.bool)
        others[rows] = False
        assert not gx[:, :, others].any()  # slab_of: the other rows' gradient is the other ranks' share
        assert float((gx[:, :, rows] - want[0][:, :, rows]).abs().max()) <= 1e-10 * float(want[0].abs().max())
        for s, g in zip(shares, gp):
            s += g
    n_groups = len(ranks) // n_space  # space groups, each holding the whole gradient in shares
    for s, w in zip(shares, want[1:]):
        assert float((s / n_groups - w).abs().max()) <= 1e-10 * float(w.abs().max())
    stats = ranks[0][n_space]["stats"]
    assert all(stats[k]["calls"] > 0 for k in mesh.SpaceGroup.KINDS)


@pytest.mark.parametrize("n_space", [2, 4])
def test_an_identity_space_sum_backward_gives_the_wrong_gradient(runs, n_space):
    """GroupNorm's statistics feed each slab's own normalisation, so an
    identity backward of their sum (``batch_sum``'s) drops the other slabs'
    shares of their gradient."""
    _, fn, x, params = next(op for op in testing.sp_grad_primitives() if op[0] == "group_norm_1")
    xx = x.clone().requires_grad_(True)
    out = fn(xx)
    want = torch.autograd.grad((testing.sp_grad_weight(out.shape) * out).sum(), xx)[0]
    n = x.shape[2] // n_space
    for res in runs["ranks"]["grad_primitives"]:
        r = res[n_space]["space_index"]
        gx = res[n_space]["identity_sum"][0][:, :, r * n:(r + 1) * n]
        assert float((gx - want[:, :, r * n:(r + 1) * n]).abs().max()) > 1e-2 * float(want.abs().max())


#############################
#   train steps at S = 2    #
#############################

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("case", testing.SP_CASES)
def test_spatial_train_step_equals_the_single_process_step(runs, case, remat):
    ref = runs["single"][case]
    ranks = [res[remat] for res in runs["ranks"][f"train:{case}"]]
    for res in ranks:
        _check_step(res, ref, case)
        stats = res["stats"]
        assert stats["halo_bwd"]["calls"] > 0
        if case in ("detection_unet", "instance_norm"):  # its softmax is joined detached: no gather's backward
            assert stats["sum_bwd"]["calls"] > 0 and stats["gather_bwd"]["calls"] == 0
        else:
            assert stats["gather_bwd"]["calls"] > 0
    a, b = ranks
    for name in a["grads"]:
        assert torch.equal(a["grads"][name], b["grads"][name]) and torch.equal(a["params"][name], b["params"][name])
    if case == "mrcnn":  # positive RoIs were sampled: the second stage's box and mask losses ran
        assert ref["train"]["mrcnn_bbox_loss"] > 0 and ref["train"]["mrcnn_mask_loss"] > 0


def test_remat_reissues_the_halos_and_sums_inside_the_backward(runs):
    """With remat the backward recomputes the stem convs and the ResBlocks
    on their slabs, so the train step issues more forward halos (and, with
    GroupNorm, sums) than without it, the same backward collectives, and
    the same step."""
    for case in testing.SP_CASES:
        for res in runs["ranks"][f"train:{case}"]:
            on, off = res[True]["stats"], res[False]["stats"]
            assert on["halo"]["calls"] > off["halo"]["calls"], case
            for kind in ("halo_bwd", "sum_bwd", "gather_bwd", "gather"):
                assert on[kind]["calls"] == off[kind]["calls"], (case, kind)
            if case in ("detection_unet", "instance_norm"):
                assert on["sum"]["calls"] > off["sum"]["calls"]


def test_levels_that_split_and_replicate(runs):
    for res in runs["ranks"]["train:replicated"]:
        # P0, P2, P3, P4 split; C4 has 3 rows per rank, so C5 / P5 run whole on each rank
        assert res[True]["slab_levels"] == (True, True, True, True, False)
    for res in runs["ranks"]["train:retina_unet"]:
        assert all(res[True]["slab_levels"])


@pytest.mark.parametrize("case", JAX_CASES)
def test_spatial_train_step_matches_jax(runs, case):
    """At the first-step tolerances of ``tests/test_torch_train.py`` and
    ``tests/test_torch_detection_unet.py``: monitor values 1e-5 relative;
    gradients (optax's mu / 0.1) 1e-4 of each max, 5e-3 in the stem and the
    first ResBlock's first two convs (``EARLY``), where a gradient is a sum
    over every position that cancels; parameters as ``_check_params``."""
    monitor, mu, want_p = runs["jax"][case]
    for res in runs["ranks"][f"train:{case}"]:
        got = res[True]
        keys = set(monitor) & set(got["train"])
        assert "loss" in keys
        for k in keys:
            np.testing.assert_allclose(got["train"][k], monitor[k], rtol=1e-5, err_msg=k)
        for name, g in got["grads"].items():
            assert _rel_err(g, mu[name] / 0.1) <= (5e-3 if name.startswith(EARLY) else 1e-4), name
            _check_params(got["params"][name], want_p[name], mu[name], name, other=g)


#############################
#   a 2 x 2 grid            #
#############################

def test_grid_step_equals_the_single_process_step(runs):
    """Four ranks, two data groups of two space ranks: each data group takes
    one row of each of the 2 microbatches of the global batch of 4."""
    ref = runs["single"][testing.SP_GRID_CASE]
    ranks = runs["ranks"][f"train:{testing.SP_GRID_CASE}"]
    for res in ranks:
        _check_step(res, ref, testing.SP_GRID_CASE)
        assert res["stats"]["halo_bwd"]["calls"] > 0
    for name in ranks[0]["params"]:
        assert all(torch.equal(ranks[0]["params"][name], r["params"][name]) for r in ranks[1:]), name


#############################
#   exec                    #
#############################

def _spawn_exec(argv):
    env = dict(os.environ, OMP_NUM_THREADS="2", MDT_DIST_INIT_TIMEOUT="120")
    for key in ("MDT_DIST_COORD", "MDT_DIST_NPROCS", "MDT_DIST_RANK"):
        env.pop(key, None)
    proc = subprocess.run([sys.executable, "-c", RUN, *argv], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


class _ExecRuns:
    """The same small LIDC experiment made twice, spatial
    (``n_space_parallel = 2``) and on one process, each run as
    ``train_test`` of one epoch (``val_sampling``), then ``train`` resumed
    from its ``last_checkpoint`` to epoch 2 with ``val_patient``; the
    spatial one over two ranks that exec starts in a subprocess."""

    def __init__(self, root):
        data = os.path.join(root, "data")
        self.cfs = {tag: testing.make_lidc_experiment(root, ENV, dict(SMALL, n_space_parallel=s), n_patients=4,
                                                      shape=(16, 64, 64), seeds=(), epochs=(), data_dir=data,
                                                      exp_name=f"exp_{tag}")
                    for s, tag in ((2, "spatial"), (None, "single"))}
        self.epoch1 = os.path.join(root, "epoch1_fold_0")

    def _argv(self, tag, mode, resume=False):
        exp_dir = self.cfs[tag].exp_dir
        last = os.path.join(exp_dir, "fold_0", "last_checkpoint")
        return ["--mode", mode, "--exp_source", EXP_SOURCE, "--exp_dir", exp_dir, "--folds", "0",
                "--use_stored_settings", *(["--resume_to_checkpoint", last] * resume)]

    def _to_epoch_2(self, tag):
        """The pinned snapshot, run on to epoch 2 with val_patient validation."""
        path = os.path.join(self.cfs[tag].exp_dir, "configs.py")
        with open(path) as handle:
            text = handle.read()
        with open(path, "w") as handle:
            handle.write(text.replace("'MDT_LIDC_EPOCHS': '1'", "'MDT_LIDC_EPOCHS': '2'").replace(
                "OVERRIDES = {", "OVERRIDES = {'val_mode': 'val_patient', 'max_val_patients': 1, "))

    def spatial(self):
        _spawn_exec(self._argv("spatial", "train_test"))
        shutil.copytree(os.path.join(self.cfs["spatial"].exp_dir, "fold_0"), self.epoch1)
        self._to_epoch_2("spatial")
        _spawn_exec(self._argv("spatial", "train", resume=True))

    def single(self):
        from medicaldetectiontoolkit_torch import exec as port_exec

        port_exec.main(self._argv("single", "train"), device="cpu")
        self._to_epoch_2("single")
        port_exec.main(self._argv("single", "train", resume=True), device="cpu")


def _metrics(fold_dir):
    with open(os.path.join(fold_dir, "last_checkpoint", "monitor_metrics.pickle"), "rb") as handle:
        return pickle.load(handle)


def test_exec_train_test_over_a_space_group_equals_one_process(runs):
    """Epoch 1 (``train_test``, ``val_sampling``) and epoch 2 (resumed,
    ``val_patient``): every train and validation loss of each epoch within
    1e-5 relative of the one-process run's (``train`` and its resume);
    rank 0 alone writes."""
    exec_runs = runs["exec"]
    spatial = exec_runs.cfs["spatial"].exp_dir
    a, b = (_metrics(os.path.join(exec_runs.cfs[k].exp_dir, "fold_0")) for k in ("spatial", "single"))
    for split in ("train", "val"):
        got, want = a[split]["monitor_values"], b[split]["monitor_values"]
        assert len(got) == len(want)
        n = 0
        for ep_got, ep_want in zip(got, want):
            assert len(ep_got) == len(ep_want)
            for g, w in zip(ep_got, ep_want):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=split)
                n += np.isfinite(w["loss"])
        assert n > 0, split
    assert [len(ep) for ep in a["train"]["monitor_values"]][1:] == [2, 2]
    for k, v in b["val"].items():
        if k != "monitor_values":
            np.testing.assert_allclose(np.asarray(a["val"][k], float), np.asarray(v, float), rtol=1e-5, err_msg=k)
    # epoch 1's train_test wrote its checkpoint and tested
    assert os.path.isdir(os.path.join(exec_runs.epoch1, "last_checkpoint"))
    assert os.path.isfile(os.path.join(spatial, "results.txt"))
    with open(os.path.join(spatial, "fold_0", "exec.log")) as handle:
        log = handle.read()
    assert "spatially-partitioned training over 1x2 (data x space) ranks: rank 0 at data 0, space 0" in log
    assert "space 1" not in log  # rank 0's log alone
    assert "resumed to checkpoint" in log and "starting validation in mode val_patient" in log
