"""The P0 segmentation path on Y slabs under spatial partitioning
(``parallel/mesh.py``: the seg labels, the seg logits, the seg loss's sums
and seg_preds stay on each rank's slab) on the CPU.

Ranks are gloo subprocesses with a hard timeout (``testing.run_ranks``; a
rank is ``python -m medicaldetectiontoolkit_torch.testing sp_rank``); four
ranks take the loss at S = 4 (one space group) and S = 2 (a 2 x 2 grid), two
the detector steps at S = 2, while this process makes the references:

  * ``fused_seg_loss`` on the slabs, the group given and no spatial forward
    running (as the detectors call it), on ``testing.sp_seg_loss_cases``
    (2 and 3 classes, 2D and 3D, false-positive weights 1, 2.5 and 0.5, with
    and without class weights): dice and CE within 1e-10 of the whole loss
    in float64; each slab's logits gradient of dice + CE S times the
    matching rows of the whole one within 1e-10 of its max; in float32
    within 1e-6 relative of JAX's ``fused_seg_loss`` on the same inputs (of
    the exact loss, and of JAX's plus JAX's own distance from it for the
    weighted CE, where XLA's float32 misses the exact value by 1.3e-6);
    one ``sum`` and one ``sum_bwd`` of 3 C + 1 float64 values (3 C + 2 with
    class weights) each, and no gather. The same loss with its sums' ``space_sum``
    given no group (the identity after the forward: the trap of a loss
    that relies on ``mesh.space()``) misses the whole loss by more than
    1e-3, so the checks above catch it;
  * a validation step, a train step and a test forward (seg_preds asked for
    in every convert; ``testing.sp_seg_step``) of 3D Retina U-Net, 2D
    U-Faster R-CNN+ and 2D Detection U-Net in its ``dice``, ``wce`` and
    ``dice_wce`` modes at S = 2 against one process: monitor values 1e-6
    relative, gradients 1e-5 of each tensor's max (1e-3 in the stem and the
    first ResBlock, ``tests/test_torch_spatial_train.py``'s rule), seg_preds
    bit-identical, the two ranks' gradients equal;
  * the collectives' counts: a train step's gathers are the heads' alone
    (Retina U-Net, U-Faster R-CNN+: their bytes as the arithmetic gives
    them, forward and backward) plus one seg ``sum`` and one ``sum_bwd``;
    seg_preds cross in each convert as one uint8 gather of the slab's
    bytes; Detection U-Net gathers its softmax detached (float32, no
    ``gather_bwd``) in the dispatch and nothing in the convert;
  * ``replicated_p0``: 2D Retina U-Net with P0's fence made to gather (every
    level replicated): the seg path runs whole, its loss with no ``sum``,
    and the step equals one process.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu.ops import losses as jlosses  # noqa: E402
from medicaldetectiontoolkit_torch import testing  # noqa: E402
from medicaldetectiontoolkit_torch.ops import losses as tlosses  # noqa: E402

torch.set_num_threads(2)
RANK = ["-m", "medicaldetectiontoolkit_torch.testing", "sp_rank"]
LOOSE = ("fpn.stem", "fpn.stages.0.0.")  # the stem and the first ResBlock
LOSS_CASES = [case[0] for case in testing.sp_seg_loss_cases()]
HEAD_CASES = ("retina_unet", "ufrcnn")
DET_UNET_CASES = ("dice", "wce", "dice_wce")


def _load(out, case, world):
    return [torch.load(os.path.join(out, f"{case}_rank{r}.pt"), weights_only=False) for r in range(world)]


def _single(case):
    cf, batch, env = testing.sp_seg_case(case)
    with testing.env_scope(env):
        return testing.sp_seg_step(cf, batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (``loss``: per rank of four; ``steps``: per case,
    per rank of two) and the one-process steps (``single``)."""
    out = str(tmp_path_factory.mktemp("sp_seg"))

    def ranks():
        testing.run_ranks([*RANK, out, "cpu", "seg_loss"], 4, 120.0)
        testing.run_ranks([*RANK, out, "cpu", *(f"seg:{c}" for c in testing.SP_SEG_CASES)], 2, 300.0)

    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(ranks)
        single = {case: _single(case) for case in testing.SP_SEG_CASES}
        done.result()
    return {"loss": _load(out, "seg_loss", 4), "single": single,
            "steps": {case: _load(out, f"seg_{case}", 2) for case in testing.SP_SEG_CASES}}


def _loss_case(name):
    return next(case for case in testing.sp_seg_loss_cases() if case[0] == name)


def _whole(name, dtype=torch.float64):
    """(dice, CE, the logits' gradient of dice + CE) of the whole loss on one process."""
    _, logits, seg, n_classes, fpw, weights = _loss_case(name)
    x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
    dice, ce = tlosses.fused_seg_loss(x, torch.from_numpy(seg), n_classes, fpw, weights)
    (dice + ce).backward()
    return float(dice.detach()), float(ce.detach()), x.grad


def _ranks_at(runs, n_space):
    return [(res[n_space]["space_index"], res[n_space]["cases"]) for res in runs["loss"]]


#############################
#   the slab loss           #
#############################

@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("name", LOSS_CASES)
def test_slab_seg_loss_equals_the_whole_loss_in_float64(runs, name, n_space):
    dice, ce, _ = _whole(name)
    for _, cases in _ranks_at(runs, n_space):
        got = cases[name][str(torch.float64)]
        assert abs(float(got["dice"]) - dice) <= 1e-10 and abs(float(got["ce"]) - ce) <= 1e-10 * max(1.0, abs(ce))


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("name", LOSS_CASES)
def test_slab_seg_loss_gradient_is_s_times_the_whole_rows(runs, name, n_space):
    """Every rank seeds the replicated loss with 1 and the sums' backward
    all-reduces, so a slab's logits get S times their gradient, which the
    one division by S before Adam puts right (``parallel/mesh.py``)."""
    want = n_space * _whole(name)[2]
    n = want.shape[2] // n_space
    for r, cases in _ranks_at(runs, n_space):
        got = cases[name][str(torch.float64)]["grad"]
        assert got.shape == want[:, :, r * n:(r + 1) * n].shape
        assert float((got - want[:, :, r * n:(r + 1) * n]).abs().max()) <= 1e-10 * float(want.abs().max())


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("name", LOSS_CASES)
def test_slab_seg_loss_matches_jax_in_float32(runs, name, n_space):
    """Within 1e-6 relative of JAX's float32 loss on the float32 inputs, and
    of the exact (float64) loss. XLA's float32 weighted CE itself lies up
    to a few 1e-6 from the exact value (1.3e-6 in ``c3_weighted``), so
    there the bound against JAX is its own distance from the exact value
    plus 1e-6."""
    _, logits, seg, n_classes, fpw, weights = _loss_case(name)
    x32 = logits.astype(np.float32)
    want = jlosses.fused_seg_loss(jnp.asarray(np.moveaxis(x32, 1, -1)), jnp.asarray(seg), n_classes,
                                  false_positive_weight=fpw, class_weights=weights)
    x = torch.from_numpy(x32.astype(np.float64))
    exact = tlosses.fused_seg_loss(x, torch.from_numpy(seg), n_classes, fpw, weights)
    for _, cases in _ranks_at(runs, n_space):
        got = cases[name][str(torch.float32)]
        for key, w, e in zip(("dice", "ce"), want, exact):
            g, w, e = float(got[key]), float(w), float(e)
            assert got[key].dtype == torch.float32
            assert abs(g - e) <= 1e-6 * abs(e), key
            slack = abs(w - e) if (key == "ce" and weights is not None) else 0.0
            assert abs(g - w) <= 1e-6 * abs(w) + slack, (key, g, w, e)


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("name", LOSS_CASES)
def test_slab_seg_loss_is_one_sum_and_one_sum_bwd(runs, name, n_space):
    """The per-class intersections, probability sums and counts, the CE's
    numerator and (weighted) its denominator cross as one float64 buffer,
    each way, counted at the other S - 1 ranks' values."""
    _, _, _, n_classes, _, weights = _loss_case(name)
    n_values = 3 * n_classes + (1 if weights is None else 2)
    for _, cases in _ranks_at(runs, n_space):
        for dtype in (torch.float64, torch.float32):
            stats = cases[name][str(dtype)]["stats"]
            for kind in ("sum", "sum_bwd"):
                assert stats[kind]["calls"] == 1
                assert stats[kind]["bytes"] == n_values * 8 * (n_space - 1)
            assert all(stats[k]["calls"] == 0 for k in ("halo", "gather", "halo_bwd", "gather_bwd"))


@pytest.mark.parametrize("name", LOSS_CASES)
def test_seg_sums_that_skip_the_group_miss_the_whole_loss(runs, name):
    """After the forward ``mesh.space()`` is None, so a ``space_sum`` not
    given the group adds nothing; the loss of such slab sums lies more than
    1e-3 from the whole one, which the 1e-10 checks above would catch."""
    dice, ce, _ = _whole(name)
    for n_space in (2, 4):
        for _, cases in _ranks_at(runs, n_space):
            d, c = cases[name]["dropped"]
            assert max(abs(d - dice), abs(c - ce)) > 1e-3


#############################
#   detector steps at S = 2 #
#############################

@pytest.mark.parametrize("case", testing.SP_SEG_CASES)
def test_spatial_seg_step_equals_one_process(runs, case):
    ref = runs["single"][case]
    ranks = runs["steps"][case]
    for res in ranks:
        for key in ("val", "train"):
            assert set(res[key]) == set(ref[key])
            for k, v in ref[key].items():
                np.testing.assert_allclose(res[key][k], v, rtol=1e-6, err_msg=f"{case} {key} {k}")
        for name, g in ref["grads"].items():
            tol = (1e-3 if name.startswith(LOOSE) else 1e-5) * float(g.abs().max())
            assert float((res["grads"][name] - g).abs().max()) <= tol, (case, name)
        for key in ("val_seg_preds", "train_seg_preds", "test_seg_preds"):
            assert res[key].dtype == ref[key].dtype == np.uint8
            np.testing.assert_array_equal(res[key], ref[key], err_msg=f"{case} {key}")
    for name in ref["grads"]:
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name]), name
    if case in ("retina_unet", "replicated_p0"):
        assert {"seg_dice_loss", "seg_ce_loss"} <= set(ref["train"])


def _level_voxels(cf):
    """Voxels of each pyramid level the heads read (P2..P5)."""
    return [int(np.prod(shape)) for shape in cf.backbone_shapes]


def _head_channels(cf):
    """Channels a level's gathered tensors hold: Retina's class and box
    heads; the RPN's logits and deltas and the map itself (U-Faster
    R-CNN+)."""
    A = cf.n_anchors_per_pos
    if cf.model == "retina_unet":
        return A * (cf.head_classes + 2 * cf.dim)
    return A * (2 + 2 * cf.dim) + cf.end_filts


@pytest.mark.parametrize("case", HEAD_CASES)
def test_a_train_step_gathers_the_heads_and_sums_the_seg_loss(runs, case):
    """No full-resolution float seg tensor crosses in a train or validation
    step: the gathers are the heads' (``_head_channels``) forward and
    backward, and the seg loss adds one ``sum`` and one ``sum_bwd`` of
    3 C + 1 float64 values (no GroupNorm: norm None)."""
    cf, _, _ = testing.sp_seg_case(case)
    per_level = 3 if case == "ufrcnn" else 2
    whole = sum(cf.batch_size * _head_channels(cf) * v * 4 for v in _level_voxels(cf))
    seg_bytes = (3 * cf.num_seg_classes + 1) * 8
    for res in runs["steps"][case]:
        assert all(res["slab_levels"])
        train, val = res["stats"]["train_dispatch"], res["stats"]["val_dispatch"]
        for stats in (train, val):
            assert stats["gather"]["calls"] == per_level * len(cf.pyramid_levels)
            assert stats["gather"]["bytes"] == whole // 2  # the other rank's slab of each
            assert stats["sum"] == {"calls": 1, "bytes": seg_bytes, "s": 0.0}
        assert train["gather_bwd"]["calls"] == per_level * len(cf.pyramid_levels)
        assert train["gather_bwd"]["bytes"] == whole  # the other rank's gradient of each whole tensor
        assert train["sum_bwd"] == {"calls": 1, "bytes": seg_bytes, "s": 0.0}
        assert val["gather_bwd"]["calls"] == val["sum_bwd"]["calls"] == 0


@pytest.mark.parametrize("case", HEAD_CASES)
def test_seg_preds_cross_as_uint8_in_the_convert(runs, case):
    """seg_preds are the slab's argmax, joined as one uint8 gather in each
    convert that asks for them (the test forward's dispatch gathers only the
    heads)."""
    cf, _, _ = testing.sp_seg_case(case)
    slab_bytes = cf.batch_size * int(np.prod(cf.patch_size)) // 2
    for res in runs["steps"][case]:
        for key in ("val_convert", "train_convert", "test_convert"):
            stats = res["stats"][key]
            assert stats["gather"] == {"calls": 1, "bytes": slab_bytes, "s": 0.0}, key
            assert all(stats[k]["calls"] == 0 for k in ("halo", "sum", "halo_bwd", "sum_bwd", "gather_bwd"))
        test = res["stats"]["test_dispatch"]
        per_level = 3 if case == "ufrcnn" else 2
        assert test["gather"]["calls"] == per_level * len(cf.pyramid_levels)


@pytest.mark.parametrize("case", DET_UNET_CASES)
def test_detection_unet_gathers_its_softmax_detached(runs, case):
    """The softmax is computed on the slab and joined in float32 (the
    logits' bytes) with no backward; the weighted seg loss adds one ``sum``
    and one ``sum_bwd`` of 3 C + 2 float64 values; the converts move
    nothing."""
    cf, _, _ = testing.sp_seg_case(case)
    smax_bytes = cf.batch_size * cf.num_seg_classes * int(np.prod(cf.patch_size)) // 2 * 4
    seg_bytes = (3 * cf.num_seg_classes + 2) * 8
    for res in runs["steps"][case]:
        for key in ("val_dispatch", "train_dispatch", "test_dispatch"):
            stats = res["stats"][key]
            assert stats["gather"] == {"calls": 1, "bytes": smax_bytes, "s": 0.0}, key
            assert stats["gather_bwd"]["calls"] == 0
            assert stats["sum"] == ({"calls": 0, "bytes": 0, "s": 0.0} if key == "test_dispatch"
                                    else {"calls": 1, "bytes": seg_bytes, "s": 0.0}), key
        assert res["stats"]["train_dispatch"]["sum_bwd"] == {"calls": 1, "bytes": seg_bytes, "s": 0.0}
        for key in ("val_convert", "train_convert", "test_convert"):
            assert all(v["calls"] == 0 for v in res["stats"][key].values()), key


def test_a_replicated_p0_takes_the_seg_loss_whole(runs):
    """With P0's fence made to gather, the image is joined once and every
    level runs replicated: the labels go up whole, the loss takes no
    ``sum``, seg_preds need no join, and the step is the one-process step
    (``test_spatial_seg_step_equals_one_process``)."""
    cf, _, _ = testing.sp_seg_case("replicated_p0")
    image_bytes = cf.batch_size * cf.n_channels * int(np.prod(cf.patch_size)) // 2 * 4
    for res in runs["steps"]["replicated_p0"]:
        assert not any(res["slab_levels"])
        for key, stats in res["stats"].items():
            if key.endswith("dispatch"):
                assert stats["gather"] == {"calls": 1, "bytes": image_bytes, "s": 0.0}, key
            else:
                assert stats["gather"]["calls"] == 0, key
            assert all(stats[k]["calls"] == 0 for k in ("halo", "sum", "halo_bwd", "sum_bwd", "gather_bwd")), key
