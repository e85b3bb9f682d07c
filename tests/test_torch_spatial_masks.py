"""The GT masks on Y slabs under spatial partitioning (``models/mrcnn.py``:
``MaskRCNNDetector._prep`` uploads this rank's slab of the masks, and
``mask_targets`` joins the rows the mask targets read with one exact
``mask_rows`` sum) on the CPU.

Ranks are gloo subprocesses with a hard timeout (``testing.run_ranks``; a
rank is ``python -m medicaldetectiontoolkit_torch.testing sp_rank``); four
ranks take the target layer at S = 4 (one space group) and S = 2 (a 2 x 2
grid), two the detector steps at S = 2, while this process makes the
references:

  * ``detection_target_layer`` on ``testing.sp_mask_layer_case``'s crafted
    2D and 3D batches (proposals are jittered GT boxes, some of whose crops
    cross the rows where slabs meet and some inside one slab; a positive
    assigned past the mask slots; an element with no GT), the group given
    and no spatial forward running, as the detectors call it: every output
    ``torch.equal`` to one process on the whole masks, at least 4 crops
    reading rows of two ranks at S = 2 and 6 at S = 4, each rank's masks its
    slab, one ``mask_rows`` sum of 2 x slots x mask rows x the row's bytes
    from each other rank and no other collective; one process's targets
    equal to JAX's ``detection_target_layer`` per element on JAX's draws;
  * the traps: the sum left out (a rank keeps only its own rows) and the
    rows indexed by the slab's own extent each change the target masks of
    crops that cross slabs, so the checks above reach across slabs;
  * a validation step, a train step of 2 microbatches and a second
    validation step (``testing.sp_mask_step``) of 3D Mask R-CNN and 2D
    U-Faster R-CNN+ at S = 2 against one process: monitor values 1e-6
    relative (1e-5 after Adam), gradients 1e-5 of each tensor's max (1e-3
    in the stem and the first ResBlock, ``tests/test_torch_spatial_train.py``'s
    rule), the two ranks' gradients equal; Mask R-CNN uploads its masks as
    the slab, uint8, and sends one ``mask_rows`` sum per microbatch of the
    bytes the shapes give; U-Faster R-CNN+ uploads none and sends none.
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

from medicaldetectiontoolkit_tpu.models import mrcnn as jmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch import testing  # noqa: E402
from medicaldetectiontoolkit_torch.models import mrcnn as tmrcnn  # noqa: E402
from medicaldetectiontoolkit_torch.ops import roi_align as roi_ops  # noqa: E402

torch.set_num_threads(2)
RANK = ["-m", "medicaldetectiontoolkit_torch.testing", "sp_rank"]
LOOSE = ("fpn.stem", "fpn.stages.0.0.")  # the stem and the first ResBlock
NAMES = ("rois", "slot_valid", "target_class", "target_deltas", "target_masks", "pos_mask", "mask_pos")
# crops that read rows of two ranks, at least (the crafted batch has 4 / 6-7)
STRADDLING = {2: 4, 4: 6}


def _load(out, case, world):
    return [torch.load(os.path.join(out, f"{case}_rank{r}.pt"), weights_only=False) for r in range(world)]


def _uniform(keys, n):
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def _layer_keys_and_draws(cf, elements, seed):
    """JAX's per-element keys and the port's draws from them: positives
    (b, P), SHEM's pool (b, k_pool), negatives (b, P); ``rng_neg`` draws
    twice, as in ``tests/test_torch_mrcnn_train.py``."""
    P = elements[0][0].shape[0]
    k_pool = min(cf.shem_poolsize * tmrcnn.roi_slots(cf)[1], P)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(elements))
    pos_neg = jax.vmap(jax.random.split)(keys)
    draws = (_uniform(pos_neg[:, 0], P), _uniform(pos_neg[:, 1], k_pool), _uniform(pos_neg[:, 1], P))
    return keys, [torch.from_numpy(d) for d in draws]


def _layer_reference(dim, out):
    """One process's ``detection_target_layer`` on the whole masks with
    JAX's draws (written to ``out`` for the ranks), and JAX's per element."""
    cf, elements = testing.sp_mask_layer_case(dim)
    keys, draws = _layer_keys_and_draws(cf, elements, seed=dim)
    torch.save(draws, os.path.join(out, f"mask_layer_{dim}d_draws.pt"))
    inputs = testing.sp_mask_layer_inputs(elements)
    fn = jax.jit(lambda k, *a: jmrcnn.detection_target_layer(k, *a, cf))
    jax_out = [jax.device_get(fn(k, *[jnp.asarray(a) for a in el])) for k, el in zip(keys, elements)]
    return {"cf": cf, "inputs": inputs, "one": tmrcnn.detection_target_layer(draws, *inputs, cf),
            "jax": jax_out}


def _single_step(name):
    cf, batch, init, env = testing.sp_mask_case(name)
    with testing.env_scope(env):
        return testing.sp_mask_step(cf, batch, init)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (``layer``: per rank of four; ``steps``: per case,
    per rank of two) and this process's references (``ref``: the layer per
    dim; ``single``: the one-process steps)."""
    out = str(tmp_path_factory.mktemp("sp_masks"))
    ref = {dim: _layer_reference(dim, out) for dim in (2, 3)}

    def ranks():
        testing.run_ranks([*RANK, out, "cpu", "mask_layer"], 4, 120.0)
        testing.run_ranks([*RANK, out, "cpu", *(f"mask:{c}" for c in testing.SP_MASK_CASES)], 2, 300.0)

    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(ranks)
        single = {case: _single_step(case) for case in testing.SP_MASK_CASES}
        done.result()
    return {"ref": ref, "single": single, "layer": _load(out, "mask_layer", 4),
            "steps": {case: _load(out, f"mask_{case}", 2) for case in testing.SP_MASK_CASES}}


def _ranks_at(runs, n_space, dim):
    return [(res[n_space]["space_index"], res[n_space]["dims"][dim]) for res in runs["layer"]]


def _straddling(ref, n_space):
    """(b, S) bool: the positive slots with a mask target whose crop reads
    rows of more than one rank at S = ``n_space``."""
    cf, one = ref["cf"], ref["one"]
    rois, mask_pos = one[0], one[6]
    bsz, n_pos = rois.shape[0], tmrcnn.roi_slots(cf)[0]
    masks = ref["inputs"][-1]
    y0, y1, _ = roi_ops.roi_axes(rois[:, :n_pos].reshape(-1, 2 * cf.dim), cf.mask_shape, masks.shape[2:])[0]
    rows = masks.shape[2] // n_space
    first = (torch.minimum(y0, y1).amin(dim=1) // rows).reshape(bsz, n_pos)
    last = (torch.maximum(y0, y1).amax(dim=1) // rows).reshape(bsz, n_pos)
    return (first != last) & mask_pos[:, :n_pos]


#############################
#   the target layer        #
#############################

@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_space", [2, 4])
def test_slab_target_layer_equals_one_process(runs, n_space, dim):
    ref = runs["ref"][dim]
    assert int(_straddling(ref, n_space).sum()) >= STRADDLING[n_space]
    for r, res in _ranks_at(runs, n_space, dim):
        masks = ref["inputs"][-1]
        assert res["slab_shape"] == (masks.shape[0], masks.shape[1], masks.shape[2] // n_space, *masks.shape[3:])
        for name, got, want in zip(NAMES, res["out"], ref["one"]):
            assert got.dtype == want.dtype and torch.equal(got, want), (n_space, dim, r, name)


@pytest.mark.parametrize("dim", [2, 3])
def test_crafted_batch_covers_the_cases(runs, dim):
    """Positives with mask targets, a positive past the mask slots (element
    1), an element with no GT (element 2: negatives only), and crops inside
    one slab besides the straddling ones."""
    one = runs["ref"][dim]["one"]
    pos, mask_pos = one[5], one[6]
    assert bool((pos[1] & ~mask_pos[1]).any()) and bool(one[4][1][pos[1] & ~mask_pos[1]].eq(0).all())
    assert int(pos[2].sum()) == 0 and int(one[2][2].abs().sum()) == 0 and int(one[1][2].sum()) >= 1
    n_pos = tmrcnn.roi_slots(runs["ref"][dim]["cf"])[0]
    for n_space in (2, 4):
        inside = mask_pos[:, :n_pos] & ~_straddling(runs["ref"][dim], n_space)
        assert int(inside.sum()) >= 3, n_space


@pytest.mark.parametrize("dim", [2, 3])
def test_one_process_targets_match_jax(runs, dim):
    """The port's layer on the whole masks against JAX's per element on the
    same draws (``tests/test_torch_mrcnn_train.py``'s tolerances: boxes and
    deltas 1e-5 relative plus 1e-6, the rest equal)."""
    ref = runs["ref"][dim]
    for b, want in enumerate(ref["jax"]):
        for name, t, j in zip(NAMES, ref["one"], want):
            if name in ("rois", "target_deltas"):
                np.testing.assert_allclose(t[b].numpy(), j, rtol=1e-5, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(t[b].numpy(), j, err_msg=f"element {b}: {name}")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_space", [2, 4])
def test_slab_target_layer_is_one_mask_rows_sum(runs, n_space, dim):
    """Two rows per crop row of every positive slot, valid or not, cross as
    uint8, counted at the other S - 1 ranks' rows."""
    cf = runs["ref"][dim]["cf"]
    masks = runs["ref"][dim]["inputs"][-1]
    row_bytes = int(np.prod(masks.shape[3:]))
    want = 2 * masks.shape[0] * tmrcnn.roi_slots(cf)[0] * cf.mask_shape[0] * row_bytes * (n_space - 1)
    for _, res in _ranks_at(runs, n_space, dim):
        assert res["stats"]["mask_rows"] == {"calls": 1, "bytes": want, "s": 0.0}
        assert all(v["calls"] == 0 for k, v in res["stats"].items() if k != "mask_rows")


@pytest.mark.parametrize("trap", ["skipped", "own_extent"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_space", [2, 4])
def test_traps_change_the_straddling_crops(runs, n_space, dim, trap):
    """Without the sum, or with the rows indexed in the slab, every rank's
    targets differ from one process's on some crop that crosses slabs."""
    ref = runs["ref"][dim]
    straddling = _straddling(ref, n_space)
    n_pos = straddling.shape[1]
    want = ref["one"][4][:, :n_pos]
    for r, res in _ranks_at(runs, n_space, dim):
        got = res[trap][:, :n_pos]
        differs = (got != want).flatten(2).any(dim=2)
        assert bool((differs & straddling).any()), (r, trap)


#############################
#   detector steps at S = 2 #
#############################

@pytest.mark.parametrize("case", testing.SP_MASK_CASES)
def test_spatial_mask_step_equals_one_process(runs, case):
    ref = runs["single"][case]
    ranks = runs["steps"][case]
    for res in ranks:
        for key, rtol in (("val", 1e-6), ("train", 1e-6), ("val_after", 1e-5)):
            assert set(res[key]) == set(ref[key])
            for k, v in ref[key].items():
                np.testing.assert_allclose(res[key][k], v, rtol=rtol, err_msg=f"{case} {key} {k}")
        for name, g in ref["grads"].items():
            tol = (1e-3 if name.startswith(LOOSE) else 1e-5) * float(g.abs().max())
            assert float((res["grads"][name] - g).abs().max()) <= tol, (case, name)
    for name in ref["grads"]:
        assert torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name]), name
    if case == "mrcnn":  # positive RoIs were sampled: the mask loss ran
        assert ref["train"]["mrcnn_mask_loss"] > 0 and ref["val"]["mrcnn_mask_loss"] > 0


def test_mask_rcnn_uploads_slabs_and_sums_their_rows_once_per_microbatch(runs):
    """Every target layer call (validation, two train microbatches,
    validation) is given this rank's Y slab of the masks as uint8, and each
    makes one ``mask_rows`` sum of the rows of every positive slot."""
    cf, batch, _, _ = testing.sp_mask_case("mrcnn")
    n_micro, b = cf.grad_accum_steps, cf.batch_size
    spatial = tuple(cf.patch_size)
    slab = (spatial[0] // 2,) + spatial[1:]
    rows = 2 * tmrcnn.roi_slots(cf)[0] * cf.mask_shape[0] * int(np.prod(spatial[1:]))
    whole = [((b, cf.max_gt_boxes) + spatial, "torch.uint8")]
    micro = [((b // n_micro, cf.max_gt_boxes) + spatial, "torch.uint8")] * n_micro
    assert runs["single"]["mrcnn"]["mask_uploads"] == whole + micro + whole
    for res in runs["steps"]["mrcnn"]:
        assert res["mask_uploads"] == [((shape[0], shape[1]) + slab, dtype) for shape, dtype in whole + micro + whole]
        for key in ("val", "train", "val_after"):
            n = n_micro if key == "train" else 1
            assert res["step_stats"][key]["mask_rows"] == {"calls": n, "bytes": rows * b, "s": 0.0}, key


def test_ufrcnn_uploads_no_masks_and_sums_no_rows(runs):
    assert runs["single"]["ufrcnn"]["mask_uploads"] == [None] * 3
    for res in runs["steps"]["ufrcnn"]:
        assert res["mask_uploads"] == [None] * 3
        assert all(stats["mask_rows"]["calls"] == 0 for stats in res["step_stats"].values())
