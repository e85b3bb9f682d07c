"""The selection order of the CUDA NMS kernel (``csrc/nms.cu``), modelled in
numpy, against the port's plain ``batched_nms`` and JAX's ``nms_pallas``
(interpret mode).

The model follows the kernel's algorithm step by step: compact each lane to
its valid entries with a score above -inf, in index order; if the compacted
scores do not increase, walk them in order in tiles (the first as wide as
the keep slots left, rounded up to 32, then doubling): a. each candidate is
tested against the boxes kept so far; b. each surviving candidate's row of a
bitmask marks the later surviving candidates of the tile it suppresses; c.
the tile is resolved in order, 32 candidates (one word) at a time: a run of
open candidates before the first whose row is not empty is kept in one
step, that one is kept alone and its row removes what it suppresses, and no
more than the keep slots left are kept; the walk stops at max_output kept.
Otherwise it runs max_output argmax-and-suppress steps over the compacted
entries. A small tile (8) crosses many tile boundaries. Every IoU decision
is the kernel's ``suppresses``: float32 in the plain version's operation
order with the earlier kept box as the winner, decided by the product inter
> thresh * union outside a 1e-5 band around it and by the division inside.

Tolerance: none. Keep lists (idx and mask) must be identical, and
``suppresses`` must equal the plain version's ``IoU > thresh`` on every pair.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from medicaldetectiontoolkit_tpu.ops.nms_pallas import nms_pallas  # noqa: E402
from medicaldetectiontoolkit_torch.ops import nms as tnms  # noqa: E402

torch.set_num_threads(2)
F32 = np.float32


def inter_union_f32(w, b, off):
    """Intersection and union of the winner box w (2d,) with boxes b (m, 2d),
    float32, in the order of ``ops/nms.py::_iou_rows`` and the kernel's
    ``suppresses``."""
    dim = w.shape[0] // 2
    off = F32(off)
    inter = np.ones(b.shape[0], F32)
    area_w = F32(1.0)
    area = np.ones(b.shape[0], F32)
    for ax in range(dim):
        lo_i, hi_i = (0, 2) if ax == 0 else (1, 3) if ax == 1 else (4, 5)
        seg = np.minimum(w[hi_i], b[:, hi_i]) - np.maximum(w[lo_i], b[:, lo_i]) + off
        inter = inter * np.maximum(seg, F32(0.0))
        area_w = area_w * (w[hi_i] - w[lo_i] + off)
        area = area * (b[:, hi_i] - b[:, lo_i] + off)
    return inter, area_w + area - inter


def iou_f32(w, b, off):
    """The plain version's IoU of w against b."""
    inter, union = inter_union_f32(w, b, off)
    pos = union > 0
    return np.where(pos, inter / np.where(pos, union, F32(1.0)), F32(0.0)).astype(F32)


def suppresses(w, b, off, thresh):
    """The kernel's decision IoU(w, b) > thresh for each row of b, and where
    the product could not decide it (the 1e-5 band, or a product outside
    (1e-30, 1e30)) and the division did."""
    thresh = F32(thresh)
    inter, union = inter_union_f32(w, b, off)
    p = thresh * union
    clear = (p > F32(1e-30)) & (p < F32(1e30))
    above = clear & (inter > p * F32(1.00001))
    below = clear & (inter < p * F32(0.99999))
    pos = union > 0
    divided = inter / np.where(pos, union, F32(1.0)) > thresh
    decided = np.where(above, True, np.where(below, False, divided))
    return np.where(pos, decided, F32(0.0) > thresh), pos & ~above & ~below


def resolve_tile(rows, dead, budget):
    """Step c of the sorted walk: the tile's kept columns, in order."""
    cnt = dead.shape[0]
    removed = dead.copy()
    hot = rows.any(1)
    keep = []
    for q in range(0, cnt, 32):
        word = np.arange(q, min(q + 32, cnt))
        while len(keep) < budget:
            open_ = word[~removed[word]]
            if open_.size == 0:
                break
            first_hot = open_[hot[open_]][:1]
            run = open_[open_ < first_hot[0]] if first_hot.size else open_
            if run.size:
                keep += run[:budget - len(keep)].tolist()
                removed[run] = True
            else:
                i = int(first_hot[0])
                keep.append(i)
                removed |= rows[i]
                removed[i] = True
    return keep


def model_lane(boxes, scores, valid, thresh, max_out, off, tile):
    """One lane through the kernel's algorithm, its tiles at most ``tile``
    wide (the kernel's 256, or fewer to cross more tile boundaries).
    Returns (kept original indices, 'sorted' or 'argmax')."""
    ok = scores > -np.inf if valid is None else valid & (scores > -np.inf)
    pos = np.flatnonzero(ok)  # compaction: index order
    cb, cs = boxes[pos], scores[pos]
    m = pos.size
    kept = []
    if not np.any(cs[1:] > cs[:-1]):
        kept_boxes = []
        p0, width = 0, 16
        while p0 < m and len(kept) < max_out:
            # as wide as the keep slots left (rounded up to 32), then doubling
            width = min(tile, max(2 * width, -(-(max_out - len(kept)) // 32) * 32))
            tb = cb[p0:p0 + width]
            cnt = tb.shape[0]
            dead = np.zeros(cnt, bool)
            for kb in kept_boxes:  # a. against the boxes kept so far
                dead |= suppresses(kb, tb, off, thresh)[0]
            rows = np.zeros((cnt, cnt), bool)  # b. rows[i, j]: i suppresses j > i, both alive
            for i in np.flatnonzero(~dead):
                rows[i, i + 1:] = suppresses(tb[i], tb[i + 1:], off, thresh)[0] & ~dead[i + 1:]
            for i in resolve_tile(rows, dead, max_out - len(kept)):  # c.
                kept.append(int(pos[p0 + i]))
                kept_boxes.append(tb[i])
            p0 += width
        path = "sorted"
    else:
        active = cs.copy()
        for _ in range(max_out):
            w = int(np.argmax(active))  # first maximum: lower index on ties
            if not active[w] > -np.inf:
                break
            kept.append(int(pos[w]))
            kill = suppresses(cb[w], cb, off, thresh)[0]
            kill[w] = True
            active = np.where(kill, F32(-np.inf), active)
        path = "argmax"
    return kept, path


def model_batched(boxes, scores, valid, thresh, max_out, off, tile):
    L = scores.shape[0]
    idx = np.full((L, max_out), -1, np.int32)
    mask = np.zeros((L, max_out), bool)
    paths = []
    for lane in range(L):
        kept, path = model_lane(boxes[lane], scores[lane], None if valid is None else valid[lane], thresh, max_out,
                                off, tile)
        idx[lane, :len(kept)] = kept
        mask[lane, :len(kept)] = True
        paths.append(path)
    return idx, mask, paths


def _boxes(rng, L, n, dim, integer=False, extent=80.0, size=30.0):
    lo = rng.rand(L, n, dim) * extent
    hi = lo + rng.rand(L, n, dim) * size + 1.0
    if integer:
        lo, hi = np.round(lo), np.round(hi)
    cols = [lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]] + ([lo[..., 2], hi[..., 2]] if dim == 3 else [])
    return np.stack(cols, -1).astype(F32)


def _desc(x):
    return (-np.sort(-x, axis=-1)).astype(F32)


def _refine_lanes(rng, n_roi, n_fg, bsz, sorted_scores):
    """Candidates as the refinement steps build them: one broadcast array,
    one lane per (element, class) marking its own candidates valid.
    Retina U-Net (sorted_scores): a top-k over all candidates, so each lane
    sees a descending subsequence. Mask R-CNN: class scores per RoI
    (class-major), unsorted, those below 0.1 invalid."""
    n = n_roi * n_fg
    boxes = _boxes(rng, 1, n, 3, integer=True, extent=40, size=12)
    lane_elem, lane_class = np.repeat(np.arange(bsz), n_fg), np.tile(np.arange(1, n_fg + 1), bsz)
    if sorted_scores:
        scores = _desc((rng.rand(n) * 50).round() / 50.0)
        cand_elem, cand_class = rng.randint(0, bsz, n), rng.randint(1, n_fg + 1, n)
        ok = np.ones(n, bool)
    else:
        scores = rng.rand(n).astype(F32)
        cand_elem = np.repeat(np.arange(n_roi) // (n_roi // bsz), n_fg)
        cand_class = np.tile(np.arange(1, n_fg + 1), n_roi)
        ok = scores >= 0.1
    valid = ok[None] & (cand_elem[None] == lane_elem[:, None]) & (cand_class[None] == lane_class[:, None])
    L = bsz * n_fg
    return np.repeat(boxes, L, 0), np.repeat(scores[None], L, 0), valid


def make_case(name):
    """(boxes (L, N, 2d), scores (L, N), valid (L, N)|None, thresh, max_out,
    the path every lane with a candidate must take or None)."""
    rng = np.random.RandomState(sorted(CASES).index(name))
    if name == "random_2d":
        return _boxes(rng, 3, 150, 2), rng.rand(3, 150).astype(F32), rng.rand(3, 150) < 0.8, 0.4, 20, "argmax"
    if name == "random_3d":
        return _boxes(rng, 3, 150, 3), rng.rand(3, 150).astype(F32), None, 0.3, 20, "argmax"
    if name == "sorted_random_3d":
        return _boxes(rng, 3, 150, 3, extent=40), _desc(rng.rand(3, 150)), None, 0.3, 30, "sorted"
    if name == "sorted_random_2d":
        return _boxes(rng, 3, 150, 2, extent=40), _desc(rng.rand(3, 150)), None, 0.2, 30, "sorted"
    if name == "ties_int_2d":
        return (_boxes(rng, 2, 128, 2, integer=True, extent=20, size=5),
                (rng.randint(0, 8, (2, 128)) / 8.0).astype(F32), None, 0.1, 40, "argmax")
    if name == "sorted_ties_int_3d":
        # equal scores in runs of ~40, across many 8-candidate tiles
        return (_boxes(rng, 2, 160, 3, integer=True, extent=20, size=5),
                _desc(rng.randint(0, 4, (2, 160)) / 4.0), None, 0.1, 40, "sorted")
    if name == "sorted_all_equal_2d":
        return (_boxes(rng, 2, 100, 2, integer=True, extent=15, size=5), np.full((2, 100), 0.5, F32), None, 0.1,
                40, "sorted")
    if name == "sorted_behind_valid":
        # unsorted where invalid entries sit: the compacted lane is sorted
        s = _desc(rng.rand(3, 150))
        valid = rng.rand(3, 150) < 0.6
        s = np.where(valid, s, rng.rand(3, 150).astype(F32))
        return _boxes(rng, 3, 150, 3, extent=40), s, valid, 0.3, 30, "sorted"
    if name == "broadcast_retina_refine":
        b, s, v = _refine_lanes(rng, 100, 2, 2, sorted_scores=True)
        return b, s, v, 1e-5, 10, "sorted"
    if name == "broadcast_mrcnn_refine":
        b, s, v = _refine_lanes(rng, 100, 2, 2, sorted_scores=False)
        return b, s, v, 1e-5, 10, "argmax"
    if name == "mixed_lanes":
        s = rng.rand(3, 120).astype(F32)
        s[0], s[2] = _desc(s[0]), _desc(s[2])
        return _boxes(rng, 3, 120, 3, extent=40), s, None, 0.3, 25, None
    if name == "all_invalid_lane":
        valid = rng.rand(3, 64) < 0.5
        valid[1] = False
        s = rng.rand(3, 64).astype(F32)
        s[0] = _desc(s[0])
        return _boxes(rng, 3, 64, 3), s, valid, 0.5, 8, None
    if name == "sorted_max_output_gt_survivors":
        return _boxes(rng, 2, 20, 3, integer=True, extent=5), _desc(rng.rand(2, 20)), None, 0.0, 32, "sorted"
    if name == "max_output_gt_survivors":
        return _boxes(rng, 2, 20, 3, integer=True, extent=5), rng.rand(2, 20).astype(F32), None, 0.0, 32, "argmax"
    raise KeyError(name)


CASES = ("random_2d", "random_3d", "sorted_random_3d", "sorted_random_2d", "ties_int_2d", "sorted_ties_int_3d",
         "sorted_all_equal_2d", "sorted_behind_valid", "broadcast_retina_refine", "broadcast_mrcnn_refine",
         "mixed_lanes", "all_invalid_lane", "sorted_max_output_gt_survivors", "max_output_gt_survivors")


@functools.lru_cache(maxsize=None)
def references(name, pixel_offset):
    """(case, plain batched_nms result, JAX nms_pallas interpret result)."""
    boxes, scores, valid, thresh, max_out, path = make_case(name)
    tv = None if valid is None else torch.from_numpy(valid)
    t_idx, t_mask = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, max_out, valid=tv,
                                     pixel_offset=pixel_offset)
    jv = None if valid is None else jnp.asarray(valid)
    p_idx, p_mask = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out, valid=jv,
                               pixel_offset=pixel_offset, interpret=True)
    return ((boxes, scores, valid, thresh, max_out, path), (t_idx.numpy(), t_mask.numpy()),
            (np.asarray(p_idx), np.asarray(p_mask)))


@pytest.mark.parametrize("tile", [8, 256])
@pytest.mark.parametrize("pixel_offset", [0.0, 1.0])
@pytest.mark.parametrize("name", CASES)
def test_kernel_order_model_matches_plain_and_pallas(name, pixel_offset, tile):
    (boxes, scores, valid, thresh, max_out, path), plain, pallas = references(name, pixel_offset)
    idx, mask, paths = model_batched(boxes, scores, valid, thresh, max_out, pixel_offset, tile)
    for ref_idx, ref_mask in (plain, pallas):
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_array_equal(mask, ref_mask)
    if path is not None:
        live = [p for p, lane_valid in zip(paths, valid if valid is not None else [None] * len(paths))
                if lane_valid is None or lane_valid.any()]
        assert set(live) == {path}
    if name == "mixed_lanes":
        assert paths == ["sorted", "argmax", "sorted"]
    if name == "all_invalid_lane":
        assert not mask[1].any() and (idx[1] == -1).all()
    if name.startswith("sorted"):
        assert mask.any()


def test_sorted_walk_crosses_tiles():
    """The sorted cases keep boxes in more than one 8-candidate tile and
    drop candidates both against earlier tiles and inside a tile."""
    boxes, scores, _, thresh, max_out, _ = make_case("sorted_ties_int_3d")
    kept, path = model_lane(boxes[0], scores[0], None, thresh, max_out, 1.0, 8)
    assert path == "sorted"
    tiles = {k // 8 for k in kept}
    assert len(tiles) > 3 and len(kept) < scores.shape[1]


@pytest.mark.parametrize("pixel_offset", [0.0, 1.0])
@pytest.mark.parametrize("name", CASES)
def test_suppresses_equals_plain_iou_test(name, pixel_offset):
    """The kernel's product-first decision equals the plain version's
    IoU > thresh on every ordered pair of a lane's boxes; the integer boxes
    with tied IoUs put pairs inside the band, where the division decides."""
    boxes, _, _, thresh, _, _ = make_case(name)
    lane = boxes[0]
    in_band = 0
    for i in range(lane.shape[0]):
        got, band = suppresses(lane[i], lane, pixel_offset, thresh)
        np.testing.assert_array_equal(got, iou_f32(lane[i], lane, pixel_offset) > F32(thresh))
        in_band += int(band.sum())
    if name in ("ties_int_2d", "sorted_ties_int_3d", "sorted_all_equal_2d"):
        assert in_band > 0


def test_tile_resolution_keeps_runs_and_stops_at_the_budget():
    """Step c on a hand-made 40-column tile: runs before a non-empty row
    kept whole, that row's columns removed across the word boundary, the
    budget cut inside a run."""
    cnt = 40
    dead = np.zeros(cnt, bool)
    dead[[2, 35]] = True
    rows = np.zeros((cnt, cnt), bool)
    rows[4, [5, 33]] = True  # 4 suppresses 5 and, in the next word, 33
    rows[5, 6] = True        # 5 is suppressed, so its row never applies
    want = [0, 1, 3, 4] + list(range(6, 32)) + [32, 34] + list(range(36, 40))
    assert resolve_tile(rows, dead, cnt) == want
    assert resolve_tile(rows, dead, 10) == want[:10]
