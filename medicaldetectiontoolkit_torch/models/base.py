"""Shared detector machinery of the port: batch upload, results assembly,
the optimizer and gradient accumulation, and the ``Detector`` host API.

Counterpart of ``medicaldetectiontoolkit_tpu/models/base.py``. The outer
contract is the JAX package's (and the reference's): batch dicts are NumPy,
channel-first ``(b, c, y, x, (z))``; ``test_forward`` returns
``{"boxes": [[box dicts]], "seg_preds": (b, 1, *spatial) uint8}``;
``train_forward`` adds ``loss``, ``monitor_values`` and ``logger_string``.
Device tensors stay channel-first, as torch convolutions take them.

``*_forward_dispatch`` only enqueues CUDA work and returns un-synchronised
tensors; ``*_forward_convert`` does the device->host copy. That keeps the
Predictor's in-flight window of dispatched chunks (``predictor.py:374-417``)
and the trainer's pipelined steps overlapping host work with device work.
A training step's small results are copied by ``start_host_copies`` at the
end of its dispatch: on one CUDA stream a copy made in ``convert`` would
also wait for every step dispatched after this one.
The inference handles are ``(with_masks, (det, det_mask, det_masks_raw,
seg_preds))`` for every detector: the one-stage detectors
(``retina_net.py``) leave ``det_masks_raw`` None, the two-stage ones
(``mrcnn.py``) fill it when masks are asked for.

Every detector trains (``retina_net.py``, ``mrcnn.py``): Adam with the lr
set per step, gradient accumulation over microbatches, and the optimizer
state in ``state_dict``. After ``enable_data_parallel`` a detector is one
rank of a data-parallel run (``parallel/mesh.py``): its batches hold this
rank's rows, its steps equal the single-card step on the global batch.
After ``enable_spatial_parallel_inference`` its test forwards run on this
rank's Y slab of each uploaded batch within its space group and give the
single-process outputs on every rank of the group; after
``enable_spatial_parallel`` its train and validation steps do too, over a
(data x space) grid, and equal the single-card step on the global batch.

Every dispatch draws a request id (``utils/trace.py``) and returns its
handles as ``Handles``: a tuple, opened as before, that carries the id as
``rid``; the convert's spans take the id from the handles, so one step's or
chunk's spans share it even with step i + 1 dispatched before step i is
converted. The spans of the stages (``dispatch``, ``upload``, ``forward``,
``losses``, ``backward``, ``update``, ``refine``, ``host_copies``,
``convert``, ``wait``, ``assemble``) record only while tracing is on.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from medicaldetectiontoolkit_torch.ops.topk import top_k
from medicaldetectiontoolkit_torch.utils import trace


def default_device() -> torch.device:
    """The CUDA card. Without one this raises: the CPU, which runs the plain
    PyTorch versions of every kernel, is taken only when asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def host_to_device(array, device: torch.device, dtype=np.float32) -> torch.Tensor:
    """numpy (e.g. a (b, c, *spatial) image batch) -> tensor of ``dtype`` on
    ``device``, same layout.

    A CUDA upload goes through pinned memory with ``non_blocking=True``: a
    pageable copy would synchronise the stream, so dispatching a batch would
    wait for the previous batch's device work.
    """
    t = torch.from_numpy(np.ascontiguousarray(array, dtype=dtype))
    trace.count("upload.bytes", t.nbytes)
    trace.count("upload.calls", 1)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pad_gt_boxes(gt_boxes_list, gt_ids_list, batch_size: int, dim: int, max_gt: int, device: torch.device):
    """Per-element GT box lists -> (b, max_gt, 2*dim) float32 boxes, (b,
    max_gt) int32 ids and bool valid mask on ``device`` (``base.py:37-53``).
    GTs beyond ``max_gt`` are dropped, as in JAX."""
    boxes = np.zeros((batch_size, max_gt, 2 * dim), dtype=np.float32)
    ids = np.zeros((batch_size, max_gt), dtype=np.int32)
    valid = np.zeros((batch_size, max_gt), dtype=bool)
    for b in range(batch_size):
        g = np.asarray(gt_boxes_list[b], dtype=np.float32).reshape(-1, 2 * dim)
        n = min(len(g), max_gt)
        boxes[b, :n] = g[:n]
        ids[b, :n] = np.asarray(gt_ids_list[b], dtype=np.int32).reshape(-1)[:n]
        valid[b, :n] = True
    return (host_to_device(boxes, device), host_to_device(ids, device, np.int32),
            host_to_device(valid, device, bool))


def detections_to_box_results(cf, detections, det_mask, box_results_list=None):
    """Fixed-shape detections -> the reference results 'boxes' lists.

    detections: (b, max_det, 2*dim + 2) = coords (rounded), class_id, score,
    as numpy. Applies the reference's zero-area and min-confidence filters
    (``base.py:56-83``).
    """
    detections = np.asarray(detections)
    det_mask = np.asarray(det_mask)
    bsz = detections.shape[0]
    if box_results_list is None:
        box_results_list = [[] for _ in range(bsz)]
    ncoords = 2 * cf.dim
    served = 0
    for b in range(bsz):
        for i in np.flatnonzero(det_mask[b]):
            coords = detections[b, i, :ncoords].astype(np.int32)
            class_id = int(detections[b, i, ncoords])
            score = float(detections[b, i, ncoords + 1])
            area = (coords[2] - coords[0]) * (coords[3] - coords[1])
            if cf.dim == 3:
                area = area * (coords[5] - coords[4])
            if area <= 0 or score < cf.model_min_confidence:
                continue
            box_results_list[b].append(
                {"box_coords": coords, "box_score": score, "box_type": "det", "box_pred_class_id": class_id}
            )
            served += 1
    trace.count("detections", served)
    return box_results_list


def unmold_mask(mask, bbox, image_shape):
    """Resize a small (mask_shape) mask into its box within a full-size image
    (``base.py:148-170``): order-1 zoom of the raw mask to the box extent,
    placed into a zero canvas (scipy on the host)."""
    from scipy import ndimage

    dim = 2 if len(bbox) == 4 else 3
    if dim == 2:
        y1, x1, y2, x2 = [int(v) for v in bbox[:4]]
        out_zoom = [y2 - y1, x2 - x1]
    else:
        y1, x1, y2, x2, z1, z2 = [int(v) for v in bbox[:6]]
        out_zoom = [y2 - y1, x2 - x1, z2 - z1]
    zoom_factor = [i / j for i, j in zip(out_zoom, mask.shape)]
    small = ndimage.zoom(mask, zoom_factor, order=1).astype(np.float32)
    full_mask = np.zeros(image_shape[:dim], dtype=np.float32)
    if dim == 2:
        full_mask[y1:y2, x1:x2] = small
    else:
        full_mask[y1:y2, x1:x2, z1:z2] = small
    return full_mask


def add_gt_boxes_to_results(batch, box_results_list):
    """Append the GT boxes as monitoring box dicts (``base.py:86-98``)."""
    for b in range(len(box_results_list)):
        for ix in range(len(batch["bb_target"][b])):
            box_results_list[b].append({
                "box_coords": np.asarray(batch["bb_target"][b][ix]),
                "box_label": np.asarray(batch["roi_labels"][b]).reshape(-1)[ix],
                "box_type": "gt",
            })
    return box_results_list


def compact_anchor_indices(matches, neg_sel, max_pos: int, max_neg: int):
    """(b, A) positive matches and sampled negatives -> fixed small (idx,
    valid) pairs on the device, so the per-step monitoring copy is
    O(max_pos + max_neg) per element (``base.py:101-120``; exact top-k in
    place of JAX's ``stochastic_top_k``)."""
    pos_vals, pos_idx = top_k((matches > 0).to(torch.float32), max_pos, dim=1)
    neg_vals, neg_idx = top_k(neg_sel.to(torch.float32), max_neg, dim=1)
    return pos_idx, pos_vals > 0, neg_idx, neg_vals > 0


def add_anchor_boxes_to_results(np_anchors, anchor_info, img_shape_spatial, box_results_list):
    """Append the sampled positive and negative anchors, clipped to the
    image, as monitoring box dicts (``base.py:123-145``). ``anchor_info`` is
    ``compact_anchor_indices``' output, on the host."""
    pos_idx, pos_valid, neg_idx, neg_valid = [np.asarray(a) for a in anchor_info]
    hi = np.asarray(list(img_shape_spatial[:2]) * 2 + list(img_shape_spatial[2:3]) * 2, np.float32)
    for b in range(pos_idx.shape[0]):
        for kind, idx, valid in (("pos_anchor", pos_idx[b], pos_valid[b]), ("neg_anchor", neg_idx[b], neg_valid[b])):
            for row in np.clip(np_anchors[idx[valid]], 0, hi):
                box_results_list[b].append({"box_coords": row, "box_type": kind})
    return box_results_list


def start_host_copies(tensors):
    """Queue device->host copies of ``tensors`` (a list; None entries stay
    None) into pinned memory on the current stream, right behind the work
    that made them, and record an event after them. Waiting on that event
    waits for this work alone, not for work enqueued later on the stream.
    Returns (host tensors, event); CPU tensors come back as they are, with
    no event."""
    with trace.span("host_copies"):
        if all(t is None or t.device.type == "cpu" for t in tensors):
            return list(tensors), None
        host = [None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                for t in tensors]
        event = torch.cuda.Event()
        event.record()
        return host, event


class Handles(tuple):
    """A dispatch's handles: the tuple its convert takes, with the request
    id of the dispatch's spans as ``rid`` (``utils/trace.py``)."""

    def __new__(cls, rid: int, items):
        handles = super().__new__(cls, items)
        handles.rid = rid
        return handles


def convert_span(handles):
    """The ``convert`` span of a dispatch's handles, under their request id
    (None for handles made by hand)."""
    return trace.span("convert", rid=getattr(handles, "rid", None))


def wait_for(event, what: str):
    """Block until ``event`` (``start_host_copies``' event) has completed,
    inside a ``wait`` span; no event (CPU tensors) waits for nothing."""
    if event is not None:
        with trace.span("wait", what=what):
            event.synchronize()


def resolve_remat(cf) -> bool:
    """``cf.use_remat``, or when unset: on in 3D, off in 2D (``base.py:173-176``)."""
    use = getattr(cf, "use_remat", None)
    return bool(use) if use is not None else cf.dim == 3


def resolve_grad_accum(cf, bsz: int) -> int:
    """Microbatches per optimizer step (``base.py:194-206``):
    ``cf.grad_accum_steps``, rounded down to a divisor of the batch size."""
    n = max(min(int(getattr(cf, "grad_accum_steps", 1) or 1), bsz), 1)
    while bsz % n:
        n -= 1
    return n


def make_optimizer(cf, params):
    """Adam with coupled weight decay, the update of JAX's optax chain
    ``add_decayed_weights -> scale_by_adam -> scale(-1)`` times the lr
    (``base.py:179-191``). The lr is set on the param group at each step."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cf.weight_decay)


def accum_backward(params, loss_fn, n_micro: int):
    """Gradient accumulation (``base.py:209-249``) as a loop over
    microbatches: ``loss_fn(i) -> (loss, aux)`` for microbatch ``i``, one
    backward each, the gradients summed into ``.grad`` and divided by
    ``n_micro``, as JAX sums then averages. Batch-global reductions inside
    ``loss_fn`` see one microbatch, as in JAX. A parameter the loss does not
    reach (Detection U-Net's P2.. output convs) gets a zero gradient, as in
    JAX, so that Adam keeps state for it and decays it. Returns (mean loss,
    [aux])."""
    for p in params:
        p.grad = None
    losses, auxs = [], []
    for i in range(n_micro):
        loss, aux = loss_fn(i)
        with trace.span("backward", device=loss.device):
            loss.backward()
        losses.append(loss.detach())
        auxs.append(aux)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif n_micro > 1:
            p.grad.div_(n_micro)
    return torch.stack(losses).mean(), auxs


def merge_microbatch_aux(auxs):
    """Per-microbatch aux -> full-batch layout (``base.py:252-266``): scalars
    (monitor values) averaged, batch-leading tensors concatenated."""
    first = auxs[0]
    if isinstance(first, dict):
        return {k: merge_microbatch_aux([a[k] for a in auxs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(merge_microbatch_aux(list(parts)) for parts in zip(*auxs))
    if first is None:
        return None
    if first.dim() == 0:
        return torch.stack(auxs).mean()
    return torch.cat(auxs, dim=0)


class Detector:
    """Base class: owns (cf, logger, device, module, optimizer) and the host
    API.

    Subclasses implement ``build`` (set ``self.module``) and either
    ``_predict`` + ``_finalize_outputs`` (one-stage) or ``_forward`` +
    ``_make_seg_preds`` (two-stage), and ``train_forward_dispatch`` +
    ``train_forward_convert``.
    """

    # per-epoch lr, set by the trainer (reference exec.py:59-60)
    current_lr = 1e-4
    # this rank's mesh.DataParallel after enable_data_parallel (over its data
    # group after enable_spatial_parallel); None on one card
    dp = None
    # this rank's mesh.SpaceGroup after enable_spatial_parallel[_inference]
    space = None

    def __init__(self, cf, logger, device: Optional[torch.device] = None):
        self.cf = cf
        self.logger = logger
        self.device = torch.device(device) if device is not None else default_device()
        self.module = None
        self.build()
        self.optimizer = make_optimizer(cf, self.module.parameters())

    # ---- subclass API -------------------------------------------------
    def build(self):
        raise NotImplementedError

    def init_params(self, seed: int = 0):
        raise NotImplementedError

    # ---- state handling ------------------------------------------------
    def initialize(self, seed: Optional[int] = None):
        """Draw fresh weights from ``torch.Generator().manual_seed(seed)``
        and start a fresh optimizer state."""
        self.init_params(self.cf.seed if seed is None else seed)
        self.optimizer = make_optimizer(self.cf, self.module.parameters())
        self._broadcast_params()
        n_params = sum(p.numel() for p in self.module.parameters())
        if self.logger is not None:
            self.logger.info(f"initialized {type(self).__name__} with {n_params/1e6:.2f}M parameters")

    def state_dict(self):
        """The port's own checkpoint: parameter tensors on the CPU and the
        optimizer's state."""
        return {"params": {k: v.detach().cpu() for k, v in self.module.state_dict().items()},
                "opt_state": self.optimizer.state_dict()}

    def load_state_dict(self, state):
        self.module.load_state_dict(state["params"])
        if state.get("opt_state") is not None:
            self.optimizer.load_state_dict(state["opt_state"])
        self._broadcast_params()

    def jax_params(self):
        """The parameters as a JAX param tree (nested dicts of numpy arrays
        in flax's names, the layout of ``cf.stage_mode``): what a best
        checkpoint's ``params.pkl`` holds in both packages."""
        from medicaldetectiontoolkit_torch.utils import convert

        return convert.torch_to_jax(self.module.state_dict(), self.module, getattr(self.cf, "stage_mode", "unroll"))

    def load_params(self, params, opt_state=None):
        """Load a JAX param tree (nested dicts of numpy arrays, as
        ``Detector.state_dict()["params"]`` of the JAX package holds it) and,
        when given, that package's optimizer state (``state_dict()
        ["opt_state"]``), so a JAX run resumes here."""
        from medicaldetectiontoolkit_torch.utils import convert

        self.module.load_state_dict(convert.jax_to_torch(params, self.module))
        if opt_state is not None:
            self.optimizer.load_state_dict(convert.jax_adam_to_torch(opt_state, self.module, self.optimizer))
        self._broadcast_params()

    # ---- data parallelism ----------------------------------------------
    def enable_data_parallel(self, group=None):
        """Make this detector one rank of data-parallel training over
        ``group`` (default: the whole job; ``parallel/mesh.py``): rank 0's
        parameters are broadcast now and after every load, each step's
        batch-wide sums and its gradients are summed over the ranks, and
        batches hold this rank's rows of the global batch. The Predictor's
        whole patients stay on one rank (``single_card``)."""
        from medicaldetectiontoolkit_torch.parallel import mesh

        self.dp = mesh.DataParallel(group)
        self._broadcast_params()
        if self.logger is not None:
            self.logger.info(f"data-parallel training: rank {self.dp.rank} of {self.dp.world}")
        return self.dp

    def _broadcast_params(self):
        if self.dp is not None or self.space is not None:
            from medicaldetectiontoolkit_torch.parallel import mesh

            mesh.broadcast_module(self.module)

    # ---- spatial partitioning ------------------------------------------
    def _space_grid(self, n_data, n_space, what: str):
        """The (data x space) grid of ``enable_spatial_parallel[_inference]``
        and this rank's SpaceGroup on it."""
        from medicaldetectiontoolkit_torch.parallel import mesh

        cf = self.cf
        grid = mesh.grid_layout(n_data or getattr(cf, "n_data_parallel", None) or 1,
                                n_space or getattr(cf, "n_space_parallel", None) or 1)
        mesh.check_space_cap(cf, grid.n_space, cf.patch_size[0])
        # a slab can take another conv algorithm than the whole image; TF32's rounding would part the forwards
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        self.space = mesh.SpaceGroup(grid)
        if self.logger is not None:
            self.logger.info(f"spatially-partitioned {what} over {grid.n_data}x{grid.n_space} (data x space) "
                             f"ranks: rank {grid.rank} at data {grid.data_index}, space {grid.space_index}")
        return grid

    def enable_spatial_parallel_inference(self, n_data=None, n_space=None):
        """Make this detector's test forwards spatially partitioned over a
        (data x space) grid of the process group (``parallel/mesh.py``; JAX
        ``models/base.py:372-385``): ``mesh.grid_layout`` of ``n_data``
        (default ``cf.n_data_parallel`` or 1) by ``n_space`` (default
        ``cf.n_space_parallel``). The deepest level's cap is checked
        on ``cf.patch_size`` here and on the image at every forward; rank
        0's parameters are broadcast now and after every load; TF32 is
        turned off in this process (``parallel/mesh.py``, Precision).
        Returns the grid."""
        grid = self._space_grid(n_data, n_space, "inference")
        self._broadcast_params()
        return grid

    def enable_spatial_parallel(self, n_data=None, n_space=None):
        """Make this detector's train, validation and test forwards
        spatially partitioned over a (data x space) grid (JAX
        ``models/base.py:350-368``): the grid and SpaceGroup of
        ``enable_spatial_parallel_inference``, and a ``mesh.DataParallel``
        over this rank's data group, whose batch-wide sums, global top-k and
        draws' rows span the D data groups. A batch holds this data group's
        rows of the global batch, whole along Y; each step runs on this
        rank's Y slab and equals the single-card step on the global batch:
        the gradients are summed over the whole grid and divided by S
        (``parallel/mesh.py``, Gradients). Rank 0's parameters are broadcast
        now and after every load. Returns the grid."""
        from medicaldetectiontoolkit_torch.parallel import mesh

        grid = self._space_grid(n_data, n_space, "training")
        self.dp = mesh.DataParallel(grid.data_group)
        self._broadcast_params()
        return grid

    def _spatial(self, fn, img):
        """``fn(img)``: a module's forward whose outputs are gathered along Y
        under spatial partitioning, run on this rank's slab of ``img``
        within its space group (``mesh.SpaceGroup.run``, a test forward);
        on one process plainly."""
        with trace.span("forward", device=self.device):
            return fn(img) if self.space is None else self.space.run(fn, img, self.cf)

    def _spatial_train(self, fn, img):
        """``_spatial`` for a train or validation step's forward, with
        autograd as the caller has it (``mesh.SpaceGroup.train``): the
        outputs come back gathered and the backward of the step's loss runs
        the slabs' backward collectives."""
        with trace.span("forward", device=self.device):
            return fn(img) if self.space is None else self.space.train(fn, img, self.cf)

    def _seg_space(self, y: int):
        """The SpaceGroup whose ranks each keep a Y slab of the P0 seg path
        (labels, logits, the seg loss's sums, seg_preds) for an image of
        ``y`` rows: this rank's, where P0 stays split (``mesh.keeps_split``
        at its fence, the FPN's first: stride 1, halo 1); None on one
        process or where P0 runs replicated."""
        from medicaldetectiontoolkit_torch.parallel import mesh

        if self.space is None or not mesh.keeps_split(y // self.space.size):
            return None
        return self.space

    def _seg_slab(self, labels):
        """This rank's Y slab of host seg labels ``(b, 1, y, ...)`` where the
        seg path runs on slabs (JAX's Y in_sharding of ``seg``), sliced
        before the upload; the labels themselves otherwise."""
        sg = self._seg_space(labels.shape[2])
        return labels if sg is None else sg.slab(labels)

    def _seg_whole(self, t, y: int):
        """A P0 map of a forward over an image of ``y`` rows (seg_preds, a
        detached softmax), joined along Y where it holds this rank's slab
        (``SpaceGroup.gather_y``: no backward, integers in their own dtype);
        ``t`` itself otherwise."""
        sg = self._seg_space(y)
        return t if sg is None else sg.gather_y(t)

    @contextlib.contextmanager
    def single_card(self):
        """Steps run inside on this rank's batch alone, with no collective
        of the data axis (the Predictor's validation of its own whole
        patients); a space group stays on."""
        dp, self.dp = self.dp, None
        try:
            yield
        finally:
            self.dp = dp

    def step_layout(self, n_rows: int, n_micro: Optional[int] = None):
        """(microbatches, rows of a global microbatch) of a step whose batch
        holds ``n_rows`` rows on this rank: the accumulation count is
        resolved on the global batch (``resolve_grad_accum``), unless given."""
        world = 1 if self.dp is None else self.dp.world
        bsz = n_rows * world
        n_micro = n_micro or resolve_grad_accum(self.cf, bsz)
        m = bsz // n_micro
        if m % world:
            raise ValueError(f"global batch {bsz} in {n_micro} microbatches of {m} rows does not split over {world} "
                             "ranks")
        return n_micro, m

    def step_draws(self, n_micro: int, m: int):
        """``self.draws(n_micro, m)`` of the global batch, this rank's rows."""
        draws = self.draws(n_micro, m)
        return draws if self.dp is None else tuple(self.dp.local_rows(d) for d in draws)

    def data_parallel_step(self, n_micro: int):
        """The span of one step (``mesh.DataParallel.step``); nothing on one card."""
        return contextlib.nullcontext() if self.dp is None else self.dp.step(n_micro)

    # ---- inference -----------------------------------------------------
    def _predict(self, img):
        raise NotImplementedError

    def _finalize_outputs(self, *heads):
        raise NotImplementedError

    def _forward(self, img, with_masks: bool):
        """img -> (det, det_mask, det_masks_raw | None, seg_preds | None) on
        the device."""
        det, det_mask, seg_preds = self._finalize_outputs(*self._predict(img))
        return det, det_mask, None, seg_preds

    def _make_seg_preds(self, det, det_mask, det_masks_raw, seg_preds, data_shape, with_masks: bool):
        """The results' seg_preds on the host: the seg head's argmax (joined
        along Y here under spatial partitioning, so that only a caller that
        asks for it pays the collective), or a float32 zero volume for
        detectors without one."""
        if seg_preds is None:
            return np.zeros((data_shape[0], 1) + tuple(data_shape[2:]), dtype=np.float32)
        seg_preds = self._seg_whole(seg_preds, data_shape[2])
        with trace.span("wait", what="seg_preds"):
            return seg_preds.cpu().numpy()

    def test_forward_dispatch(self, batch, return_masks=True, **kwargs):
        """Enqueue the forward pass and detection refinement (and, for
        detectors with a mask head, the masks when ``return_masks``); return
        un-synchronised device tensors (nothing waits for the device until
        convert) as ``Handles``."""
        with_masks = bool(return_masks)
        rid = trace.request()
        with trace.span("dispatch", rid=rid, kind="test"), torch.inference_mode():
            with trace.span("upload"):
                img = host_to_device(batch["data"], self.device)
            return Handles(rid, (with_masks, self._forward(img, with_masks)))

    def test_forward_convert(self, handles, batch, **kwargs):
        with convert_span(handles):
            with_masks, (det, det_mask, det_masks_raw, seg_preds) = handles
            with trace.span("wait", what="detections"):  # a pageable copy: waits for every chunk queued before it
                det_host, mask_host = det.cpu().numpy(), det_mask.cpu().numpy()
            with trace.span("assemble"):
                boxes = detections_to_box_results(self.cf, det_host, mask_host)
                seg = self._make_seg_preds(det, det_mask, det_masks_raw, seg_preds, batch["data"].shape, with_masks)
        return {"boxes": boxes, "seg_preds": seg}

    def test_forward(self, batch, **kwargs):
        """Inference forward -> {boxes, seg_preds} (reference test_forward contract)."""
        return self.test_forward_convert(self.test_forward_dispatch(batch, **kwargs), batch, **kwargs)

    # ---- training ------------------------------------------------------
    def train_forward_dispatch(self, batch, is_validation: bool = False, do_update: bool = True):
        raise NotImplementedError

    def train_forward_convert(self, handles, batch, need_seg_preds: bool = True):
        raise NotImplementedError

    def _update(self):
        """One Adam step at ``current_lr``, on the gradients summed over the
        ranks in a data-parallel run."""
        with trace.span("update", device=self.device):
            if self.dp is not None:
                self.dp.reduce_gradients(list(self.module.parameters()))
            for group in self.optimizer.param_groups:
                group["lr"] = self.current_lr
            self.optimizer.step()

    def train_forward(self, batch, is_validation: bool = False, do_update: bool = True,
                      need_seg_preds: bool = True):
        """One step (with an optimizer update unless validating) -> the
        reference results dict: boxes, seg_preds, loss, monitor_values,
        logger_string (``base.py:288-309``)."""
        return self.train_forward_convert(self.train_forward_dispatch(batch, is_validation, do_update), batch,
                                          need_seg_preds=need_seg_preds)
