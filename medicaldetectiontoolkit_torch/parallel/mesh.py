"""Data parallelism and spatial partitioning of the port: W ranks, one
process per card, over ``torch.distributed``.

Counterpart of ``medicaldetectiontoolkit_tpu/parallel/mesh.py``. JAX jits
the train step over a device mesh, and GSPMD makes a data-parallel step the
single-device program on the global batch. The port runs one process per
card, so its step keeps that contract by hand: **one data-parallel step over
W ranks computes the loss, gradients and update of the single-card step on
the concatenated global batch.**

* **Batch-wide sums.** A loss whose normaliser spans the batch (the seg
  loss's dice and CE sums, Mask R-CNN's means over every sampled RoI, the
  batch means of the anchor losses) cannot be split into per-rank means.
  Every such partial sum goes through ``batch_sum`` (``batch_mean`` for a
  plain mean): the identity outside a data-parallel step, so the single-card
  path is what it was; inside one (``DataParallel.step``) an all-reduce
  (SUM) over the step's process group, so every rank computes the
  single-card loss. Every term of a loss passes through exactly one of them.
* **Gradients.** ``batch_sum``'s backward is the identity: the loss is the
  same on every rank, so is the gradient arriving at each sum, and rank r's
  backward yields its own rows' share of dL/dθ. ``DataParallel.
  reduce_gradients`` adds the shares with one all-reduce (SUM) of a flat
  buffer per dtype, once per optimizer step, after the microbatches are
  summed (and after K4's fixed-order reduce, so each rank's share stays
  bit-reproducible). Adam then runs identically on every rank.
* **Not ``DistributedDataParallel``.** Its wrapper renames every parameter
  ``module.*``, which breaks ``jax_params``, ``utils/convert.py`` and both
  packages' checkpoints; its hooks all-reduce at every backward of the
  accumulation loop; and its averaging is the one all-reduce above.
* **Order.** A process group must see the same collectives in the same
  order on every rank. The losses have no data-dependent branch: a rank
  whose rows sample no positive RoI still reaches every sum, with a count
  of 0. A data-parallel forward needs no communication: JAX's
  ``"batch_norm"`` is ``GroupNorm(1)``, per element. A spatially
  partitioned one does (below).
* **Layout**, JAX's: ``cf.batch_size`` is the global batch of one optimizer
  step, split over the ranks (each rank's loader yields ``cf.batch_size /
  W`` patches); microbatch k holds global rows ``[k m, (k + 1) m)`` and rank
  r the rows ``[k m + r m / W, k m + (r + 1) m / W)`` of each
  (``shard_rows``). Every rank draws a step's global random tensors from the
  same seeded generator and keeps its rows (``DataParallel.local_rows``), so
  the step sees the single-card step's draws.
* **Start.** Parameters are broadcast from rank 0 when data parallelism is
  enabled and after every load (``models/base.py``); JAX relies on same-seed
  init instead.

**Spatial partitioning** (JAX's ``n_space_parallel``, ``get_mesh_2d``,
``make_spatial_predict``, ``make_spatial_train_step`` and
``make_spatial_loss_eval``): W = D x S ranks form a grid (``grid_layout``),
rank r at data index ``r // S`` and space index ``r % S``. The D data groups
split the batch (training) or the patients (test) as above; the S ranks of a
space group take the same rows, each holding one Y slab (dim 2 of ``(b, c,
y, x, (z))``) of every activation, and the detector's forward, loss,
gradients and update are the single-process ones (within float32 reduction
order):

* ``SpaceGroup`` is the counterpart of JAX's ``_spatial_trace``. Inside
  ``SpaceGroup.train`` (autograd on) and ``SpaceGroup.run`` (a test forward)
  the model's ops find it through ``space()``; outside a spatial forward,
  and on a level that runs replicated (``on_slabs(False)``), ``space()`` is
  None and every op is the plain op.
* ``halo_exchange`` gives a slab the rows of its neighbours that a padded or
  strided op reads (the op's own pad value at the image's edge), so a conv
  runs with no Y padding: ``k // 2`` rows before and ``k - stride - k // 2``
  after; the max pool takes one row before (``-inf`` at the edge),
  ``linear_up`` one on each side (the edge row repeated); ``nearest_up`` is
  local. ``space_sum`` sums GroupNorm's sums over the group; ``gather_y``
  joins the slabs of the heads and (Mask R-CNN) the pyramid levels, so that
  matching, the anchor and RoI losses, refinement, K1, K2 and the mask pass
  run on whole tensors, identically on every rank of the group.
* **The P0 segmentation path stays on the slabs** (JAX's Y in_sharding of
  ``seg``): where P0 is split (``keeps_split`` at its fence, which every
  slab of at least one row meets), a rank uploads only its slab of the seg
  labels, its seg head's logits stay a slab, the seg loss takes its sums
  there and adds them with ``space_sum`` over the group the detector passes
  (the loss runs after the forward, where ``space()`` is None), and the
  argmax of the slab is joined as a uint8 map (``SpaceGroup.gather_y``,
  no backward) only where a caller asks for seg_preds; Detection U-Net
  joins its softmax, detached, for the host's components.
* **The GT masks stay on the slabs** (JAX's Y in_sharding of
  ``gt_masks``): a Mask R-CNN rank uploads only its Y slab of them. Each
  mask target is a crop of its assigned mask that reads two rows per crop
  row, at indices computed from the whole image; each rank gathers those
  rows where it owns them and zeros elsewhere, and one ``SpaceGroup.sum``
  (kind ``mask_rows``, uint8 on the wire) over every positive slot, valid
  or not, joins them. Every row has one owner, so the sum adds only zeros
  and is exact, and the lerps then run on the rows one process gathers
  (``models/mrcnn.py::detection_target_layer``). The targets are
  constants: the sum has no backward.
* **Which levels split** (``space_fence``, JAX's ``space_fence``): a level
  stays split while its slab's rows divide by the next op's stride and
  cover its halo; from the first stage input where that fails the tensor is
  gathered and the deeper levels run replicated. JAX's fence also
  replicates every stage below 32 rows, which guards a GSPMD miscompile;
  explicit halos do not need it, so the port does not take that rule.
* ``check_space_cap`` keeps JAX's refusal (``_check_space_cap``) when the
  deepest level has fewer rows than S, at enable time and at every call;
  ``MDT_SP_VERIFY=1`` holds each new input shape's test-forward outputs
  against the single-process forward once (atol 1e-5), as JAX's
  ``make_spatial_predict``; a training forward is never re-run.
* Every collective is an all-reduce (SUM) of a zero-padded buffer, which
  gloo takes for CPU and CUDA tensors alike (``SpaceGroup.all_gather``),
  in the backward too; integer tensors cross in their own dtype, floats
  narrower than float32 as float32 (``SpaceGroup.wire_dtype``). Every rank
  of a group reaches the same collectives in the same order: no op branches
  on data, each primitive is one ``torch.autograd.Function`` on every rank
  (the image's edge included), a remat region recomputes its halos and sums
  inside the backward with the SpaceGroup it saw in the forward
  (``checkpoint``), and the seg_preds join runs in ``*_forward_convert``,
  which every rank of a group calls in the same order.
* **Gradients: the partial-gradient convention.** A rank's gradient of any
  tensor is its share; the true gradient is the sum of the shares over the
  space group. Each primitive's backward follows from that rule:

  - ``space_sum`` (an all-reduce whose result is used on the slab):
    all-reduce (SUM) of the incoming gradient. Its identity backward, right
    for ``batch_sum``, would drop the other slabs' shares of dL/dsum. The
    seg loss's sums are such sums too: the loss after them is replicated,
    so each rank's copy gets the same dL/dsum, the all-reduce makes it S
    times that, and each slab's seg logits get S times their gradient, as
    every other slab tensor does;
  - ``gather_y`` (slabs joined, used replicated; ``space_fence``'s gather
    too): the ranks' gradients of the whole tensor summed, then this rank's
    slab kept (an all-reduce of the whole gradient, then a slice);
  - ``halo_exchange``: the gradient of the ``lo`` rows before the slab is
    added to the previous rank's last ``lo`` rows, that of the ``hi`` rows
    after it to the next rank's first ``hi`` rows; at the image's edge a
    value pad's gradient is dropped and ``"replicate"``'s summed into the
    edge row;
  - ``slab_of``: local (the slab's gradient zero-padded to the whole
    tensor, autograd's slice backward);
  - the replicated loss is seeded with 1 on every rank of the space group,
    so the shares add up to S times the gradient: ``DataParallel.
    reduce_gradients`` sums the parameters' gradients over the **whole
    grid** (both axes) in one all-reduce per optimizer step and divides
    them by S once, before Adam. A level that runs replicated computes its
    parameters' whole gradient on every rank, and that sum counts it S times
    too, so the one division is right for shared heads as well.

  ``batch_sum`` / ``batch_mean`` over the data group keep their identity
  backward: the loss after them is the same on every rank of the data group.
* **Precision.** ``Detector.enable_spatial_parallel[_inference]`` turns
  cuDNN's and cuBLAS's TF32 off in the rank's process: a slab's shape can
  take another conv algorithm than the whole image's, and TF32's rounding
  would then part the two forwards by far more than 1e-5. The equality
  holds against a single-process run with TF32 off too (PyTorch's default
  leaves it on for cuDNN's convs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from medicaldetectiontoolkit_torch.ops.topk import top_k

# the DataParallel whose step is running (a stack, as JAX's _SPATIAL_TRACE_CTX)
_STEP: list = []
# the SpaceGroup of the running spatial forward; None on a replicated level
_SPACE: list = []


def maybe_initialize_distributed(logger=None, device=None, backend=None) -> bool:
    """Join the process group that the environment names, JAX's env
    contract (all three required to opt in):

      MDT_DIST_COORD=host:port   rendezvous address (rank 0's host)
      MDT_DIST_NPROCS=N          number of processes in the job
      MDT_DIST_RANK=i            this process's rank

    ``MDT_DIST_INIT_TIMEOUT`` (seconds, default 300) bounds the rendezvous
    and every collective: a rank that waits longer fails the run. On a card
    (``device`` None or CUDA) the process takes ``cuda:(rank %
    device_count)`` and NCCL; ``device="cpu"`` takes gloo; ``backend``
    overrides the choice (gloo on one card shared by two ranks, which NCCL
    refuses). Returns True iff a process group was initialised."""
    coord = os.environ.get("MDT_DIST_COORD")
    nprocs = os.environ.get("MDT_DIST_NPROCS")
    rank = os.environ.get("MDT_DIST_RANK")
    if not (coord and nprocs and rank):
        return False
    rank, world = int(rank), int(nprocs)
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("MDT_DIST_* asks for a rank on a CUDA card and none is visible; pass device='cpu'")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=int(os.environ.get("MDT_DIST_INIT_TIMEOUT", "300")))
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world, rank=rank, timeout=timeout)
    if logger is not None:
        logger.info(f"torch.distributed initialized: rank {rank}/{world} @ {coord} ({backend})")
    return True


def rank_and_world(group=None):
    """(rank, world size) in ``group`` (default: the whole job); (0, 1)
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def host_shard_info(cf=None):
    """(rank, world) of this process's share of the data: ``cf.input_shard``
    where set (tests), else the process group's, else (0, 1)."""
    override = getattr(cf, "input_shard", None) if cf is not None else None
    if override:
        return int(override[0]), int(override[1])
    return rank_and_world()


def local_batch_size(cf) -> int:
    """Rows of this rank's share of the global batch ``cf.batch_size``."""
    _, world = host_shard_info(cf)
    if cf.batch_size % world:
        raise ValueError(f"cf.batch_size {cf.batch_size} (the global batch) does not split over {world} ranks")
    return cf.batch_size // world


def is_writer() -> bool:
    """Whether this process writes the experiment's files: rank 0, or the
    only process."""
    return rank_and_world()[0] == 0


def barrier():
    if rank_and_world()[1] > 1:
        dist.barrier()


def shard_rows(bsz: int, rank: int, world: int, n_micro: int) -> np.ndarray:
    """Global rows of rank ``rank`` of ``world`` in a batch of ``bsz`` rows
    run as ``n_micro`` microbatches: rows ``[k m + r m / W, k m + (r + 1)
    m / W)`` of each microbatch k, ``m = bsz / n_micro``."""
    if bsz % n_micro:
        raise ValueError(f"a batch of {bsz} rows does not split into {n_micro} microbatches")
    m = bsz // n_micro
    if m % world:
        raise ValueError(f"a microbatch of {m} rows ({bsz} in {n_micro} microbatches) does not split over "
                         f"{world} ranks")
    ml = m // world
    return np.concatenate([np.arange(k * m + rank * ml, k * m + (rank + 1) * ml) for k in range(n_micro)])


def shard_batch(batch, rank: int, world: int, n_micro: int = 1):
    """This rank's rows (``shard_rows``) of a host batch dict: every array
    or list whose leading length is the batch's (``len(batch["data"])``)
    is indexed, anything else kept."""
    bsz = len(batch["data"])
    rows = shard_rows(bsz, rank, world, n_micro)

    def take(v):
        if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == bsz:
            return v[rows]
        if isinstance(v, (list, tuple)) and len(v) == bsz:
            return type(v)(v[i] for i in rows)
        return v

    return {k: take(v) for k, v in batch.items()}


def current():
    """The DataParallel whose step is running, or None."""
    return _STEP[-1] if _STEP else None


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (SUM) forward, identity backward (see the module
    docstring: the gradient arriving at a sum is the same on every rank)."""

    @staticmethod
    def forward(ctx, t, dp):
        out = t.clone()
        dp.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_sum(t):
    """A partial sum over this rank's rows -> the sum over the global batch
    inside a data-parallel step; the identity outside one."""
    dp = current()
    return t if dp is None else _SumOverRanks.apply(t, dp)


def batch_mean(t):
    """``t.mean()`` over the global batch: ``t`` holds this rank's rows."""
    dp = current()
    if dp is None:
        return t.mean()
    return batch_sum(t.sum()) / (t.numel() * dp.world)


def batch_top_k(flat, k: int, per_row: int):
    """Exact top-``k`` of a batch's flat scores ``(rows * per_row,)``, ties
    toward the lower flat index (``ops/topk.py``), over the global batch.

    Returns (scores (k,), indices into ``flat`` (k,), own (k,) bool or
    None): outside a step, ``top_k(flat, k)`` and None. Inside one, every
    rank gets the global selection in the single-card order; ``own`` marks
    the candidates of its own rows, whose indices point into its ``flat``
    (the others' are 0). Each rank's top-k holds its part of the global
    top-k, so one all-reduce of the ranks' candidates (scores and global
    indices as float64, exact) is enough."""
    dp = current()
    if dp is None:
        scores, idx = top_k(flat, k)
        return scores, idx, None
    dev = flat.device
    n_rows = flat.shape[0] // per_row
    kl = min(k, flat.shape[0])
    scores, idx = top_k(flat, kl)
    grow = dp.global_rows(n_rows).to(dev)
    gidx = grow[idx // per_row] * per_row + idx % per_row
    buf = torch.zeros((dp.world, 2, kl), dtype=torch.float64, device=dev)
    buf[dp.rank, 0] = scores.to(torch.float64)
    buf[dp.rank, 1] = gidx.to(torch.float64)
    dp.all_reduce(buf)
    all_idx = buf[:, 1].reshape(-1).long()
    order = torch.argsort(all_idx)  # ascending global index: the stable sort below breaks ties to the lower
    sel_scores, pos = top_k(buf[:, 0].reshape(-1)[order], k)
    sel = all_idx[order][pos]
    local_of = torch.full((n_rows * dp.world,), -1, dtype=torch.int64, device=dev)
    local_of[grow] = torch.arange(n_rows, device=dev)
    lrow = local_of[sel // per_row]
    own = lrow >= 0
    return sel_scores.to(flat.dtype), torch.where(own, lrow * per_row + sel % per_row, 0), own


class DataParallel:
    """One rank's side of data-parallel training over ``group`` (default:
    the whole job; under spatial partitioning the rank's data group): the
    step context, the draws' rows and the gradient all-reduce, which spans
    the whole job (``broadcast_module`` gives every rank rank 0's
    parameters)."""

    def __init__(self, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("data parallelism needs a process group: maybe_initialize_distributed (MDT_DIST_*) or "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.rank, self.world = rank_and_world(group)
        self.n_micro = None  # of the running step

    @contextlib.contextmanager
    def step(self, n_micro: int):
        """The span of one step of ``n_micro`` microbatches: ``batch_sum``
        all-reduces inside it."""
        self.n_micro = n_micro
        _STEP.append(self)
        try:
            yield self
        finally:
            _STEP.pop()
            self.n_micro = None

    def local_rows(self, t):
        """This rank's rows of a global per-microbatch tensor ``(n_micro, m,
        ...)`` (a step's draws)."""
        ml = t.shape[1] // self.world
        return t[:, self.rank * ml:(self.rank + 1) * ml]

    def global_rows(self, n_rows: int):
        """Global batch rows of this rank's ``n_rows`` rows in the running
        step (microbatches in order, as the step merges them)."""
        rows = shard_rows(n_rows * self.world, self.rank, self.world, self.n_micro)
        return torch.from_numpy(rows)

    def all_reduce(self, t):
        dist.all_reduce(t, group=self.group)
        return t

    def reduce_gradients(self, params):
        """Sum the parameters' ``.grad`` over the whole job: one all-reduce
        of a flat buffer per dtype, divided by the S ranks that hold each
        row (1 without spatial partitioning; each rank's share is of S times
        the gradient: the module docstring's convention)."""
        n_space = dist.get_world_size() // self.world
        for grads in _by_dtype([p.grad for p in params]):
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            if n_space > 1:
                flat.div_(n_space)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))


def _by_dtype(tensors):
    """``tensors`` in lists of one dtype each, in order: the flat buffers
    of one collective each."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def broadcast_module(module):
    """The parameters and buffers of ``module`` on global rank 0 copied to
    every rank of the job: one broadcast of a flat buffer per dtype."""
    with torch.no_grad():
        for tensors in _by_dtype([*module.parameters(), *module.buffers()]):
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.broadcast(flat, 0)
            for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))


def gather_objects(items, group=None):
    """Every rank's list ``items`` (picklable), concatenated in rank order,
    on every rank of ``group`` (default: the whole job; under spatial
    partitioning the data group, whose ranks hold other rows); ``items``
    itself without a process group."""
    _, world = rank_and_world(group)
    if world == 1:
        return list(items)
    parts = [None] * world
    dist.all_gather_object(parts, list(items), group=group)
    return [x for part in parts for x in part]


def gather_interleaved(items, group=None):
    """Every rank's list ``items`` merged round-robin (rank 0's first, then
    rank 1's first, ...) over ``group`` (default: the whole job): the order
    of the data set whose patients the ranks took as ``pids[rank::world]``.
    Under spatial partitioning ``group`` is the rank's data group
    (``Grid.data_group``), whose ranks took ``pids[data_index::D]``."""
    _, world = rank_and_world(group)
    if world == 1:
        return list(items)
    parts = [None] * world
    dist.all_gather_object(parts, list(items), group=group)
    return [part[i] for i in range(max(len(p) for p in parts)) for part in parts if i < len(part)]


#############################
#   spatial partitioning    #
#############################


@dataclasses.dataclass(frozen=True)
class Grid:
    """A rank's place in a (data x space) grid of ``n_data * n_space`` ranks
    (``grid_layout``) and its two process groups."""

    rank: int
    n_data: int
    n_space: int
    data_group: object  # the n_data ranks of this rank's space index
    space_group: object  # the n_space ranks of this rank's data index

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space


def grid_layout(n_data: int, n_space: int) -> Grid:
    """The job's ranks as a (data x space) grid, JAX's ``get_mesh_2d``: rank
    r at data index ``r // n_space`` and space index ``r % n_space``. Every
    rank calls it (``new_group`` is collective)."""
    rank, world = rank_and_world()
    if not dist.is_initialized() or world != n_data * n_space:
        raise ValueError(f"a {n_data} x {n_space} (data x space) grid needs a process group of {n_data * n_space} "
                         f"ranks; there {'are ' + str(world) if dist.is_initialized() else 'is none'}")
    data_groups = [dist.new_group([d * n_space + s for d in range(n_data)]) for s in range(n_space)]
    space_groups = [dist.new_group([d * n_space + s for s in range(n_space)]) for d in range(n_data)]
    return Grid(rank, n_data, n_space, data_groups[rank % n_space], space_groups[rank // n_space])


def check_space_cap(cf, n_space: int, y_extent: int) -> int:
    """JAX's ``_check_space_cap``: refuse a split whose deepest pyramid level
    (stride 32, or 64 with ``sixth_pooling``) has fewer Y rows than
    ``n_space``. Returns that stride."""
    deepest_stride = 64 if getattr(cf, "sixth_pooling", False) else 32
    c_deep_y = y_extent // deepest_stride
    if c_deep_y < n_space:
        raise ValueError(
            f"spatial axis {n_space} exceeds C5 Y-extent {c_deep_y} "
            f"for Y={y_extent} (stride {deepest_stride}); use fewer 'space' shards"
        )
    return deepest_stride


def space():
    """The SpaceGroup whose Y slabs the running ops take, or None (one
    process, a replicated level, or no spatial forward running)."""
    return _SPACE[-1] if _SPACE else None


@contextlib.contextmanager
def on_slabs(split: bool):
    """Ops inside take Y slabs iff ``split``; a level that runs replicated
    (``split`` False) sees no SpaceGroup and runs the plain ops."""
    if split or not _SPACE:
        yield
        return
    _SPACE.append(None)
    try:
        yield
    finally:
        _SPACE.pop()


def tensor_leaves(tree):
    """The tensors of nested lists and tuples, in order; None left out."""
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tensor_leaves(item)]
    return [] if tree is None else [tree]


class SpaceGroup:
    """One rank's side of a space group (``Grid.space_group``): the
    collectives of the slab-aware ops and the spatial forwards (``train``,
    ``run``).

    ``stats`` counts, per kind of collective (``halo``, ``sum``, ``gather``
    in the forward; ``halo_bwd``, ``sum_bwd``, ``gather_bwd`` in the
    backward; ``mask_rows``, the rows of the GT masks that Mask R-CNN's
    mask targets read), the calls and the bytes this rank received from the other
    ranks (a halo's neighbour rows and their gradients, the other ranks'
    sums and slabs, and for ``gather_bwd`` their gradients of the whole
    tensor), at the size of the dtype they cross in (``wire_dtype``). An
    all-reduce moves more than that (its whole zero-padded buffer, in
    steps); the count is what the rank needs. With ``timing`` on, each
    collective is fenced by a device synchronise before and after it and its
    seconds are summed (a measurement mode: it serialises the device)."""

    # the collectives of the slab-aware ops, and of the training targets
    KINDS = ("halo", "sum", "gather", "halo_bwd", "sum_bwd", "gather_bwd")
    TARGET_KINDS = ("mask_rows",)

    def __init__(self, grid: Grid):
        self.grid = grid
        self.group = grid.space_group
        self.rank, self.size = grid.space_index, grid.n_space
        self.timing = False
        self.stats = {kind: {"calls": 0, "bytes": 0, "s": 0.0} for kind in self.KINDS + self.TARGET_KINDS}
        self._verified = set()

    def reset_stats(self):
        for st in self.stats.values():
            st.update(calls=0, bytes=0, s=0.0)

    @contextlib.contextmanager
    def _collective(self, kind: str, n_bytes: int, device):
        st = self.stats[kind]
        st["calls"] += 1
        st["bytes"] += int(n_bytes)
        if not self.timing:
            yield
            return
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        st["s"] += time.perf_counter() - t0

    @staticmethod
    def wire_dtype(dtype):
        """The dtype a tensor of ``dtype`` crosses in: float32 and float64
        as they are, narrower floats as float32 (a sum of them keeps its
        precision), bool as uint8, every other integer dtype as itself (gloo
        and NCCL sum uint8, int8, int32 and int64)."""
        if dtype == torch.bool:
            return torch.uint8
        if dtype.is_floating_point and dtype not in (torch.float32, torch.float64):
            return torch.float32
        return dtype

    def all_gather(self, t, kind: str, n_received: int):
        """Every rank's ``t`` (one shape on every rank) stacked in rank
        order, ``(S, *t.shape)``: an all-reduce (SUM) of a zero-padded
        buffer of ``wire_dtype``, exact, since one rank holds each element.
        ``n_received`` is the number of the other ranks' elements that this
        rank uses (counted at the wire dtype's size)."""
        wire = self.wire_dtype(t.dtype)
        with self._collective(kind, n_received * wire.itemsize, t.device):
            buf = torch.zeros((self.size, *t.shape), dtype=wire, device=t.device)
            buf[self.rank] = t
            dist.all_reduce(buf, group=self.group)
        return buf.to(t.dtype)

    def sum(self, t, kind: str = "sum"):
        """``t`` summed over the group's ranks (in ``wire_dtype``)."""
        wire = self.wire_dtype(t.dtype)
        out = t.to(wire, copy=True)
        with self._collective(kind, t.numel() * wire.itemsize * (self.size - 1), t.device):
            dist.all_reduce(out, group=self.group)
        return out.to(t.dtype)

    def gather_y(self, t, kind: str = "gather"):
        """This rank's Y slab ``t`` (dim 2) -> the whole tensor, the slabs
        joined in rank order, with no backward: the seg_preds map (uint8 on
        the wire, a quarter of its logits' float32) and Detection U-Net's
        detached softmax. ``gather_y`` (the module function) is the
        differentiable form the forward uses."""
        parts = self.all_gather(t, kind, t.numel() * (self.size - 1))
        return parts.movedim(0, 2).reshape(*t.shape[:2], self.size * t.shape[2], *t.shape[3:])

    def rows(self, y: int):
        """This rank's rows of an image of ``y`` rows, as a slice."""
        n = y // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def slab(self, t):
        """This rank's Y slab (dim 2) of a whole tensor or array."""
        return t[:, :, self.rows(t.shape[2])]

    @contextlib.contextmanager
    def forward(self):
        """Inside: the ops take this rank's Y slabs (``space()`` is this
        group)."""
        _SPACE.append(self)
        try:
            yield self
        finally:
            _SPACE.pop()

    def train(self, fn, img, cf):
        """``fn(img)``, a forward that takes the whole image and gives
        outputs gathered along Y, run on this rank's Y slab of ``img``
        inside the group with autograd as the caller has it: JAX's
        ``make_spatial_train_step`` and ``make_spatial_loss_eval``. The
        backward of the outputs sends each slab's gradients back through the
        primitives' backward collectives. The cap is checked against
        ``img``."""
        y = img.shape[2]
        check_space_cap(cf, self.size, y)
        if y % self.size:
            raise ValueError(f"an image of Y {y} does not split into {self.size} equal slabs")
        n = y // self.size
        with self.forward():
            return fn(img[:, :, self.rank * n:(self.rank + 1) * n].contiguous())

    def run(self, fn, img, cf):
        """``train`` for a test forward: JAX's ``make_spatial_predict``.
        Under ``MDT_SP_VERIFY`` each new input shape's outputs are held once
        against ``fn(img)`` on this process alone (atol 1e-5); an output
        that stays on the slab (the seg logits) against its rows."""
        out = self.train(fn, img, cf)
        if os.environ.get("MDT_SP_VERIFY") and tuple(img.shape) not in self._verified:
            ref, got = tensor_leaves(fn(img)), tensor_leaves(out)
            if len(ref) != len(got):
                raise AssertionError(f"spatial-predict verify failed: {len(got)} outputs, {len(ref)} on one process")
            for a, b in zip(ref, got):
                if a.shape != b.shape and a.dim() > 2 and a.shape[2] == self.size * b.shape[2]:
                    a = self.slab(a)
                np.testing.assert_allclose(
                    a.detach().double().cpu().numpy(), b.detach().double().cpu().numpy(), atol=1e-5,
                    err_msg="spatial-predict verify failed: the spatial forward differs from the single-process "
                            "forward")
            self._verified.add(tuple(img.shape))
        return out


def _edge(row, count: int, pad):
    """``count`` rows of ``pad`` shaped as ``row`` (one row, dim 2), or the
    row repeated for ``pad == "replicate"``."""
    shape = list(row.shape)
    shape[2] = count
    return row.expand(shape) if pad == "replicate" else row.new_full(shape, pad)


class _Halo(torch.autograd.Function):
    """``halo_exchange`` on a slab inside a space group; the backward sends
    the halo rows' gradients back to the ranks that lent them (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, sg, lo: int, hi: int, pad):
        ctx.sg, ctx.lo, ctx.hi, ctx.pad = sg, lo, hi, pad
        rank, size, n = sg.rank, sg.size, x.shape[2]
        got = lo * (rank > 0) + hi * (rank < size - 1)
        ctx.n_received = got * x[:, :, :1].numel()
        parts = sg.all_gather(torch.cat([x[:, :, :hi], x[:, :, n - lo:]], dim=2), "halo", ctx.n_received)
        before = parts[rank - 1][:, :, hi:] if rank > 0 else _edge(x[:, :, :1], lo, pad)
        after = parts[rank + 1][:, :, :hi] if rank < size - 1 else _edge(x[:, :, n - 1:], hi, pad)
        return torch.cat([before, x, after], dim=2)

    @staticmethod
    def backward(ctx, g):
        sg, lo, hi = ctx.sg, ctx.lo, ctx.hi
        rank, size = sg.rank, sg.size
        n = g.shape[2] - lo - hi
        g_lo, g_mid, g_hi = g.split([lo, n, hi], dim=2)
        # rank r + 1 read my last lo rows as its rows before; rank r - 1 my first hi rows as its rows after
        parts = sg.all_gather(torch.cat([g_lo, g_hi], dim=2), "halo_bwd", ctx.n_received)
        gx = g_mid.clone()
        if rank < size - 1:
            gx[:, :, n - lo:] += parts[rank + 1][:, :, :lo]
        elif ctx.pad == "replicate" and hi:
            gx[:, :, n - 1:] += g_hi.sum(dim=2, keepdim=True)
        if rank > 0:
            gx[:, :, :hi] += parts[rank - 1][:, :, lo:]
        elif ctx.pad == "replicate" and lo:
            gx[:, :, :1] += g_lo.sum(dim=2, keepdim=True)
        return gx, None, None, None, None


def halo_exchange(x, lo: int, hi: int, pad=0.0):
    """The image rows ``[r0 - lo, r1 + hi)`` for this rank's Y slab ``x`` =
    rows ``[r0, r1)`` (dim 2): ``lo`` rows of the previous rank and ``hi``
    of the next, or at the image's edge ``pad`` (a value, or ``"replicate"``
    for the edge row repeated). Outside a spatial forward the slab is the
    whole image and only the padding is added."""
    if lo == hi == 0:
        return x
    sg = space()
    if sg is None or sg.size == 1:
        return torch.cat([_edge(x[:, :, :1], lo, pad), x, _edge(x[:, :, x.shape[2] - 1:], hi, pad)], dim=2)
    if lo > x.shape[2] or hi > x.shape[2]:
        raise ValueError(f"a Y slab of {x.shape[2]} rows cannot lend {lo} rows before and {hi} after; the level "
                         "should have been gathered (space_fence)")
    return _Halo.apply(x, sg, lo, hi, pad)


class _SpaceSum(torch.autograd.Function):
    """``space_sum``: all-reduce forward and backward (module docstring)."""

    @staticmethod
    def forward(ctx, t, sg):
        ctx.sg = sg
        return sg.sum(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.sg.sum(g, "sum_bwd"), None


def space_sum(t, sg=None):
    """A sum over this rank's slab -> the sum over the image's rows: over
    ``sg`` where given (a sum taken after the forward, as the seg loss's),
    else over the running spatial forward's group; the identity outside
    one."""
    sg = space() if sg is None else sg
    return t if sg is None else _SpaceSum.apply(t, sg)


class _GatherY(torch.autograd.Function):
    """``gather_y``: the slabs joined; the backward sums the ranks'
    gradients of the whole tensor and keeps this rank's slab (module
    docstring)."""

    @staticmethod
    def forward(ctx, t, sg):
        ctx.sg = sg
        return sg.gather_y(t)

    @staticmethod
    def backward(ctx, g):
        sg = ctx.sg
        return sg.slab(sg.sum(g.contiguous(), "gather_bwd")), None


def gather_y(t):
    """This rank's Y slab ``t`` (dim 2) -> the whole tensor, the group's
    slabs joined in rank order, inside a spatial forward; the identity
    outside one. The slabs cross in ``SpaceGroup.wire_dtype`` (float32 for
    a bfloat16 head, integers as themselves), and ``stats["gather"]``
    counts the other ranks' slabs at that size; the backward
    (``gather_bwd``) the whole gradient's other S - 1 copies."""
    sg = space()
    return t if sg is None else _GatherY.apply(t, sg)


def slab_of(t):
    """This rank's Y slab of a whole (replicated) tensor inside a spatial
    forward; the identity outside one."""
    sg = space()
    return t if sg is None else sg.slab(t)


def keeps_split(n: int, stride: int = 1, halo: int = 1) -> bool:
    """Whether a slab of ``n`` rows stays split ahead of a stage whose first
    op has ``stride`` and reads ``halo`` rows beyond the slab: its rows
    divide by ``stride`` and cover ``halo``."""
    return n % stride == 0 and n >= halo


def space_fence(x, split: bool, stride: int = 1, halo: int = 1):
    """``(x, whether it stays split)`` ahead of such a stage: a split tensor
    stays split while ``keeps_split``; otherwise it is gathered and the
    stage runs replicated."""
    if not split or space() is None:
        return x, False
    if keeps_split(x.shape[2], stride, halo):
        return x, True
    return gather_y(x), False


@contextlib.contextmanager
def _space_as(sg):
    _SPACE.append(sg)
    try:
        yield
    finally:
        _SPACE.pop()


def checkpoint(fn, x):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(x)`` whose
    recomputation in the backward sees the SpaceGroup (or None, on a
    replicated level) that the forward saw, so that it re-issues the same
    halos and sums in the backward on every rank of the group."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    sg = space()
    return torch_checkpoint(fn, x, use_reentrant=False,
                            context_fn=lambda: (contextlib.nullcontext(), _space_as(sg)))


def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, port, args):
    os.environ.update(MDT_DIST_COORD=f"127.0.0.1:{port}", MDT_DIST_NPROCS=str(world), MDT_DIST_RANK=str(rank))
    fn(*args)


def spawn_ranks(fn, world: int, args=()):
    """Run ``fn(*args)`` in ``world`` new processes (the spawn method), each
    with the ``MDT_DIST_*`` triple of its rank on a free local port, and
    wait for them all. A rank that raises fails the run: its exception is
    raised here and the other ranks are stopped."""
    import torch.multiprocessing as tmp

    tmp.start_processes(_rank_entry, args=(fn, world, free_port(), tuple(args)), nprocs=world, join=True,
                        start_method="spawn")
