"""Data parallelism of the port: W ranks, one process per card, over
``torch.distributed``.

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
  of 0. The forward needs no communication: JAX's ``"batch_norm"`` is
  ``GroupNorm(1)``, per element.
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

Spatial partitioning (JAX's ``n_space_parallel``) is not ported: ROADMAP.md,
Queue 1. There is no fallback to more ranks than cards.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from medicaldetectiontoolkit_torch.ops.topk import top_k

# the DataParallel whose step is running (a stack, as JAX's _SPATIAL_TRACE_CTX)
_STEP: list = []


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
    the whole job): the step context, the draws' rows, the gradient
    all-reduce and the parameter broadcast."""

    def __init__(self, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("data parallelism needs a process group: maybe_initialize_distributed (MDT_DIST_*) or "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.rank, self.world = rank_and_world(group)
        self.src = dist.get_global_rank(group, 0) if group is not None else 0
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

    def _flat_groups(self, tensors):
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        return by_dtype.values()

    def reduce_gradients(self, params):
        """Sum the parameters' ``.grad`` over the ranks: one all-reduce of a
        flat buffer per dtype."""
        for grads in self._flat_groups([p.grad for p in params]):
            flat = self.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def broadcast_params(self, module):
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            for tensors in self._flat_groups([*module.parameters(), *module.buffers()]):
                flat = torch.cat([t.reshape(-1) for t in tensors])
                dist.broadcast(flat, self.src, group=self.group)
                for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
                    t.copy_(part.view_as(t))


def gather_objects(items):
    """Every rank's list ``items`` (picklable), concatenated in rank order,
    on every rank; ``items`` itself without a process group."""
    _, world = rank_and_world()
    if world == 1:
        return list(items)
    parts = [None] * world
    dist.all_gather_object(parts, list(items))
    return [x for part in parts for x in part]


def gather_interleaved(items):
    """Every rank's list ``items`` merged round-robin (rank 0's first, then
    rank 1's first, ...): the order of the data set whose patients the ranks
    took as ``pids[rank::world]``."""
    _, world = rank_and_world()
    if world == 1:
        return list(items)
    parts = [None] * world
    dist.all_gather_object(parts, list(items))
    return [part[i] for i in range(max(len(p) for p in parts)) for part in parts if i < len(part)]


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
