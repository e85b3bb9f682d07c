"""The port's threaded batch pipeline and class-balanced sampling against the
JAX package's, on the CPU.

``MultiThreadedGenerator`` with one worker gives the same sequence of batches
as JAX's, and so does ``SingleThreadedGenerator``; with more than one, the
port takes the workers' batches in turn, so the sequence is the seeds'
whatever the workers' speeds (JAX's follows the thread scheduler); a
worker's exception reaches ``__next__``; ``shutdown`` returns with no live
worker thread, also with many workers blocked on a full queue;
``get_class_balanced_patients`` gives the same indices from the same
``RandomState``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from medicaldetectiontoolkit_tpu.data import dataloader_utils as jdutils  # noqa: E402
from medicaldetectiontoolkit_tpu.data import loader as jloader  # noqa: E402
from medicaldetectiontoolkit_torch.data import dataloader_utils as tdutils  # noqa: E402
from medicaldetectiontoolkit_torch.data import loader as tloader  # noqa: E402


class _Draws:
    """A generator whose batches are its RandomState's draws."""

    def generate_train_batch(self, rng):
        return {"data": rng.rand(2, 3), "pick": rng.randint(0, 1000, 4)}


def _scale(batch, rng):
    batch["data"] = batch["data"] * rng.rand()
    return batch


def _take(gen, n):
    out = [next(gen) for _ in range(n)]
    gen.shutdown()
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for k in x:
            assert np.array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 7])
def test_one_worker_sequence_matches_jax(seed):
    out = _take(tloader.MultiThreadedGenerator(_Draws(), [_scale], n_workers=1, seeds=[seed], queue_size=2), 12)
    ref = _take(jloader.MultiThreadedGenerator(_Draws(), [_scale], n_workers=1, seeds=[seed], queue_size=2), 12)
    _same_batches(out, ref)


def test_single_threaded_matches_jax():
    _same_batches(_take(tloader.SingleThreadedGenerator(_Draws(), [_scale], seed=3), 6),
                  _take(jloader.SingleThreadedGenerator(_Draws(), [_scale], seed=3), 6))


class _FailsAt:
    def __init__(self, n):
        self.n, self.calls = n, 0

    def generate_train_batch(self, rng):
        self.calls += 1
        if self.calls == self.n:
            raise ValueError("patient file is corrupt")
        return {"x": rng.rand()}


def test_worker_exception_reaches_next():
    gen = tloader.MultiThreadedGenerator(_FailsAt(3), n_workers=1, seeds=[0])
    next(gen), next(gen)
    with pytest.raises(ValueError, match="corrupt"):
        next(gen)
    assert not any(t.is_alive() for t in gen._threads)


def test_shutdown_joins_workers_blocked_on_a_full_queue():
    before = set(threading.enumerate())
    gen = tloader.MultiThreadedGenerator(_Draws(), n_workers=12, queue_size=2)
    next(gen)
    workers = list(gen._threads)
    assert len(workers) == 12
    gen.shutdown()
    assert not any(t.is_alive() for t in workers)
    assert set(threading.enumerate()) <= before


def test_many_workers_keep_each_worker_sequence():
    """More workers than cores, fast thread switches: every worker's batches
    arrive in its own RandomState's order, none lost or repeated."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n_workers = 2 * (os.cpu_count() or 4)

        class Tagged:
            def generate_train_batch(self, rng):
                return {"draw": rng.rand(), "rng": id(rng)}

        gen = tloader.MultiThreadedGenerator(Tagged(), n_workers=n_workers, seeds=range(n_workers), queue_size=4)
        worker_of = {id(rng): w for w, rng in enumerate(gen._rngs)}
        got = _take(gen, 400)
    finally:
        sys.setswitchinterval(switch)
    per_worker = {}
    for b in got:
        per_worker.setdefault(worker_of[b["rng"]], []).append(b["draw"])
    assert sum(map(len, per_worker.values())) == 400
    for w, seq in per_worker.items():
        rng = np.random.RandomState(w)
        assert seq == [rng.rand() for _ in seq]


def test_workers_batches_come_in_turn_whatever_their_speed():
    """Worker 0 is slow and the others fast: batch i is still worker i % 3's
    (i // 3)-th draw, so two generators of the same seeds, as the ranks of a
    space group build them, give the same sequence."""

    class Uneven:
        worker_of = {}

        def generate_train_batch(self, rng):
            worker = self.worker_of[id(rng)]
            time.sleep(0.02 if worker == 0 else 0.0)
            return {"draw": rng.rand(), "worker": worker}

    seeds = [5, 9, 2]
    runs = []
    for _ in range(2):
        source = Uneven()
        gen = tloader.MultiThreadedGenerator(source, n_workers=3, seeds=seeds, queue_size=6)
        source.worker_of = {id(rng): w for w, rng in enumerate(gen._rngs)}
        runs.append(_take(gen, 12))
    want = {w: np.random.RandomState(s) for w, s in enumerate(seeds)}
    for i, b in enumerate(runs[0]):
        assert b["worker"] == i % 3 and b["draw"] == want[i % 3].rand()
    assert [b["draw"] for b in runs[0]] == [b["draw"] for b in runs[1]]


@pytest.mark.parametrize("seed,batch_size,slack", [(0, 8, 0.2), (1, 20, 0.1), (2, 5, 0.0), (3, 12, 0.5)])
def test_class_balanced_patients_match_jax(seed, batch_size, slack):
    rng = np.random.RandomState(100 + seed)
    targets = [list(rng.randint(-1, 3, rng.randint(0, 4))) for _ in range(15)]
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    picks = tdutils.get_class_balanced_patients(targets, batch_size, 2, slack_factor=slack, rng=r1)
    assert picks == jdutils.get_class_balanced_patients(targets, batch_size, 2, slack_factor=slack, rng=r2)
    assert r1.rand() == r2.rand()


def test_class_balanced_patients_without_the_scarcest_class():
    """No patient has class 1: the attempts are bounded, as in JAX."""
    targets = [[0], [0, 0], []]
    r1, r2 = np.random.RandomState(0), np.random.RandomState(0)
    picks = tdutils.get_class_balanced_patients(targets, 4, 2, slack_factor=0.0, rng=r1)
    assert picks == jdutils.get_class_balanced_patients(targets, 4, 2, slack_factor=0.0, rng=r2)
