"""Threaded prefetching batch pipeline of the port (MultiThreadedAugmenter
replacement).

Counterpart of ``medicaldetectiontoolkit_tpu/data/loader.py`` with the same
classes and contracts. The reference feeds its GPU from batchgenerators'
``MultiThreadedAugmenter`` with n_workers processes and per-worker seeds
(``experiments/lidc_exp/data_loader.py:205``). Here the augmentation is
NumPy and the native host library, whose ctypes calls release the GIL, so a
thread pool and a bounded queue give the same asynchronous host pipeline
without pickling batches across processes.

A pipeline is (sampler -> transform chain); each worker owns a seeded
``np.random.RandomState`` and a bounded queue, and ``__next__`` reads the
workers' queues in turn, so the sequence of batches is fixed by the seeds
whatever the thread scheduler does (JAX's single queue takes them in the
order they are made). Ranks that must take the same rows at every step,
those of a space group (``parallel/mesh.py``), build the same generator
and get the same batches. Worker errors surface in ``__next__`` when that
worker's turn comes; ``shutdown`` stops the workers, drains the queues and
joins the threads.
``batch_seconds`` holds the host seconds each batch took to generate
(sampling and transforms, without the wait for room in the queue), from
which the loader's capacity in patches/s follows.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np


class BatchGeneratorBase:
    """Interface: subclass provides generate_train_batch(rng) -> batch dict."""

    def __init__(self, data, batch_size, cf):
        self._data = data
        self.batch_size = batch_size
        self.cf = cf

    def generate_train_batch(self, rng):
        raise NotImplementedError


class MultiThreadedGenerator:
    """Async prefetch of (generator + transforms) with n_workers threads,
    taken from the workers in turn; ``queue_size`` batches are buffered in
    all (at least one per worker)."""

    def __init__(
        self,
        generator: BatchGeneratorBase,
        transforms: Optional[List[Callable]] = None,
        n_workers: int = 4,
        seeds=None,
        queue_size: int = 8,
    ):
        self.generator = generator
        self.transforms = transforms or []
        self.n_workers = max(1, n_workers)
        seeds = seeds if seeds is not None else range(self.n_workers)
        self._rngs = [np.random.RandomState(s) for s in seeds]
        self._queues = [queue.Queue(maxsize=max(1, queue_size // self.n_workers)) for _ in range(self.n_workers)]
        self._turn = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False
        self.batch_seconds: List[float] = []

    def _worker(self, wid):
        rng, out = self._rngs[wid], self._queues[wid]
        while not self._stop.is_set():
            try:
                t0 = time.perf_counter()
                batch = self.generator.generate_train_batch(rng)
                for t in self.transforms:
                    batch = t(batch, rng)
                self.batch_seconds.append(time.perf_counter() - t0)
            except Exception as e:  # surface worker errors to the consumer
                batch = e
            while not self._stop.is_set():
                try:
                    out.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def _start(self):
        if self._started:
            return
        self._started = True
        for wid in range(self.n_workers):
            t = threading.Thread(target=self._worker, args=(wid,), daemon=True)
            t.start()
            self._threads.append(t)

    def __iter__(self):
        return self

    def __next__(self):
        self._start()
        item = self._queues[self._turn].get()
        self._turn = (self._turn + 1) % self.n_workers
        if isinstance(item, Exception):
            self.shutdown()
            raise item
        return item

    next = __next__

    def shutdown(self, timeout: float = 60.0):
        """Stop the workers, drain the queues so none stays blocked on put(),
        and join them, all within ``timeout`` seconds (a worker finishes the
        batch it is making first)."""
        self._stop.set()
        for t, q in zip(self._threads, self._queues):
            while t.is_alive():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
                timeout -= 0.05
                if timeout <= 0:
                    raise RuntimeError(f"loader worker {t.name} did not stop")
        self._threads = []


class SingleThreadedGenerator:
    """Synchronous variant (debugging / deterministic tests)."""

    def __init__(self, generator, transforms=None, seed=0):
        self.generator = generator
        self.transforms = transforms or []
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.generator.generate_train_batch(self._rng)
        for t in self.transforms:
            batch = t(batch, self._rng)
        return batch

    next = __next__

    def shutdown(self):
        pass
