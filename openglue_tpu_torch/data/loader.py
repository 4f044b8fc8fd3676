"""Batching loader with background prefetch (port of
``openglue_tpu/data/loader.py``; the reference uses torch's DataLoader,
megadepth_datamodule.py:39-55).

Worker threads load dataset samples (h5py and cv2 release the interpreter
lock) and run the collate, so that they share the dataset's image cache;
batches come out in sampler order, and a bounded admission window keeps at
most ``prefetch + num_workers`` batches ahead of the consumer. Exceptions
raised by a worker or by the sampler are raised in the consumer.

A dataset draws its random crops and warps from its generator ``rng``.
Without workers the batches draw from it in turn. Worker threads would
draw from it in whatever order they run, so each batch draws from a
generator of its own instead, seeded by one draw of the dataset's at the
start of the pass and by the batch's place in the sampler's order: the
batches are the same however the threads are scheduled.
"""

from __future__ import annotations

import copy
import itertools
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

_SENTINEL = object()


class DataLoader:
    """Iterate (dataset, sampler) -> collated batches with prefetching.

    sampler yields dataset indices (finite or infinite); num_batches bounds
    iteration when the sampler is infinite.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        sampler: Optional[Iterable[int]] = None,
        num_workers: int = 2,
        prefetch: int = 4,
        num_batches: Optional[int] = None,
        drop_last: bool = True,
        batch_sampler: Optional[Iterable] = None,
    ):
        """``batch_sampler``: pre-formed index batches instead of
        (sampler, batch_size) chunking — each item is either a sequence of
        dataset indices or ``(indices, collate_kwargs)``, with the kwargs
        forwarded to collate_fn (the contract BucketGroupedIndexBatches uses
        to carry ``force_bucket``). Loading AND collation still run in the
        worker pool. batch_size/drop_last/sampler are ignored in this mode —
        the batch sampler owns batch formation."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.num_batches = num_batches
        self.drop_last = drop_last
        self.batch_sampler = batch_sampler

    def _index_batches(self) -> Iterator[tuple]:
        """Yields (indices, collate_kwargs) pairs."""
        if self.batch_sampler is not None:
            for item in self.batch_sampler:
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and isinstance(item[1], dict)
                ):
                    yield item
                else:
                    yield item, {}
            return
        indices = iter(self.sampler) if self.sampler is not None else iter(range(len(self.dataset)))
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch, {}
                batch = []
        if batch and not self.drop_last:
            yield batch, {}

    def __iter__(self) -> Iterator:
        batches = self._index_batches()
        if self.num_batches is not None:
            batches = itertools.islice(batches, self.num_batches)

        if self.num_workers == 0:
            for idx_batch, kwargs in batches:
                yield self.collate_fn([self.dataset[i] for i in idx_batch], **kwargs)
            return

        idx_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch * 2)
        stop = threading.Event()
        # Backpressure via an admission window: a worker may only start
        # collating seq when seq < consumed + window, so at most ``window``
        # batches ever exist beyond the consumer. Because workers pull seqs in
        # order, the smallest outstanding seq is always admitted — this cannot
        # deadlock (a bounded semaphore can: out-of-order results may hold
        # every slot while the next-needed seq's worker blocks).
        window = self.prefetch + self.num_workers
        consumed = [0]
        # the seed of the batches' generators (module docstring)
        draws_seed = int(self.dataset.rng.integers(1 << 63)) if hasattr(self.dataset, "rng") else None

        # Order-preserving: one dispatcher assigns sequence numbers; a single
        # reorder buffer emits in order.
        results = {}
        results_lock = threading.Lock()
        results_cv = threading.Condition(results_lock)

        def put_checking_stop(item) -> bool:
            """Bounded-queue put that never blocks past ``stop`` — a thread
            parked forever in queue.put/get can be frozen inside an h5py C
            call at interpreter shutdown while holding the HDF5 global lock,
            deadlocking h5py's atexit close (observed: clean script exit hung
            forever after the consumer stopped mid-stream)."""
            while not stop.is_set():
                try:
                    idx_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for seq, idx_batch in enumerate(batches):
                    if not put_checking_stop((seq, idx_batch)):
                        break
            except Exception as exc:
                # a sampler that raises must surface in the consumer, which
                # would otherwise wait forever for results that never come
                with results_cv:
                    results[-2] = exc
                    results_cv.notify_all()
            finally:
                for _ in range(self.num_workers):
                    put_checking_stop(_SENTINEL)

        def worker():
            dataset = copy.copy(self.dataset)  # this thread's view: its own rng, the caches shared
            while not stop.is_set():
                try:
                    item = idx_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is _SENTINEL:
                    with results_cv:
                        results[-1] = results.get(-1, 0) + 1  # worker-done count
                        results_cv.notify_all()
                    return
                seq, (idx_batch, kwargs) = item
                with results_cv:
                    while seq >= consumed[0] + window and not stop.is_set():
                        results_cv.wait(timeout=0.1)
                if stop.is_set():
                    return
                if draws_seed is not None:
                    dataset.rng = np.random.default_rng([draws_seed, seq])
                try:
                    batch = self.collate_fn([dataset[i] for i in idx_batch], **kwargs)
                except Exception as exc:  # propagate to consumer
                    batch = exc
                with results_cv:
                    results[seq] = batch
                    results_cv.notify_all()

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            seq = 0
            while True:
                with results_cv:
                    while (
                        seq not in results
                        and -2 not in results
                        and results.get(-1, 0) < self.num_workers
                    ):
                        results_cv.wait(timeout=0.1)
                    if seq in results:
                        batch = results.pop(seq)
                    elif -2 in results:  # feeder (sampler) exception
                        raise results.pop(-2)
                    elif results.get(-1, 0) >= self.num_workers:
                        return
                    else:
                        continue
                with results_cv:
                    consumed[0] = seq + 1
                    results_cv.notify_all()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                seq += 1
        finally:
            stop.set()
            with results_cv:
                results_cv.notify_all()
            # join so no thread is still inside an h5/cv2 C call (GIL
            # released, HDF5 lock held) when the interpreter finalizes —
            # daemon threads frozen there deadlock h5py's atexit close
            try:
                for t in threads:
                    t.join(timeout=5.0)
            except Exception:
                # generator finalized during interpreter shutdown: threading
                # internals may already be torn down — threads are daemonic,
                # nothing left to clean up
                pass
