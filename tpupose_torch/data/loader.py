"""Batched, prefetching input pipeline (port of ``tpupose/data/loader.py``,
the reference's ``MultiprocessIterator``).

A worker process pool (``spawn``) decodes and augments samples, and a
background thread assembles them into a bounded queue of ready batches, so
the host pipeline overlaps with the device's steps.  Batches are
``TrainBatch``es of CPU tensors, in pinned memory with ``pin_memory=True``
(for a CUDA step's asynchronous copy).  Workers import this module and the
dataset's, never touch CUDA, and send numpy samples back.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from typing import Iterator

import numpy as np

_WORKER_DATASET = None


def _worker_init(dataset, seed, rank_counter):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    # Every spawned worker receives a pickled copy of the dataset carrying
    # the SAME RandomState — reseed per worker or they would all draw
    # identical augmentation streams.  The seed derives from (loader seed,
    # worker rank), not the pid, so multi-worker runs stay reproducible.
    with rank_counter.get_lock():
        rank = rank_counter.value
        rank_counter.value += 1
    _WORKER_DATASET._rng = np.random.RandomState(
        (seed * 100003 + rank * 7919 + 1) % (2 ** 31))


def _worker_sample(index: int):
    """Load one sample; failures (corrupt image, bad annotation) degrade to
    None so one bad record can't kill the whole training run — the feeder
    skips it and the loader keeps streaming (the reference's closest
    analogue is its resample-on-missing-annotations loop,
    ``coco_data_loader.py:351-353``)."""
    try:
        return _WORKER_DATASET.sample(index)
    except Exception as e:  # noqa: BLE001 - worker must never crash
        print(f"[loader] sample {index} failed: {type(e).__name__}: {e}",
              flush=True)
        return None


def _try_sample(dataset, index: int):
    """Inline-mode counterpart of ``_worker_sample``'s fault tolerance."""
    try:
        return dataset.sample(index)
    except Exception as e:  # noqa: BLE001
        print(f"[loader] sample {index} failed: {type(e).__name__}: {e}",
              flush=True)
        return None


class BatchLoader:
    """Iterable over ``TrainBatch``es of CPU tensors.

    num_workers=0 loads inline (SerialIterator parity); >0 uses a spawn
    process pool (MultiprocessIterator parity).  ``pin_memory`` puts each
    batch in page-locked memory (pass it for a CUDA step).  ``close()``
    stops the feeder threads and shuts the pool down.
    """

    def __init__(self, dataset, batch_size: int, max_persons: int = None,
                 shuffle: bool = True, repeat: bool = True,
                 num_workers: int = 0, prefetch: int = 2, seed: int = 0,
                 pin_memory: bool = False, worker_timeout: float = 300.0):
        self.dataset = dataset
        self.batch_size = batch_size
        if max_persons is None:
            # derive from the dataset's config: the dataset masks out
            # persons beyond ITS max_persons, so a mismatched loader cap
            # would silently truncate GT without the mask protection
            max_persons = getattr(getattr(dataset, "cfg", None),
                                  "max_persons", 16)
        self.max_persons = max_persons
        self.shuffle = shuffle
        self.repeat = repeat
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.worker_timeout = worker_timeout
        self._rng = np.random.RandomState(seed)
        self._closed = threading.Event()
        self._feeders = []
        self._pool = None
        if num_workers > 0:
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(
                num_workers, initializer=_worker_init,
                initargs=(dataset, seed, ctx.Value("i", 0)))

    def _index_stream(self) -> Iterator[int]:
        n = len(self.dataset)
        while True:
            order = (self._rng.permutation(n) if self.shuffle
                     else np.arange(n))
            yield from order
            if not self.repeat:
                return

    def _assemble(self, samples):
        # local import: tpupose_torch.train.trainer imports
        # tpupose_torch.data.gt, so a module-level import here would be
        # circular
        import torch

        from tpupose_torch.train.trainer import TrainBatch, pad_poses

        imgs = np.stack([s[0] for s in samples])
        # keypoint count rides the samples' (P, K, 3) tables: 18 for the
        # pose dataset, 70/21 for single-branch crop datasets
        poses = pad_poses([s[1] for s in samples], self.max_persons,
                          num_keypoints=np.shape(samples[0][1])[1])
        masks = np.stack([s[2] for s in samples])
        tensors = [torch.from_numpy(a) for a in (imgs, poses, masks)]
        if self.pin_memory:
            tensors = [t.pin_memory() for t in tensors]
        return TrainBatch(*tensors)

    def _sample_stream(self):
        idx = self._index_stream()
        if self._pool is not None:
            # Windowed dispatch instead of Pool.imap: imap's feeder thread
            # consumes the (infinite) index stream without backpressure and
            # buffers every decoded sample, growing host memory without
            # bound whenever workers outpace the training step.  A bounded
            # deque of in-flight AsyncResults caps that at window size.
            import collections

            window = max(2 * self.num_workers,
                         self.prefetch * self.batch_size)
            inflight = collections.deque()
            exhausted = False
            while not self._closed.is_set():
                while not exhausted and len(inflight) < window:
                    try:
                        i = next(idx)
                    except StopIteration:
                        exhausted = True
                        break
                    inflight.append(
                        self._pool.apply_async(_worker_sample, (i,)))
                if not inflight:
                    return
                # Timeout guards against HARD worker deaths (segfault /
                # OOM-kill): apply_async results of a dead worker never
                # complete, unlike Python exceptions (which propagate via
                # _worker_sample) — without it training would hang forever.
                try:
                    s = inflight.popleft().get(timeout=self.worker_timeout)
                except multiprocessing.TimeoutError:
                    raise RuntimeError(
                        f"data worker produced no sample within "
                        f"{self.worker_timeout}s — a worker process likely "
                        "died hard (segfault/OOM-kill); restart with fewer "
                        "workers or a larger worker_timeout")
                if s is not None:
                    yield s
        else:
            for i in idx:
                if self._closed.is_set():
                    return
                s = _try_sample(self.dataset, i)
                if s is not None:
                    yield s

    def __iter__(self) -> Iterator[TrainBatch]:
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def put(item) -> bool:
            """Block until ``item`` is queued or the loader is closed."""
            while not self._closed.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def feeder():
            try:
                buf = []
                for s in self._sample_stream():
                    buf.append(s)
                    if len(buf) == self.batch_size:
                        if not put(self._assemble(buf)):
                            return
                        buf = []
                if buf and not self.repeat:
                    put(self._assemble(buf))
            except BaseException as e:  # noqa: BLE001
                # surface feeder failures to the consumer — swallowing
                # them would make an infinite training loader terminate
                # "successfully" mid-run
                put(e)
            finally:
                put(stop)

        t = threading.Thread(target=feeder, daemon=True)
        self._feeders.append(t)
        t.start()
        while True:
            item = out.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        """Stop the feeders, then shut the pool down gracefully: no new
        tasks, the in-flight ones finish, the workers exit.
        ``Pool.terminate`` can kill a worker halfway through writing its
        result into the pool's shared pipe, and the pool's result thread
        then waits forever for the rest of that message."""
        self._closed.set()
        for t in self._feeders:
            t.join(timeout=self.worker_timeout)
        self._feeders = []
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
