"""paddle.io: port of paddle_tpu/io/__init__.py — Dataset, DataLoader and
the samplers.

Workers produce host data: forked worker processes run ``dataset[i]``
only (numpy), thread workers fetch and collate, and ``default_collate_fn``
builds each batch's Tensors on the current place (the card unless
``set_device("cpu")`` chose the CPU), in the process that iterates. A
forked child must never touch CUDA, so once CUDA is initialized in this
process the workers are threads, the rule the reference applies once its
XLA backend is up. ``RandomSampler`` draws its order from
``framework.random``'s seed stream as the reference does, so after
``seed(s)`` both give the same batch orders.
"""
from __future__ import annotations

import math
import os
import queue
import threading

import numpy as np

from ..framework import random as _random
from ..tensor import Tensor


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths) and abs(sum(lengths) - 1) < 1e-6:
        n = len(dataset)
        lengths = [int(math.floor(n * l)) for l in lengths]
        lengths[-1] += n - sum(lengths)
    rng = np.random.default_rng(_random.default_generator().next_seed())
    idx = rng.permutation(sum(lengths)).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, idx[off:off + l]))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)

    def __iter__(self):
        rng = np.random.default_rng(_random.default_generator().next_seed())
        n = len(self.data_source)
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        rng = np.random.default_rng(_random.default_generator().next_seed())
        p = self.weights / self.weights.sum()
        return iter(rng.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Reference: io/dataloader/batch_sampler.py DistributedBatchSampler —
    shards the index space across data-parallel ranks."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist
            up = dist.is_available() and dist.is_initialized()
            num_replicas = num_replicas or (dist.get_world_size()
                                            if up else 1)
            rank = rank if rank is not None else (dist.get_rank()
                                                  if up else 0)
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - n)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def _batch_tensor(arr: np.ndarray) -> Tensor:
    """A collated numpy batch as a Tensor of the same dtype (the
    reference's ``Tensor(array)`` keeps it) on the current place."""
    from ..framework.place import current_device
    from ..tensor import _from_numpy
    return Tensor(_from_numpy(arr).to(current_device()))


def default_collate_fn(batch):
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return _batch_tensor(np.stack(batch))
    if isinstance(sample, Tensor):
        from ..ops.manipulation import stack
        return stack(batch, 0)
    if isinstance(sample, (int, np.integer)):
        return _batch_tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return _batch_tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class _WorkerPool:
    """Thread-based prefetch pool (the reference's fallback to its forked
    workers): the heavy lifting (decode, augment) happens in numpy, which
    releases the GIL, and threads may touch the card."""

    def __init__(self, fetch, indices_iter, num_workers, prefetch):
        self._fetch = fetch
        self._indices = list(indices_iter)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 2))
        self._stop = threading.Event()
        self._order = {}
        self._next_emit = 0
        self._lock = threading.Lock()
        self._pos = 0
        self._threads = [threading.Thread(target=self._work, daemon=True)
                         for _ in range(num_workers)]
        self._emitted = 0
        self._total = len(self._indices)
        self._results: dict[int, object] = {}
        self._cv = threading.Condition()
        for t in self._threads:
            t.start()

    def _work(self):
        while not self._stop.is_set():
            with self._lock:
                if self._pos >= self._total:
                    return
                my = self._pos
                self._pos += 1
            try:
                res = self._fetch(self._indices[my])
            except Exception as e:  # propagate
                res = e
            with self._cv:
                self._results[my] = res
                self._cv.notify_all()

    def __iter__(self):
        for i in range(self._total):
            with self._cv:
                while i not in self._results:
                    self._cv.wait(timeout=60.0)
                res = self._results.pop(i)
            if isinstance(res, Exception):
                self._stop.set()
                raise res
            yield res

    def shutdown(self):
        self._stop.set()


def _process_worker_main(dataset, task_q, res_q, worker_init_fn, wid):
    """Forked worker body: fetch RAW samples (collate happens in the
    parent, so nothing framework-owned crosses the pickle boundary)."""
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        job = task_q.get()
        if job is None:
            return
        i, indices = job
        try:
            samples = [dataset[j] for j in indices]
            res_q.put((i, samples, None))
        except Exception as e:  # noqa: BLE001 — propagate to parent
            import traceback
            res_q.put((i, None, f"{type(e).__name__}: {e}\n"
                       f"{traceback.format_exc()}"))


class _ProcessWorkerPool:
    """Forked-process workers + queues — the reference's dataloader_iter
    architecture (python/paddle/io/dataloader/dataloader_iter.py forks
    ``num_workers`` processes over a blocking queue). Use for
    python-heavy transforms (image decode/augment) that hold the GIL;
    the thread pool (below) remains the fallback for non-forkable
    datasets. Workers only run ``dataset[i]``; collation stays in the
    parent process."""

    def __init__(self, dataset, indices_iter, num_workers, collate_fn,
                 worker_init_fn=None, prefetch=None):
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        self._collate = collate_fn
        self._indices = list(indices_iter)
        self._task_q = ctx.Queue()
        # bounded result queue = backpressure: once full, workers block on
        # put, so at most maxsize + num_workers batches are ever in flight
        # (same bound as the thread pool's prefetch window)
        maxsize = max(prefetch or 2 * num_workers, 2)
        self._res_q = ctx.Queue(maxsize=maxsize)
        for job in enumerate(self._indices):
            self._task_q.put(job)
        for _ in range(num_workers):
            self._task_q.put(None)
        self._procs = [
            ctx.Process(target=_process_worker_main,
                        args=(dataset, self._task_q, self._res_q,
                              worker_init_fn, w), daemon=True)
            for w in range(num_workers)]
        for p in self._procs:
            p.start()

    def __iter__(self):
        import queue as _queue
        pending = {}
        for i in range(len(self._indices)):
            while i not in pending:
                try:
                    j, samples, err = self._res_q.get(timeout=5.0)
                except _queue.Empty:
                    if any(not p.is_alive() and p.exitcode not in (0, None)
                           for p in self._procs):
                        self.shutdown()
                        raise RuntimeError(
                            "DataLoader worker process died (exitcode != 0)."
                            " If the dataset touches device state in "
                            "__getitem__, forked workers cannot run it — "
                            "set PADDLE_TPU_THREAD_WORKERS=1 to use the "
                            "thread pool instead.")
                    continue
                if err is not None:
                    self.shutdown()
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                pending[j] = samples
            yield self._collate(pending.pop(i))

    def shutdown(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)


class _BufferedReader:
    """Single-producer prefetcher: a thread fetches+collates the next
    batches while the consumer trains, bounded for backpressure.

    Reference: ``fluid/operators/reader/buffered_reader.cc`` — a C++
    double-buffer decoupling batch production from consumption. Batches are
    handed over as objects; the numpy work in the producer releases the
    GIL, which is where the overlap comes from."""

    _DONE = object()

    def __init__(self, make_iter, capacity: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(capacity, 2))
        self._stop = threading.Event()

        def produce():
            try:
                for batch in make_iter():
                    while not self._stop.is_set():
                        try:
                            self._q.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                self._q.put(self._DONE)
            except Exception as e:
                self._q.put(e)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def shutdown(self):
        self._stop.set()
        # drain so the producer isn't stuck on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.num_workers = num_workers
        self.use_buffer_reader = use_buffer_reader
        self.prefetch_factor = prefetch_factor
        self.collate_fn = collate_fn or default_collate_fn
        self.worker_init_fn = worker_init_fn
        self.return_list = return_list
        self._is_iterable = isinstance(dataset, IterableDataset)
        if self._is_iterable:
            self.batch_size = batch_size
            self.batch_sampler = None
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            if batch_size is None:
                self.batch_sampler = None
                self.batch_size = None
            else:
                self.batch_sampler = BatchSampler(
                    dataset, shuffle=shuffle, batch_size=batch_size,
                    drop_last=drop_last)

    def _fetch_batch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def __iter__(self):
        # telemetry: count delivered batches into the StatRegistry
        # (one flag check when disabled; one locked add per BATCH when
        # on — noise next to collate cost)
        from ..observability import enabled as _telemetry_on
        if not _telemetry_on():
            yield from self._iter_batches()
            return
        from ..framework.monitor import stat_add
        for batch in self._iter_batches():
            stat_add("dataloader_batches_total")
            yield batch

    def _iter_batches(self):
        if self._is_iterable:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if self.batch_size and len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        if self.num_workers and self.num_workers > 0:
            pool = None
            # a forked child of a process whose CUDA context is up cannot
            # use it (and must not try): threads from then on
            import torch
            fork_safe = not torch.cuda.is_initialized()
            if not os.environ.get("PADDLE_TPU_THREAD_WORKERS") and fork_safe:
                try:
                    # forked worker PROCESSES (reference architecture) —
                    # needed when transforms are python-heavy and hold
                    # the GIL; threads if the pool cannot start
                    pool = _ProcessWorkerPool(
                        self.dataset, iter(self.batch_sampler),
                        self.num_workers, self.collate_fn,
                        self.worker_init_fn,
                        prefetch=self.num_workers * self.prefetch_factor)
                except Exception:  # noqa: BLE001
                    pool = None
            if pool is None:
                pool = _WorkerPool(self._fetch_batch,
                                   iter(self.batch_sampler),
                                   self.num_workers,
                                   self.num_workers * self.prefetch_factor)
            try:
                yield from pool
            finally:
                pool.shutdown()
        elif self.use_buffer_reader:
            reader = _BufferedReader(
                lambda: (self._fetch_batch(ix) for ix in self.batch_sampler),
                capacity=max(self.prefetch_factor, 2))
            try:
                yield from reader
            finally:
                reader.shutdown()
        else:
            for indices in self.batch_sampler:
                yield self._fetch_batch(indices)

    def __len__(self):
        if self._is_iterable:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)


def get_worker_info():
    return None
