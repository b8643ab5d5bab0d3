"""``paddle.io`` of the port; counterpart of ``paddle_tpu/io/__init__.py``
(ref: ``python/paddle/io/`` — ``dataset.py``, ``dataloader/``).

Datasets, samplers, collation and ``DataLoader`` with the reference's
parameters in its order.  Batches are ``torch`` tensors on the CPU; the
training step moves them to the model's device
(``jit.TrainStep._to_device``).

* Shuffled orders (``RandomSampler``, ``WeightedRandomSampler``,
  ``random_split``) draw from an explicit ``torch.Generator``
  (``generator=``; ``None``: torch's global generator, which
  ``paddle_tpu_torch.seed`` seeds).  They are reproducible under a
  seeded generator, not equal to the JAX package's draws (its samplers
  draw with jax keys).  ``DistributedBatchSampler`` shuffles with
  ``np.random.RandomState(epoch)`` as the JAX package does, so its
  indices equal the reference's.
* ``num_workers > 0`` runs the JAX package's thread prefetcher (a
  producer thread fills a queue of ``prefetch_factor * num_workers``
  batches) for every dataset kind.  The JAX package's multiprocess
  worker pool (map-style datasets with ``use_shared_memory``) is not
  ported: those loaders take the thread prefetcher too, with the same
  batches in the same order, and ``get_worker_info()`` is ``None``.
"""
from __future__ import annotations

import bisect
import itertools
import queue as _queue
import threading
from typing import Sequence

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "default_collate_fn",
           "default_convert_fn", "DataLoader", "WorkerInfo",
           "get_worker_info"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence[torch.Tensor]):
        lens = {t.shape[0] for t in tensors}
        if len(lens) != 1:
            raise ValueError("all tensors must share dim 0")
        self.tensors = list(tensors)

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
            out.extend(item if isinstance(item, (tuple, list)) else [item])
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
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[ds - 1] if ds else 0)
        return self.datasets[ds][off]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of ``dataset`` of ``lengths`` (counts, or fractions summing
    to 1) over a permutation drawn from ``generator`` (a
    ``torch.Generator``)."""
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(n, float) and 0 <= n <= 1 for n in lengths):
        counts = [int(np.floor(total * n)) for n in lengths]
        for i in range(total - sum(counts)):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset size")
    perm = torch.randperm(total, generator=generator).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
    return out


# ---------------------------------------------------------------------------
# samplers (ref: io/dataloader/sampler.py, batch_sampler.py)
# ---------------------------------------------------------------------------

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
    """A permutation (or, with ``replacement``, uniform draws) from
    ``generator``, a ``torch.Generator``."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,),
                                generator=self.generator)
        else:
            idx = torch.randperm(n, generator=self.generator)[
                :self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    """``num_samples`` indices drawn with probabilities proportional to
    ``weights``; the trailing keyword ``generator`` is a
    ``torch.Generator``."""

    def __init__(self, weights, num_samples, replacement=True, *,
                 generator=None):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        p = torch.from_numpy(self.weights / self.weights.sum())
        idx = torch.multinomial(p, self.num_samples, self.replacement,
                                generator=self.generator)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

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
    """ref: ``io/dataloader/batch_sampler.py`` DistributedBatchSampler:
    the index space padded to a multiple of the ranks, each rank taking
    its strided share; ``num_replicas`` and ``rank`` default to the
    port's world size and rank (``distributed.env``)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        from ..distributed.env import get_rank, get_world_size
        self.nranks = num_replicas if num_replicas is not None \
            else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        # pad to make divisible, then take this rank's strided shard
        indices += indices[: self.total_size - n]
        indices = indices[self.local_rank::self.nranks]
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


# ---------------------------------------------------------------------------
# collate + DataLoader
# ---------------------------------------------------------------------------

def _collate_tree(batch, stack):
    """One traversal of a sample's structure; ``stack`` combines the
    leaves."""
    sample = batch[0]
    if isinstance(sample, (torch.Tensor, np.ndarray, int, float,
                           np.integer, np.floating)):
        return stack(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _collate_tree([b[k] for b in batch], stack)
                for k in sample}
    if isinstance(sample, (tuple, list)):
        return type(sample)(_collate_tree(list(items), stack)
                            for items in zip(*batch))
    return list(batch)


def default_collate_fn(batch):
    """The samples' leaves stacked into CPU tensors along a new first
    dimension (tensors with ``torch.stack``, arrays and numbers through
    numpy), tuples, lists and dicts kept, strings listed."""
    def stack(b):
        s = b[0]
        if isinstance(s, torch.Tensor):
            return torch.stack(b)
        if isinstance(s, np.ndarray):
            return torch.from_numpy(np.stack(b))
        return torch.from_numpy(np.asarray(b))
    return _collate_tree(batch, stack)


def default_convert_fn(batch):
    """A sample of a loader without batching: arrays to tensors, tuples
    and lists kept."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, (tuple, list)):
        return type(batch)(default_convert_fn(b) for b in batch)
    return batch


class DataLoader:
    """ref: ``io/dataloader/dataloader_iter.py``, the reference's
    parameters in its order.  ``batch_size=None`` yields the dataset's
    samples one by one (``default_convert_fn``); ``num_workers > 0``
    prefetches on a thread (module docstring).  ``feed_list``,
    ``places``, ``use_buffer_reader``, ``use_shared_memory``,
    ``worker_init_fn`` and ``persistent_workers`` change nothing here
    (the JAX package reads the last three in its worker pool only)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _gen(self):
        if self._iterable_mode:
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
                yield default_convert_fn(self.dataset[i])
            return
        for idxs in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers <= 0:
            yield from self._gen()
            return
        # thread prefetcher: decode/collate overlaps device compute
        q: _queue.Queue = _queue.Queue(
            maxsize=self.prefetch_factor * self.num_workers)
        end, err = object(), object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in self._gen():
                    if not put(item):
                        return  # the consumer abandoned the iterator
                put(end)
            except BaseException as e:  # the dataset's errors propagate
                put((err, e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        wait = self.timeout if self.timeout and self.timeout > 0 else None
        try:
            while True:
                try:
                    item = q.get(timeout=wait)
                except _queue.Empty:
                    raise RuntimeError(f"DataLoader batch timed out after "
                                       f"{self.timeout}s") from None
                if item is end:
                    break
                if isinstance(item, tuple) and len(item) == 2 and \
                        item[0] is err:
                    raise item[1]
                yield item
        finally:
            stop.set()
            t.join()


class WorkerInfo:
    """ref: ``io/dataloader/worker.py`` WorkerInfo."""

    def __init__(self, id: int, num_workers: int, seed: int, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


def get_worker_info():
    """ref: ``paddle.io.get_worker_info``: ``None`` outside a worker
    process; the port's prefetcher is a thread of the main process, so
    always ``None``."""
    return None
