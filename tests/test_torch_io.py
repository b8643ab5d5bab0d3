"""``paddle_tpu_torch.io`` against ``paddle_tpu.io``.

The same numpy datasets go through both packages' ``DataLoader``: every
batch equal (values; the JAX package's integers may be int32 where the
port keeps int64), for ``batch_size`` None / n, ``drop_last``, and the
collate of tuples, dicts and lists.  ``BatchSampler`` and
``DistributedBatchSampler`` give the JAX package's indices rank by rank
(its shuffle is numpy's, seeded by the epoch).  The port's random
samplers draw from a ``torch.Generator``: their orders are held for
reproducibility under a seed, not for equality with jax's draws.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for item in x for v in _leaves(item)]
    return [x]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def _same_batches(jax_batches, port_batches):
    assert len(jax_batches) == len(port_batches)
    for jb, tb in zip(jax_batches, port_batches):
        assert type(jb) is type(tb) or (
            isinstance(jb, (tuple, list)) and isinstance(tb, (tuple, list)))
        jl, tl = _leaves(jb), _leaves(tb)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            if isinstance(b, (torch.Tensor, np.ndarray)):
                np.testing.assert_array_equal(_np(a), _np(b))
            else:
                assert a == b


class _Pairs:
    """(x float32 [3], y int64 scalar) samples."""

    def __init__(self, base, n=10):
        rs = np.random.RandomState(0)
        self.x = rs.randn(n, 3).astype(np.float32)
        self.y = rs.randint(0, 9, n).astype(np.int64)
        self.base = base

    def make(self):
        x, y = self.x, self.y

        class DS(self.base):
            def __len__(self):
                return len(x)

            def __getitem__(self, i):
                return x[i], y[i]
        return DS()


class _Dicts(_Pairs):
    def make(self):
        x, y = self.x, self.y

        class DS(self.base):
            def __len__(self):
                return len(x)

            def __getitem__(self, i):
                return {"ids": x[i], "label": int(y[i]), "tag": f"s{i}",
                        "pair": [x[i] * 2, float(i)]}
        return DS()


@pytest.mark.parametrize("kind", ["pairs", "dicts"])
@pytest.mark.parametrize("batch_size,drop_last", [
    (None, False), (1, False), (3, False), (3, True), (5, False),
    (10, True), (4, True)])
def test_dataloader_batches_match_jax(kind, batch_size, drop_last):
    src = {"pairs": _Pairs, "dicts": _Dicts}[kind]
    jds, tds = src(jio.Dataset).make(), src(tio.Dataset).make()
    jl = jio.DataLoader(jds, batch_size=batch_size, drop_last=drop_last)
    tl = tio.DataLoader(tds, batch_size=batch_size, drop_last=drop_last)
    assert len(jl) == len(tl)
    _same_batches(list(jl), list(tl))


def test_batches_are_cpu_tensors_with_numpy_dtypes():
    tds = _Pairs(tio.Dataset).make()
    x, y = next(iter(tio.DataLoader(tds, batch_size=4)))
    assert x.device.type == "cpu" and x.dtype == torch.float32
    assert y.dtype == torch.int64 and tuple(x.shape) == (4, 3)


@pytest.mark.parametrize("workers", [1, 2])
def test_prefetch_threads_give_the_same_batches(workers):
    tds = _Dicts(tio.Dataset).make()
    plain = list(tio.DataLoader(tds, batch_size=3))
    fetched = list(tio.DataLoader(tds, batch_size=3, num_workers=workers))
    _same_batches(plain, fetched)
    assert tio.get_worker_info() is None


def test_prefetch_raises_the_datasets_error():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("bad sample")
            return np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="bad sample"):
        list(tio.DataLoader(Bad(), batch_size=1, num_workers=2))


@pytest.mark.parametrize("batch_size,drop_last", [(3, False), (3, True),
                                                  (None, False)])
def test_iterable_dataset_matches_jax(batch_size, drop_last):
    def make(base):
        class It(base):
            def __iter__(self):
                for i in range(7):
                    yield np.full(2, i, np.float32), i
        return It()
    jl = jio.DataLoader(make(jio.IterableDataset), batch_size=batch_size,
                        drop_last=drop_last)
    tl = tio.DataLoader(make(tio.IterableDataset), batch_size=batch_size,
                        drop_last=drop_last)
    _same_batches(list(jl), list(tl))
    with pytest.raises(TypeError):
        len(tl)


def test_tensor_dataset_and_combinators_match_jax():
    import paddle_tpu as paddle
    rs = np.random.RandomState(2)
    a = rs.randn(6, 2).astype(np.float32)
    b = rs.randint(0, 5, 6).astype(np.int64)
    jt = jio.TensorDataset([paddle.to_tensor(a), paddle.to_tensor(b)])
    tt = tio.TensorDataset([torch.from_numpy(a), torch.from_numpy(b)])
    assert len(jt) == len(tt) == 6
    for i in range(6):
        _same_batches([jt[i]], [tt[i]])
    for jcls, tcls in ((jio.ComposeDataset, tio.ComposeDataset),
                       (jio.ConcatDataset, tio.ConcatDataset)):
        j, t = jcls([jt, jt]), tcls([tt, tt])
        assert len(j) == len(t)
        for i in (0, 3, len(t) - 1, -1):
            _same_batches([j[i]], [t[i]])
    js, ts = jio.Subset(jt, [5, 0, 3]), tio.Subset(tt, [5, 0, 3])
    _same_batches([js[i] for i in range(3)], [ts[i] for i in range(3)])
    jc = [x for x in iter(jio.ChainDataset([range(3), range(2)]))]
    tc = [x for x in iter(tio.ChainDataset([range(3), range(2)]))]
    assert jc == tc == [0, 1, 2, 0, 1]
    with pytest.raises(ValueError):
        tio.TensorDataset([torch.zeros(3), torch.zeros(4)])


@pytest.mark.parametrize("batch_size,drop_last", [(1, False), (3, False),
                                                  (3, True), (4, True)])
def test_batch_sampler_indices_match_jax(batch_size, drop_last):
    data = list(range(10))
    j = jio.BatchSampler(data, batch_size=batch_size, drop_last=drop_last)
    t = tio.BatchSampler(data, batch_size=batch_size, drop_last=drop_last)
    assert list(j) == list(t) and len(j) == len(t)
    j = jio.BatchSampler(sampler=jio.SequenceSampler(data),
                         batch_size=batch_size, drop_last=drop_last)
    t = tio.BatchSampler(sampler=tio.SequenceSampler(data),
                         batch_size=batch_size, drop_last=drop_last)
    assert list(j) == list(t)


@pytest.mark.parametrize("n,batch_size,shuffle,drop_last", [
    (10, 2, False, False), (10, 3, False, True), (11, 2, True, False),
    (13, 3, True, True), (4, 1, True, False)])
def test_distributed_batch_sampler_indices_match_jax(n, batch_size, shuffle,
                                                     drop_last):
    data = list(range(n))
    for epoch in (0, 1):
        for r in range(4):
            j = jio.DistributedBatchSampler(data, batch_size, num_replicas=4,
                                            rank=r, shuffle=shuffle,
                                            drop_last=drop_last)
            t = tio.DistributedBatchSampler(data, batch_size, num_replicas=4,
                                            rank=r, shuffle=shuffle,
                                            drop_last=drop_last)
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(j) == list(t), (epoch, r)
            assert len(j) == len(t)


def test_distributed_batch_sampler_reads_the_ports_rank(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    t = tio.DistributedBatchSampler(list(range(8)), 1)
    assert (t.nranks, t.local_rank) == (4, 2)
    assert list(t) == [[2], [6]]


def test_random_samplers_reproduce_under_a_seed():
    data = list(range(50))

    def order(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return list(tio.RandomSampler(data, generator=g, **kw))
    a, b, c = order(5), order(5), order(6)
    assert a == b and a != c and sorted(a) == data
    draws = order(5, replacement=True, num_samples=80)
    assert draws == order(5, replacement=True, num_samples=80)
    assert len(draws) == 80 and set(draws) <= set(data)
    assert len(tio.RandomSampler(data, num_samples=7)) == 7
    w = [0.0, 1.0, 0.0, 3.0]

    def weighted(seed):
        g = torch.Generator().manual_seed(seed)
        return list(tio.WeightedRandomSampler(w, 40, generator=g))
    assert weighted(1) == weighted(1)
    assert set(weighted(1)) <= {1, 3}
    no_repeat = list(tio.WeightedRandomSampler(
        [1.0, 1.0, 2.0], 3, replacement=False,
        generator=torch.Generator().manual_seed(0)))
    assert sorted(no_repeat) == [0, 1, 2]
    shuffled = tio.DataLoader(_Pairs(tio.Dataset).make(), batch_size=4,
                              shuffle=True)
    torch.manual_seed(9)
    first = [b[1].tolist() for b in shuffled]
    torch.manual_seed(9)
    assert [b[1].tolist() for b in shuffled] == first


def test_random_split_reproduces_and_partitions():
    data = list(range(20))

    def split(seed, lengths):
        g = torch.Generator().manual_seed(seed)
        return [[s[i] for i in range(len(s))]
                for s in tio.random_split(data, lengths, generator=g)]
    a = split(3, [5, 15])
    assert a == split(3, [5, 15]) and a != split(4, [5, 15])
    assert [len(x) for x in a] == [5, 15]
    assert sorted(a[0] + a[1]) == data
    frac = split(3, [0.25, 0.25, 0.5])
    assert [len(x) for x in frac] == [5, 5, 10]
    # the fractions' counts are the JAX package's
    j = jio.random_split(data, [0.3, 0.3, 0.4])
    t = tio.random_split(data, [0.3, 0.3, 0.4])
    assert [len(x) for x in j] == [len(x) for x in t]
    with pytest.raises(ValueError):
        tio.random_split(data, [3, 4])


def test_collate_and_convert_match_jax():
    samples = [(np.ones(2, np.float32) * i, i, float(i) / 2, f"t{i}")
               for i in range(3)]
    _same_batches([jio.default_collate_fn(samples)],
                  [tio.default_collate_fn(samples)])
    item = (np.arange(3), [np.ones(2), 5])
    j, t = jio.default_convert_fn(item), tio.default_convert_fn(item)
    _same_batches([j], [t])
    assert isinstance(t[0], torch.Tensor) and t[1][1] == 5
    ts = [torch.full((2,), float(i)) for i in range(3)]
    assert torch.equal(tio.default_collate_fn(ts), torch.stack(ts))
