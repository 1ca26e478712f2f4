"""Sampling, splitting, batching and prefetch of numpy samples (counterpart
of casmtr_tpu/data/loader.py): the scene split across processes, the
scene-balanced sampler, and a thread pool that loads whole batches ahead of
the consumer and yields dicts of NHWC numpy arrays (``run_eval`` and the
training command move them onto the card).  The split and the sampler make
the JAX package's ``np.random.RandomState`` draws, so their index streams
are the same."""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Sequence

import numpy as np


def get_local_split(items: Sequence, world_size: int, rank: int, seed: int):
    """The scenes of process ``rank``: the items permuted by ``seed``,
    padded to a multiple of ``world_size`` with random repeats, sliced."""
    items = list(items)
    n = len(items)
    perm = np.random.RandomState(seed).permutation(items)
    if n % world_size != 0:
        pad = np.random.RandomState(seed).choice(
            items, world_size - (n % world_size), replace=True)
        perm = np.concatenate([perm, pad])
    per = len(perm) // world_size
    return list(perm[per * rank: per * (rank + 1)])


class ConcatDataset:
    """Indexing across a list of datasets, one after the other."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.cumulative_sizes = np.cumsum([len(d) for d in datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        low = 0 if d == 0 else self.cumulative_sizes[d - 1]
        return self.datasets[d][idx - low]


class RandomConcatSampler:
    """Scene-balanced sampling: draw ``n_samples_per_subset`` indices from
    each scene per epoch (with or without replacement), optionally shuffle
    them all and repeat.  The generator carries over from epoch to epoch."""

    def __init__(self, data_source: ConcatDataset, n_samples_per_subset: int,
                 subset_replacement: bool = True, shuffle: bool = True,
                 repeat: int = 1, seed: Optional[int] = None):
        assert repeat >= 1
        self.ds = data_source
        self.n_per = n_samples_per_subset
        self.replacement = subset_replacement
        self.shuffle = shuffle
        self.repeat = repeat
        self.rng = np.random.RandomState(seed)
        self.n_samples = len(self.ds.datasets) * n_samples_per_subset * repeat

    def __len__(self):
        return self.n_samples

    def __iter__(self):
        chunks = []
        for d_idx in range(len(self.ds.datasets)):
            low = 0 if d_idx == 0 else self.ds.cumulative_sizes[d_idx - 1]
            high = self.ds.cumulative_sizes[d_idx]
            if self.replacement:
                idx = self.rng.randint(low, high, size=self.n_per)
            else:
                n_sub = high - low
                idx = self.rng.permutation(n_sub) + low
                if n_sub >= self.n_per:
                    idx = idx[:self.n_per]
                else:
                    extra = self.rng.randint(low, high,
                                             size=self.n_per - n_sub)
                    idx = np.concatenate([idx, extra])
            chunks.append(idx)
        indices = np.concatenate(chunks)
        if self.shuffle:
            indices = indices[self.rng.permutation(len(indices))]
        if self.repeat > 1:
            reps = [indices.copy() for _ in range(self.repeat - 1)]
            if self.shuffle:
                reps = [r[self.rng.permutation(len(r))] for r in reps]
            indices = np.concatenate([indices, *reps])
        return iter(indices.tolist())


_ARRAY_KEYS = ("image0", "image1", "depth0", "depth1", "T_0to1", "T_1to0",
               "K0", "K1", "scale0", "scale1", "mask0", "mask1")


def collate(samples: List[dict]) -> dict:
    """Stack the samples' arrays into a batch dict; other values (pair names
    and the like) are listed."""
    out = {}
    for k in samples[0]:
        if k in _ARRAY_KEYS:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    """Batches of ``dataset`` in the order of ``sampler`` (else 0..n-1),
    ``prefetch`` batches loaded ahead by ``num_workers`` threads."""

    def __init__(self, dataset, sampler: Optional[Iterable] = None,
                 batch_size: int = 1, num_workers: int = 4,
                 prefetch: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        # a prefetch below 1 would never prime the queue and yield nothing
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last

    def __len__(self):
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self):
        indices = (list(iter(self.sampler)) if self.sampler is not None
                   else list(range(len(self.dataset))))
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def load_batch(b):
            return collate([self.dataset[i] for i in b])

        with ThreadPoolExecutor(self.num_workers) as pool:
            futures = queue.Queue()
            it = iter(batches)
            for _ in range(self.prefetch):
                try:
                    futures.put(pool.submit(load_batch, next(it)))
                except StopIteration:
                    break
            while not futures.empty():
                f = futures.get()
                try:
                    futures.put(pool.submit(load_batch, next(it)))
                except StopIteration:
                    pass
                yield f.result()
