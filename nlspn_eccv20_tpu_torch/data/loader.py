"""Threaded host-side batch loader (counterpart of
``nlspn_eccv20_tpu/data/loader.py``: the same order, shards and seeds).

A thread pool decodes and augments the samples of a batch (PIL and numpy
release the interpreter lock for their heavy parts), a producer thread
stacks them into NHWC numpy batches and a bounded queue hands them on.

Determinism: the shuffle order is a permutation seeded by (seed, epoch);
each sample gets its own ``np.random.Generator`` seeded by (seed, epoch,
index), so samples are the same under resume, under sharding and whatever
order the threads finish in. With ``num_shards`` ranks the epoch's order is
padded to a multiple of the rank count and each rank takes every
``num_shards``-th sample from ``shard_index`` (DistributedSampler's rule).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from nlspn_eccv20_tpu_torch.data import BaseDataset


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples], axis=0).astype(np.float32)
            for k in samples[0]}


class DataLoader:
    """Iterates the seeded, sharded, prefetched batches of one epoch;
    ``batch_size`` is the per-shard batch."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 num_threads: int = 4, shard_index: int = 0,
                 num_shards: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed * 100_003 + self.epoch)).permutation(n)
        if self.num_shards > 1:
            pad = (-len(order)) % self.num_shards
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.shard_index::self.num_shards]
        return order

    def position(self, row: int) -> int:
        """Where the shard's ``row``-th sample (over the epoch's batches)
        stands in the epoch's order; positions from ``len(dataset)`` on are
        the padding that evens out the shards (each repeats a sample)."""
        return self.shard_index + row * max(self.num_shards, 1)

    def __len__(self):
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_indices()
        nb = len(self)
        if nb == 0:
            return
        takes_rng = isinstance(self.dataset, BaseDataset)

        def load_one(pos: int):
            idx = int(order[pos])
            if not takes_rng:
                return self.dataset[idx]
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, idx]))
            return self.dataset.__getitem__(idx, rng)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def put_or_stop(item) -> bool:
            # a bounded put that gives up once the consumer has left, so an
            # abandoned iterator does not keep its threads until exit
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        lo = b * self.batch_size
                        hi = min(lo + self.batch_size, len(order))
                        samples = list(pool.map(load_one, range(lo, hi)))
                        if not put_or_stop(_collate(samples)):
                            return
            except Exception as e:  # handed to the consumer, raised there
                failure.append(e)
            put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()
            # unblock a producer parked in put, then wait for it to exit
            while t.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
