"""Threaded prefetching batch loader (counterpart of
ppmstereo_tpu/data/loader.py): dataset work is numpy, which releases the
GIL, so a thread pool in the training process replaces worker processes.
Each epoch reshuffles with a seeded generator, and each sample is augmented
with a generator of its own, seeded from (seed, epoch, index): the batches
of one seed are the same however the threads interleave.

Batches are channels-last numpy dicts: left/right (B, T, H, W, 3) float32,
disparity (B, T, H, W, 1), valid (B, T, H, W).

Over a data axis of n ranks each rank loads only its block of every global
batch (`parallel/sharding.py::local_slice`), B / n clips. The shuffle and
the samples' generators depend on the seed, the epoch and the index alone,
so every rank knows the global order, and the ranks' blocks put together
are the batch one process loads.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ppmstereo_tpu_torch.parallel.sharding import local_slice


def collate(samples: list[dict]) -> dict:
    batch = {
        "left": np.stack([s["img"][:, 0] for s in samples]),
        "right": np.stack([s["img"][:, 1] for s in samples]),
    }
    if "disp" in samples[0]:
        batch["disparity"] = np.stack([s["disp"][:, 0] for s in samples])
        batch["valid"] = np.stack([s["valid"][:, 0] for s in samples])
    return batch


class PrefetchLoader:
    """Shuffled full batches (a short last batch is dropped), two batches
    prefetched by `num_workers` threads. `batch_size` is the global batch;
    rank `data_rank` of a data axis of `data_size` gets its block of it."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size: int = 2, num_workers: int = 4, seed: int = 0,
                 data_rank: int = 0, data_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        self.mine = local_slice(batch_size, data_rank, data_size)

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        self.rng.shuffle(order)
        batches = [order[i: i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        batches = [b[self.mine] for b in batches if len(b) == self.batch_size]
        epoch, self.epoch = self.epoch, self.epoch + 1

        def sample(index):
            rng = np.random.default_rng((self.seed, epoch, int(index)))
            return self.dataset.__getitem__(index, rng)

        q: queue.Queue = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        failure: list[BaseException] = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(sample, idxs))))
            except BaseException as exc:  # handed to the consumer below
                failure.append(exc)
            q.put(None)

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()
            while worker.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)
