"""Host-side batch loader with prefetch (``deepsense6g_tii_tpu/data/
loader.py``): shuffled, collated numpy batches, in the JAX package's batch
order.

Sample decoding (JPEG, PLY parse, histogram) runs on a thread pool by
default (PIL and numpy release the GIL for most of it) or, with
``use_processes``, on a pool of processes started with ``spawn``: a forked
child of a process that holds a CUDA context cannot use it, and spawn
inherits none.  Workers only ever run the dataset's numpy code; nothing
here touches torch or CUDA.  Batches come out as numpy arrays; the engine
pins them and copies them to the card (train/engine.py).
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing
from typing import Dict, Iterator

import numpy as np

_COLLATE_KEYS = ("image", "lidar", "radar", "gps", "beam", "beamidx")

_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _getitem(i: int):
    return _WORKER_DATASET[i]


def collate(samples) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k in _COLLATE_KEYS:
        if k in samples[0]:
            out[k] = np.stack([s[k] for s in samples])
    if "scenario" in samples[0]:
        out["scenario"] = np.asarray([s["scenario"] for s in samples])
    return out


class DataLoader:
    """Iterable over shuffled, collated batches.

    ``batch_size``, ``shuffle``, ``num_workers`` and ``drop_last`` as in
    torch's DataLoader.  Epoch e (counted from 1) shuffles with
    ``np.random.default_rng(seed + e)``, as the JAX loader does, so both
    packages see the same batches in the same order.  ``prefetch`` batches
    are decoded ahead.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False,
                 seed: int = 100, prefetch: int = 4,
                 use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.use_processes = use_processes   # the dataset must pickle
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self.epoch += 1
        if self.use_processes:
            pool = cf.ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context(
                    "spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
            get = _getitem
        else:
            pool = cf.ThreadPoolExecutor(self.num_workers)
            get = self.dataset.__getitem__
        with pool:
            batch_iter = self._batches()
            inflight = []
            for ids in batch_iter:
                inflight.append([pool.submit(get, int(i)) for i in ids])
                if len(inflight) >= max(1, self.prefetch):
                    break
            while inflight:
                futures = inflight.pop(0)
                ids = next(batch_iter, None)
                if ids is not None:
                    inflight.append([pool.submit(get, int(i)) for i in ids])
                yield collate([f.result() for f in futures])
