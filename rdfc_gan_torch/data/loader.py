"""Batching loader to the device (port of rdfc_gan_tpu/data/loader.py).

With ``shuffle`` the order is a permutation that is a pure function of
(seed, epoch), the JAX loader's (loader.py:129-133): ``set_epoch`` picks the
epoch, as DistributedSampler.set_epoch does. Without it batches follow the
dataset order. Each array of a sample is stacked over the batch; (H, W, C)
images become (B, C, H, W) tensors. The next two batches are built while
the current one is used. With ``drop_last`` a short final batch is dropped;
otherwise it is padded by repeating its last row, and ``sample_idx`` marks
pad rows with -1 (loader.py:161-173), so the batch shape stays fixed and
the evaluator drops them.

Workers (``worker_backend``): ``thread`` (the default) builds samples in a
thread pool, which overlaps the GIL-free parts (zlib, the PNG unfilter,
numpy) with the device step; ``process`` keeps a persistent pool of spawned
processes, each holding an unpickled copy of the dataset (the reference's
``workers_per_gpu`` DataLoader, helper.py:217-230). A process task is one
whole batch, handed the epoch with it, so the per-sample generators, keyed
by (seed, epoch, index), give both backends the same batches. Workers see
numpy only and never touch the card. ``close`` stops the pool.

Rank shards (``world`` > 1; the JAX ``per_process``, loader.py:98-127): the
epoch's global order is padded to a multiple of ``world`` by repeating its
leading indices and rank ``rank`` takes ``order[rank::world]``, so every
rank has the same number of batches (and runs the same collectives) and
the shards are disjoint but for the padding. ``batch_size`` is the rank's,
as each JAX device's is. The per-sample draws stay keyed by (seed, epoch,
index), so a rank's samples are those of a one-rank run.
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

BACKENDS = ("thread", "process")

_WORKER_DS = None
_WORKER_EPOCH = -1


def _stack(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}


def _proc_init(ds_bytes: bytes):
    import os
    import pickle

    # the workers build numpy samples only: keep them off the card
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    global _WORKER_DS
    _WORKER_DS = pickle.loads(ds_bytes)


def _proc_fetch(rows, epoch: int) -> Dict[str, np.ndarray]:
    global _WORKER_EPOCH
    if epoch != _WORKER_EPOCH and hasattr(_WORKER_DS, "set_epoch"):
        _WORKER_DS.set_epoch(epoch)
        _WORKER_EPOCH = epoch
    return _stack([_WORKER_DS[int(j)] for j in rows])


class DataLoader:
    PREFETCH = 2  # batches in flight besides the one being served

    def __init__(self, dataset, batch_size: int, device="cpu",
                 num_workers: int = 4, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 worker_backend: str = "thread", rank: int = 0,
                 world: int = 1):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size} < 1")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of world {world}")
        if worker_backend not in BACKENDS:
            raise ValueError(f"worker_backend {worker_backend!r} not in "
                             f"{BACKENDS}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.num_workers = max(int(num_workers), 1)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.worker_backend = worker_backend
        self.rank, self.world = rank, world
        self._pool = None
        # host seconds the consumer waited for each batch of the last
        # iteration (the loader's share of a step)
        self.wait_seconds = []

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        # the rank's share of the padded global order
        n = -(-len(self.dataset) // self.world)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def indices(self) -> np.ndarray:
        """The epoch's order of dataset indices (this rank's shard)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed * 1000003 + self.epoch).shuffle(
                idx)
        if self.world > 1:
            pad = -len(idx) % self.world
            idx = np.concatenate([idx, idx[:pad]])[self.rank::self.world]
        return idx

    def _rows(self, order, i):
        rows = order[i * self.batch_size:(i + 1) * self.batch_size]
        pads = self.batch_size - len(rows)
        if pads:
            rows = np.concatenate([rows, np.repeat(rows[-1:], pads)])
        return rows, pads

    def _to_device(self, arrays, rows, pads) -> Dict[str, torch.Tensor]:
        batch = {}
        for k, arr in arrays.items():
            t = torch.from_numpy(arr)
            if t.dim() == 4:  # (B, H, W, C) -> (B, C, H, W)
                t = t.permute(0, 3, 1, 2).contiguous()
            batch[k] = t.to(self.device)
        si = rows.astype(np.int32)
        if pads:
            si[-pads:] = -1
        batch["sample_idx"] = torch.from_numpy(si)
        return batch

    def _process_pool(self):
        """The persistent spawn pool, made at first use and kept across
        epochs (spawning and unpickling the dataset is the costly part)."""
        if self._pool is None:
            import multiprocessing as mp
            import pickle
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_proc_init,
                initargs=(pickle.dumps(self.dataset),))
        return self._pool

    def close(self):
        """Stop the process pool, if one was started."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):  # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        nb = len(self)
        order = self.indices()
        queue = collections.deque()
        self.wait_seconds = []
        if self.worker_backend == "process":
            pool, threads = self._process_pool(), None

            def submit(i):
                rows, pads = self._rows(order, i)
                fut = pool.submit(_proc_fetch, rows, self.epoch)
                return (lambda: fut.result()), rows, pads
        else:
            pool = threads = ThreadPoolExecutor(max_workers=self.num_workers)

            def submit(i):
                rows, pads = self._rows(order, i)
                futs = [pool.submit(self.dataset.__getitem__, int(j))
                        for j in rows]
                return (lambda: _stack([f.result() for f in futs])), rows, \
                    pads
        try:
            for i in range(min(self.PREFETCH, nb)):
                queue.append(submit(i))
            for i in range(nb):
                result, rows, pads = queue.popleft()
                if i + self.PREFETCH < nb:
                    queue.append(submit(i + self.PREFETCH))
                t0 = time.perf_counter()
                arrays = result()
                self.wait_seconds.append(time.perf_counter() - t0)
                yield self._to_device(arrays, rows, pads)
        finally:
            if threads is not None:
                threads.shutdown(wait=True, cancel_futures=True)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 0,
                     num_gpus: int = 1, dist: bool = False,
                     pin_memory: bool = True, drop_last: bool = True,
                     shuffle: bool = True, seed: int = 0, sharding=None,
                     worker_backend: str = "thread",
                     device="cpu") -> DataLoader:
    """The reference's missing ``build_dataloader`` factory with the JAX
    package's signature (rdfc_gan_tpu/data/loader.py:236-248). The batch
    is ``samples_per_gpu`` times ``num_gpus``, as there; a port process
    drives one card, so with the default ``num_gpus`` 1 ``samples_per_gpu``
    is the batch. ``dist`` takes this rank's shard of each epoch's order
    (``rank`` and ``world`` from the process group, the JAX
    ``per_process``); ``worker_backend`` is the thread or process pool of
    ``workers_per_gpu`` workers (at least one). ``pin_memory`` and
    ``sharding`` are accepted and left unused: batches go to ``device``
    whole (a port process has one card, so there is nothing to shard
    across, and the host-to-card copy is the loader's own)."""
    del pin_memory, sharding
    from ..parallel import rank, world_size

    shard = dict(rank=rank(), world=world_size()) if dist else {}
    return DataLoader(dataset, samples_per_gpu * max(int(num_gpus), 1),
                      device=device, num_workers=max(workers_per_gpu, 1),
                      shuffle=shuffle, drop_last=drop_last, seed=seed,
                      worker_backend=worker_backend, **shard)
