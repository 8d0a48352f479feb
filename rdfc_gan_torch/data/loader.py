"""Batching loader to the device (port of rdfc_gan_tpu/data/loader.py, one
process).

With ``shuffle`` the order is a permutation that is a pure function of
(seed, epoch), the JAX loader's (loader.py:129-133): ``set_epoch`` picks the
epoch, as DistributedSampler.set_epoch does. Without it batches follow the
dataset order. Each array of a sample is stacked over the batch; (H, W, C)
images become (B, C, H, W) tensors. A thread pool builds the next two
batches while the current one is used. With ``drop_last`` a short final
batch is dropped; otherwise it is padded by repeating its last row, and
``sample_idx`` marks pad rows with -1 (loader.py:161-173), so the batch
shape stays fixed and the evaluator drops them.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


class DataLoader:
    PREFETCH = 2  # batches in flight besides the one being served

    def __init__(self, dataset, batch_size: int, device="cpu",
                 num_workers: int = 4, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size} < 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.num_workers = max(int(num_workers), 1)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def indices(self) -> np.ndarray:
        """The epoch's order of dataset indices."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed * 1000003 + self.epoch).shuffle(
                idx)
        return idx

    def _rows(self, order, i):
        rows = order[i * self.batch_size:(i + 1) * self.batch_size]
        pads = self.batch_size - len(rows)
        if pads:
            rows = np.concatenate([rows, np.repeat(rows[-1:], pads)])
        return rows, pads

    def _to_device(self, samples, rows, pads) -> Dict[str, torch.Tensor]:
        batch = {}
        for k in samples[0]:
            arr = np.stack([s[k] for s in samples], axis=0)
            t = torch.from_numpy(arr)
            if t.dim() == 4:  # (B, H, W, C) -> (B, C, H, W)
                t = t.permute(0, 3, 1, 2).contiguous()
            batch[k] = t.to(self.device)
        si = rows.astype(np.int32)
        if pads:
            si[-pads:] = -1
        batch["sample_idx"] = torch.from_numpy(si)
        return batch

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        nb = len(self)
        order = self.indices()
        queue = collections.deque()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(i):
                rows, pads = self._rows(order, i)
                return [pool.submit(self.dataset.__getitem__, int(j))
                        for j in rows], rows, pads

            for i in range(min(self.PREFETCH, nb)):
                queue.append(submit(i))
            for i in range(nb):
                futures, rows, pads = queue.popleft()
                if i + self.PREFETCH < nb:
                    queue.append(submit(i + self.PREFETCH))
                yield self._to_device([f.result() for f in futures], rows,
                                      pads)
