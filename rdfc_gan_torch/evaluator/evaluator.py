"""Evaluator: no-grad inference over a loader and metric aggregation (port
of rdfc_gan_tpu/evaluator/evaluator.py; reference evaluator.py:12-98): per
batch run ``forward_test``, un-normalize prediction and ground truth by the
dataset's depth std/mean (x5+5 on NYUv2), compute per-image metrics on the
device, drop pad rows, and average over the split.

Over ranks (a loader with ``world`` > 1 holds this rank's shard) the rows
and their ``sample_idx`` are gathered in rank order (``all_gather_object``,
the JAX ``process_allgather``) and, as in JAX (evaluator.py:80-88), the
shard padding's duplicates are dropped by ``np.unique`` on the indices,
which also puts the rows in index order; every rank returns the same
metrics. With a grid whose ``model`` axis shards the width, every batch's
predictions are assembled in the row first, so the ranks of a row hold
the same rows, which the dedupe drops as it drops the padding's."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..metrics import METRIC_NAMES, compute_depth_metrics
from ..parallel import all_gather_object


class Eval:
    def __init__(self, dataloader, depth_only: bool = False, grid=None):
        self.dataloader = dataloader
        self.depth_only = depth_only
        # a grid with a model axis: each batch served width-sharded and
        # assembled in the row before the metrics (``parallel.spatial``)
        self.sharded = ({} if grid is None or grid.M == 1 else
                        dict(grid=grid, assemble=True))
        ds = dataloader.dataset
        self.depth_mean = float(getattr(ds, "depth_mean", 5.0))
        self.depth_std = float(getattr(ds, "depth_std", 5.0))
        # host seconds per batch, from the forward call until its metric
        # rows are on the host (which waits for the device)
        self.batch_seconds: List[float] = []

    def inference(self, model):
        """Returns (per-image metric rows (N, 8), sample indices (N,)) of
        the whole split (gathered over the ranks of a sharded loader); pad
        rows (sample_idx == -1) are dropped."""
        rows, idxs = [], []
        self.batch_seconds = []
        for data in self.dataloader:
            t0 = time.perf_counter()
            ret = model.forward_test(rgb=data["rgb"],
                                     raw_depth=data["raw_depth"],
                                     depth_only=self.depth_only,
                                     **self.sharded)
            pd_ = ret["pred_depth"][:, 0] * self.depth_std + self.depth_mean
            gt = data["gt_depth"][:, 0] * self.depth_std + self.depth_mean
            r = compute_depth_metrics(gt, pd_,
                                      data.get("evaluate_mask")).cpu().numpy()
            self.batch_seconds.append(time.perf_counter() - t0)
            si = data["sample_idx"].numpy()
            keep = si >= 0
            rows.append(r[keep])
            idxs.append(si[keep])
        rows, idxs = np.concatenate(rows, axis=0), np.concatenate(idxs)
        if getattr(self.dataloader, "world", 1) > 1:
            parts = all_gather_object((rows, idxs))
            rows = np.concatenate([p[0] for p in parts], axis=0)
            idxs = np.concatenate([p[1] for p in parts])
        return rows, idxs

    def evaluate(self, model, logger=None) -> Dict[str, float]:
        rows, idx = self.inference(model)
        # one row an image: the shard padding's duplicates go
        _, first = np.unique(idx, return_index=True)
        metrics = rows[first].mean(axis=0)
        ret = {name: float(metrics[i]) for i, name in enumerate(METRIC_NAMES)}
        sink = logger.log if logger is not None else print
        for k, v in ret.items():
            sink(f"{k}: {v}")
        return ret
