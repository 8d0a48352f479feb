"""Depth-completion metrics: RMSE / MAE / iRMSE / iMAE / REL / delta^1,2,3
(port of rdfc_gan_tpu/metrics/depth_metrics.py; reference
rdf_gan_metric.py:6-151): valid = (gt > t_valid) [& evaluate_mask],
t_valid = 1e-4, per-image metrics, inverse metrics on raw 1/depth, eps 1e-8.
``RDFGANMetric`` is the reference's host-side list-of-results API
(depth_metrics.py:74-120).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

METRIC_NAMES = ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"]

T_VALID = 1e-4
_EPS = 1e-8


def compute_depth_metrics(gt: torch.Tensor, pred: torch.Tensor,
                          evaluate_mask: Optional[torch.Tensor] = None,
                          t_valid: float = T_VALID) -> torch.Tensor:
    """gt, pred: (B, ...) depth in meters. Returns (B, 8) per-image rows in
    METRIC_NAMES order, masked reductions only (no data-dependent shapes)."""
    B = gt.shape[0]
    gt = gt.reshape(B, -1).float()
    pred = pred.reshape(B, -1).float()
    mask = gt > t_valid
    if evaluate_mask is not None:
        mask = mask & evaluate_mask.reshape(B, -1).bool()
    maskf = mask.float()
    num_valid = maskf.sum(dim=1)

    diff = (pred - gt) * maskf
    diff_abs = diff.abs()
    rmse = torch.sqrt((diff * diff).sum(dim=1) / (num_valid + _EPS))
    mae = diff_abs.sum(dim=1) / (num_valid + _EPS)

    zero = torch.zeros_like(gt)
    pred_inv = torch.where(mask & (pred > t_valid), 1.0 / (pred + _EPS), zero)
    gt_inv = torch.where(mask, 1.0 / (gt + _EPS), zero)
    diff_inv = (pred_inv - gt_inv) * maskf
    irmse = torch.sqrt((diff_inv * diff_inv).sum(dim=1) / (num_valid + _EPS))
    imae = diff_inv.abs().sum(dim=1) / (num_valid + _EPS)

    rel = (diff_abs / (gt + _EPS) * maskf).sum(dim=1) / (num_valid + _EPS)

    ratio = torch.maximum(gt / (pred + _EPS), pred / (gt + _EPS))
    ds = [((ratio < 1.25 ** k) & mask).float().sum(dim=1) / (num_valid + _EPS)
          for k in (1, 2, 3)]
    return torch.stack([rmse, mae, irmse, imae, rel, *ds], dim=1)


class RDFGANMetric:
    """The reference's list-of-results evaluator (rdf_gan_metric.py:6-151;
    JAX depth_metrics.py:74-120)."""

    def __init__(self, t_valid: float = T_VALID):
        self.t_valid = t_valid
        self.metric_name = list(METRIC_NAMES)

    def evaluate_batch(self, gt, pred) -> np.ndarray:
        """(1, 6) [RMSE, MAE, REL, D1, D2, D3] over the whole batch at
        once, in f64 (rdf_gan_metric.py:15-59)."""
        gt = np.asarray(gt, dtype=np.float64)
        pred = np.asarray(pred, dtype=np.float64)
        mask = gt > self.t_valid
        num_valid = mask.sum()
        p, g = pred[mask], gt[mask]
        diff = p - g
        rmse = np.sqrt((diff ** 2).sum() / (num_valid + _EPS))
        mae = np.abs(diff).sum() / (num_valid + _EPS)
        rel = (np.abs(diff) / (g + _EPS)).sum() / (num_valid + _EPS)
        ratio = np.maximum(g / (p + _EPS), p / (g + _EPS))
        dels = [(ratio < 1.25 ** k).sum() / (num_valid + _EPS)
                for k in (1, 2, 3)]
        return np.array([[rmse, mae, rel, *dels]])

    def evaluate_all(self, results: List[Dict], logger=None
                     ) -> Dict[str, float]:
        """``results``: dicts of 'gt' and 'pd' (meters) and an optional
        'evaluate_mask'. One ``compute_depth_metrics`` row a result (f32),
        then their mean, logged through ``logger`` or printed."""
        rows = []
        for result in results:
            gt = torch.from_numpy(np.asarray(result["gt"], np.float32)[None])
            pd_ = torch.from_numpy(np.asarray(result["pd"], np.float32)[None])
            em = result.get("evaluate_mask")
            if em is not None:
                em = torch.from_numpy(np.asarray(em, dtype=bool)[None])
            rows.append(compute_depth_metrics(gt, pd_, em,
                                              self.t_valid).numpy())
        metrics = np.concatenate(rows, axis=0).mean(axis=0)
        ret = {name: float(metrics[i])
               for i, name in enumerate(self.metric_name)}
        sink = logger.log if logger is not None else print
        for k, v in ret.items():
            sink(f"{k}: {v}")
        return ret
