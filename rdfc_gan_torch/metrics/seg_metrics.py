"""Segmentation helpers (port of rdfc_gan_tpu/metrics/seg_metrics.py;
reference label_net/helper.py:6-55): the poly learning rate and pixel
accuracy, mean class accuracy and mIoU over a batch, in numpy."""

from __future__ import annotations

from typing import Dict

import numpy as np


def poly_lr(base_lr: float, cur_iter: int, max_iter: int,
            power: float = 0.9) -> float:
    return base_lr * (1 - cur_iter / max_iter) ** power


def eval_semantic(pred_labels: np.ndarray, gt_labels: np.ndarray,
                  num_classes: int) -> Dict[str, float]:
    """Pixel accuracy, mean class accuracy and mIoU of the pixels whose
    label lies in [0, num_classes); the class means over the classes
    present in the ground truth."""
    pred = np.asarray(pred_labels).reshape(-1)
    gt = np.asarray(gt_labels).reshape(-1)
    valid = (gt >= 0) & (gt < num_classes)
    pred, gt = pred[valid], gt[valid]
    conf = np.bincount(gt * num_classes + pred,
                       minlength=num_classes ** 2).reshape(num_classes,
                                                           num_classes)
    tp = np.diag(conf).astype(np.float64)
    per_class_total = conf.sum(axis=1).astype(np.float64)
    per_class_pred = conf.sum(axis=0).astype(np.float64)
    pix_acc = tp.sum() / max(conf.sum(), 1)
    present = per_class_total > 0
    class_acc = np.where(present, tp / np.maximum(per_class_total, 1), 0.0)
    union = per_class_total + per_class_pred - tp
    iou = np.where(union > 0, tp / np.maximum(union, 1), 0.0)
    return dict(
        pixel_accuracy=float(pix_acc),
        mean_class_accuracy=float(class_acc[present].mean())
        if present.any() else 0.0,
        mIoU=float(iou[present].mean()) if present.any() else 0.0)
