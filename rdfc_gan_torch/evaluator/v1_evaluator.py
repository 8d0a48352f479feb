"""The v1 evaluator (port of rdfc_gan_tpu/evaluator/v1_evaluator.py;
reference RDF-GAN/lib/evaluator/rdf_gan_evaluator.py:10-150): each
prediction is resized back to its ground truth's origin size
(``gt_depth_origin``, meters) with ``cv_ops.resize(..., INTER_LINEAR)``,
OpenCV's rule, then un-normalised (x ``depth_std`` + ``depth_mean``, 5
and 5 by default as in JAX, whatever the dataset's); without an origin the
normalised ``gt_depth`` is un-normalised the same way. ``evaluate_mask``
passes through. The split is scored by the dataset's ``evaluate`` or,
where it has none, by ``RDFGANMetric``.

Pad rows (``sample_idx`` -1, the loader's fill of a short last batch) are
dropped, as the port's ``Eval`` drops them (the JAX ``EvalV1`` scores
them as repeats of the last row). Over ranks (a loader with ``world`` >
1) the results and their indices are gathered in rank order and the
shard padding's duplicates dropped, in index order, as ``Eval`` does;
every rank returns the same metrics.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..data import cv_ops
from ..metrics import RDFGANMetric
from ..parallel import all_gather_object


class EvalV1:
    def __init__(self, dataloader, depth_mean: float = 5.0,
                 depth_std: float = 5.0):
        self.dataloader = dataloader
        self.depth_mean = depth_mean
        self.depth_std = depth_std

    def inference(self, model) -> List[Dict]:
        """The split's results, one dict ('gt', 'pd' and 'evaluate_mask'
        where the batch has one) a sample, in index order."""
        results, idxs = [], []
        for data in self.dataloader:
            ret = model.forward_test(rgb=data["rgb"],
                                     raw_depth=data["raw_depth"])
            pred = ret["pred_depth"][:, 0].float().cpu().numpy()
            if "gt_depth_origin" in data:
                gts = data["gt_depth_origin"].cpu().numpy()
            else:
                gts = (data["gt_depth"][:, 0].cpu().numpy() * self.depth_std
                       + self.depth_mean)
            masks = data.get("evaluate_mask")
            if masks is not None:
                masks = masks.cpu().numpy()
            si = data["sample_idx"].numpy()
            for i in np.flatnonzero(si >= 0):
                gt = gts[i]
                h, w = gt.shape[-2:]
                pd_ = cv_ops.resize(pred[i], (w, h), cv_ops.INTER_LINEAR)
                sample = dict(gt=gt, pd=pd_ * self.depth_std
                              + self.depth_mean)
                if masks is not None:
                    sample["evaluate_mask"] = masks[i]
                results.append(sample)
                idxs.append(int(si[i]))
        if getattr(self.dataloader, "world", 1) > 1:
            parts = all_gather_object((results, idxs))
            results = [r for p in parts for r in p[0]]
            idxs = [j for p in parts for j in p[1]]
        _, first = np.unique(np.asarray(idxs, np.int64), return_index=True)
        return [results[j] for j in first]

    def evaluate(self, model, logger=None) -> Dict[str, float]:
        results = self.inference(model)
        dataset = getattr(self.dataloader, "dataset", None)
        if dataset is not None and hasattr(dataset, "evaluate"):
            return dataset.evaluate(results, logger)
        return RDFGANMetric().evaluate_all(results, logger)
