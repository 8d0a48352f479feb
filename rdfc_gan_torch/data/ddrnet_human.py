"""DDRNet human-body depth dataset, v1 (port of
rdfc_gan_tpu/data/ddrnet_human.py: PNGs through ``image_io``, resampling
through ``cv_ops``).

Parity target: RDF-GAN/lib/dataset/ddrnet_human/ddrnet_human_dataset.py:
17-252 — csv index ({mode}.csv rows rgb,raw,gt,mask; written by
``tools/create_ddrnet_csv.py``), depth /1000 (f64) with max_depth 3.0
(mean/std 1.5), human-mask gating of rgb+raw, pseudo-hole corruption of gt
as input (highlight/blacks/spatter each p=0.5), ±5° nearest rotation, hflip,
RandomRescale 1.0-1.4 to round(640 s), center-crop 480x640, zero-preserving
raw-depth normalization, epoch multiplier ``times`` (x20 in the shipped
config); test samples carry ``evaluate_mask`` (the human mask), which the
evaluator ANDs into its valid pixels.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from . import cv_ops, image_io
from .base import BaseDataset
from .nyuv2 import _rotate_nearest
from .pseudo_hole import MaskBlacks, SegmentationHighLight, Spatter

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class DDRNetHumanDataset(BaseDataset):
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=_IMAGENET_MEAN, rgb_std=_IMAGENET_STD,
                 max_depth: float = 3.0, depth_mean=(1.5,), depth_std=(1.5,),
                 times: int = 1, seed: int = 0, **unused):
        super().__init__(data_root, mode, rgb_mean, rgb_std, max_depth,
                         depth_mean, depth_std, seed)
        self.crop_size = (480, 640)
        self.rgb, self.raw_depth, self.gt_depth, self.mask = self.load_file()
        self._origin_len = len(self.rgb)
        self.times = times if mode == "train" else 1

    def load_file(self):
        csvfile = os.path.join(self.data_root, f"{self.mode}.csv")
        if not os.path.exists(csvfile):
            raise FileNotFoundError(csvfile)
        cols = ([], [], [], [])
        with open(csvfile) as f:
            for row in csv.reader(f):
                for c, v in zip(cols, row):
                    c.append(v)
        return cols

    def __len__(self):
        return self.times * self._origin_len

    def _load(self, idx):
        rgb = image_io.bgr2rgb(image_io.imread(self.rgb[idx]))
        raw = image_io.imread(self.raw_depth[idx])
        gt = image_io.imread(self.gt_depth[idx])
        hm = image_io.imread(self.mask[idx])
        return rgb, raw / 1000.0, gt / 1000.0, hm

    def get_train_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        idx = idx % self._origin_len
        try:
            rgb, raw, gt, hm = self._load(idx)
        except Exception:
            return None
        rng = self._rng(idx)
        valid = hm > 0.0
        rgb = np.where(valid[..., None], rgb, 0)
        raw = np.where(valid, raw, 0.0)

        # pseudo corruption of gt as the network input
        probe = dict(rgb=rgb.astype(np.float32), raw_depth=gt)
        pseudo = np.zeros(gt.shape[:2], bool)
        if rng.uniform() > 0.5:
            pseudo |= SegmentationHighLight()(probe)
        if rng.uniform() > 0.5:
            pseudo |= MaskBlacks()(probe)
        if rng.uniform() > 0.5:
            pseudo |= Spatter()(probe, rng)
        pseudo_depth = np.where(pseudo, 0.0, gt)

        # rotate ±5°, hflip
        deg = float(rng.uniform(-5.0, 5.0))

        def rot(img):
            return _rotate_nearest(img.astype(np.float32), deg)

        rgb, gt, pseudo_depth, hm = (rot(rgb), rot(gt), rot(pseudo_depth),
                                     rot(hm))
        if rng.uniform() > 0.5:
            rgb, gt = rgb[:, ::-1], gt[:, ::-1]
            pseudo_depth, hm = pseudo_depth[:, ::-1], hm[:, ::-1]

        # RandomRescale [1.0, 1.4] + center crop (480, 640)
        s = float(rng.uniform(1.0, 1.4))
        sz = (int(round(rgb.shape[1] * s)), int(round(rgb.shape[0] * s)))
        nearest = cv_ops.INTER_NEAREST
        rgb = cv_ops.resize(rgb, sz)
        gt = cv_ops.resize(gt, sz, interpolation=nearest)
        pseudo_depth = cv_ops.resize(pseudo_depth, sz, interpolation=nearest)
        hm = cv_ops.resize(hm, sz, interpolation=nearest)
        ch, cw = self.crop_size
        y = max((rgb.shape[0] - ch) // 2, 0)
        x = max((rgb.shape[1] - cw) // 2, 0)
        rgb, gt = rgb[y:y + ch, x:x + cw], gt[y:y + ch, x:x + cw]
        pseudo_depth = pseudo_depth[y:y + ch, x:x + cw]
        hm = hm[y:y + ch, x:x + cw]

        rgb = (rgb / 255.0 - self.rgb_mean) / self.rgb_std
        valid_mask = ((gt > 1e-4) & (hm > 0.0)).astype(np.float32)
        hole = pseudo_depth == 0.0
        raw_n = (pseudo_depth - self.depth_mean) / self.depth_std
        raw_n[hole] = 0.0
        gt_n = (gt - self.depth_mean) / self.depth_std
        return dict(rgb=rgb.astype(np.float32),
                    raw_depth=raw_n.astype(np.float32)[..., None],
                    gt_depth=gt_n.astype(np.float32)[..., None],
                    depth_masks=valid_mask[..., None],
                    human_mask=hm.astype(np.float32)[..., None])

    def get_test_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        idx = idx % self._origin_len
        try:
            rgb, raw, gt, hm = self._load(idx)
        except Exception:
            return None
        valid = hm > 0.0
        rgb = np.where(valid[..., None], rgb, 0)
        raw = np.where(valid, raw, 0.0)
        ch, cw = self.crop_size
        nearest = cv_ops.INTER_NEAREST
        rgb = cv_ops.resize(rgb.astype(np.float32), (cw, ch))
        raw = cv_ops.resize(raw, (cw, ch), interpolation=nearest)
        gt = cv_ops.resize(gt, (cw, ch), interpolation=nearest)
        hm = cv_ops.resize(hm.astype(np.float32), (cw, ch),
                           interpolation=nearest)
        rgb = (rgb / 255.0 - self.rgb_mean) / self.rgb_std
        valid_mask = ((gt > 1e-4) & (hm > 0.0)).astype(np.float32)
        hole = raw == 0.0
        raw_n = (raw - self.depth_mean) / self.depth_std
        raw_n[hole] = 0.0
        gt_n = (gt - self.depth_mean) / self.depth_std
        return dict(rgb=rgb.astype(np.float32),
                    raw_depth=raw_n.astype(np.float32)[..., None],
                    gt_depth=gt_n.astype(np.float32)[..., None],
                    depth_masks=valid_mask[..., None],
                    evaluate_mask=(hm > 0.0)[..., None])


DATASETS.register("ddrnet_human")(DDRNetHumanDataset)
