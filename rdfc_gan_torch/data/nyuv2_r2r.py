"""NYUv2 raw->reconstructed dataset, v1 R2R (port of
rdfc_gan_tpu/data/nyuv2_r2r.py: frames through the port's HDF5 reader,
resampling through ``cv_ops``).

Parity target: RDF-GAN/lib/dataset/nyuv2/nyuv2_raw_to_reconstructed_dataset.py
— h5 frames (nyu.json split like S2D), CutOffBlackBorder (45/15/45/40),
train-time pseudo corruption of the dense depth (highlight, spatter, blacks,
each p=0.5, in that order) as the network input, hflip + ±5° nearest
rotation, resize (256,320), zero-preserving raw normalization; the test
split is ``val``, with the uncorrupted depth as input and target.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from . import cv_ops
from .base import BaseDataset
from .nyuv2 import _rotate_nearest
from .nyuv2_s2d import load_h5_frame
from .pseudo_hole import MaskBlacks, SegmentationHighLight, Spatter

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class NYUV2R2RDataset(BaseDataset):
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=_IMAGENET_MEAN, rgb_std=_IMAGENET_STD,
                 max_depth: float = 10.0, depth_mean=(5.0,), depth_std=(5.0,),
                 seed: int = 0, **unused):
        super().__init__(data_root, mode, rgb_mean, rgb_std, max_depth,
                         depth_mean, depth_std, seed)
        with open(os.path.join(data_root, "nyu.json")) as f:
            self.sample_list = json.load(f)[mode if mode != "test" else "val"]
        self.crop_size = (256, 320)

    def __len__(self):
        return len(self.sample_list)

    def _load(self, idx):
        rgb, depth = load_h5_frame(os.path.join(
            self.data_root, self.sample_list[idx]["filename"]))
        # CutOffBlackBorder
        return rgb[45:-15, 45:-40], depth[45:-15, 45:-40]

    def _pack(self, rgb, depth, pseudo):
        sz = (self.crop_size[1], self.crop_size[0])
        rgb = cv_ops.resize(rgb.astype(np.float32) / 255.0, sz)
        depth = cv_ops.resize(depth, sz, interpolation=cv_ops.INTER_NEAREST)
        pseudo = cv_ops.resize(pseudo, sz, interpolation=cv_ops.INTER_NEAREST)
        rgb = (rgb - self.rgb_mean) / self.rgb_std
        valid = (depth > 1e-4).astype(np.float32)[..., None]
        gt = (depth - self.depth_mean) / self.depth_std
        hole = pseudo == 0.0
        raw = (pseudo - self.depth_mean) / self.depth_std
        raw[hole] = 0.0
        return dict(rgb=rgb.astype(np.float32),
                    raw_depth=raw.astype(np.float32)[..., None],
                    gt_depth=gt.astype(np.float32)[..., None],
                    depth_masks=valid)

    def get_train_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb, depth = self._load(idx)
        except Exception:
            return None
        rng = self._rng(idx)
        probe = dict(rgb=rgb.astype(np.float32), raw_depth=depth)
        mask = np.zeros(depth.shape[:2], bool)
        if rng.uniform() > 0.5:
            mask |= SegmentationHighLight()(probe)
        if rng.uniform() > 0.5:
            mask |= Spatter()(probe, rng)
        if rng.uniform() > 0.5:
            mask |= MaskBlacks()(probe)
        pseudo = np.where(mask, 0.0, depth)

        if rng.uniform() > 0.5:
            rgb, depth, pseudo = rgb[:, ::-1], depth[:, ::-1], pseudo[:, ::-1]
        deg = float(rng.uniform(-5.0, 5.0))

        def rot(img):
            return _rotate_nearest(img.astype(np.float32), deg)

        return self._pack(rot(rgb), rot(depth), rot(pseudo))

    def get_test_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb, depth = self._load(idx)
        except Exception:
            return None
        # the raw (uncorrupted) depth is the input and the target
        return self._pack(rgb, depth, depth)


DATASETS.register("nyuv2_r2r")(NYUV2R2RDataset)
