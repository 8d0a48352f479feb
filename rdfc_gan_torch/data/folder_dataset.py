"""Generic folder-based depth-completion dataset: the ``cleargrasp`` and
``thuman`` loaders (port of rdfc_gan_tpu/data/folder_dataset.py: PNGs
through ``image_io``, resampling through ``cv_ops``, the ellipse dropout
through ``utils/data_augmentation``), for the layout

    root/{train,val,test}/rgb/*.png        8-bit RGB
    root/{train,val,test}/depth/*.png      gt depth (mm png)
    root/{train,val,test}/depth_raw/*.png  raw input depth (optional;
                                           synthesized from gt by ellipse
                                           dropout when absent)

The JAX loader also takes ``.exr`` depth (meters, through OpenCV); the
port refuses a split holding any with ``ValueError``, naming the file
(``data_augmentation.exr_loader``). Normalization follows the framework
convention (ImageNet rgb, (5,5) depth, zero-preserved holes).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from ..utils.data_augmentation import ellipse_dropout, exr_loader
from . import cv_ops, image_io
from .base import BaseDataset

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _imread_color(path: str) -> np.ndarray:
    """``cv2.imread(path)`` (IMREAD_COLOR) of an 8-bit PNG: BGR, gray
    repeated to three channels, alpha dropped."""
    img = image_io.imread(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: {img.dtype} colour; the port reads 8-bit "
                         f"RGB PNGs")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


class FolderDepthDataset(BaseDataset):
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=_IMAGENET_MEAN, rgb_std=_IMAGENET_STD,
                 max_depth: float = 10.0, depth_mean=(5.0,), depth_std=(5.0,),
                 height: int = 256, width: int = 256, seed: int = 0,
                 **unused):
        super().__init__(data_root, mode, rgb_mean, rgb_std, max_depth,
                         depth_mean, depth_std, seed)
        split = "train" if mode == "train" else "test" \
            if mode == "test" and os.path.isdir(
                os.path.join(data_root, "test")) else "val"
        base = os.path.join(data_root, split)
        self.rgb_files = sorted(glob.glob(os.path.join(base, "rgb", "*")))
        self.depth_files = sorted(glob.glob(os.path.join(base, "depth", "*")))
        raw = sorted(glob.glob(os.path.join(base, "depth_raw", "*")))
        self.raw_files = raw if len(raw) == len(self.rgb_files) else None
        assert len(self.rgb_files) == len(self.depth_files), (
            f"rgb/depth count mismatch under {base}")
        for p in self.depth_files + (self.raw_files or []):
            if p.endswith(".exr"):
                exr_loader(p)  # raises
        self.size = (height, width)

    def __len__(self):
        return len(self.rgb_files)

    @staticmethod
    def _load_depth(path: str) -> np.ndarray:
        """mm PNG -> meters."""
        return image_io.imread(path).astype(np.float32) / 1000.0

    def _get(self, idx: int, train: bool) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb = image_io.bgr2rgb(_imread_color(self.rgb_files[idx]))
            gt = self._load_depth(self.depth_files[idx])
            raw = (self._load_depth(self.raw_files[idx])
                   if self.raw_files else None)
        except Exception:
            return None
        rng = self._rng(idx)
        if raw is None:
            raw = ellipse_dropout(gt, rng) if train else gt.copy()

        h, w = self.size
        nearest = cv_ops.INTER_NEAREST
        rgb = cv_ops.resize(rgb.astype(np.float32) / 255.0, (w, h))
        gt = cv_ops.resize(gt, (w, h), interpolation=nearest)
        raw = cv_ops.resize(raw, (w, h), interpolation=nearest)
        if train and rng.uniform() > 0.5:
            rgb, gt, raw = rgb[:, ::-1], gt[:, ::-1], raw[:, ::-1]

        rgb = (rgb - self.rgb_mean) / self.rgb_std
        valid = (gt > 1e-4).astype(np.float32)[..., None]
        hole = raw <= 1e-8
        raw_n = (raw - self.depth_mean) / self.depth_std
        raw_n[hole] = 0.0
        gt_n = (gt - self.depth_mean) / self.depth_std
        return dict(rgb=np.ascontiguousarray(rgb, np.float32),
                    raw_depth=np.ascontiguousarray(raw_n,
                                                   np.float32)[..., None],
                    gt_depth=np.ascontiguousarray(gt_n, np.float32)[..., None],
                    depth_masks=valid)

    def get_train_data(self, idx):
        return self._get(idx, True)

    def get_test_data(self, idx):
        return self._get(idx, False)


DATASETS.register("cleargrasp")(FolderDepthDataset)
DATASETS.register("thuman")(FolderDepthDataset)
