"""NYUv2-1400 file-based dataset (v2 default training data; port of
rdfc_gan_tpu/data/nyuv2.py: PNGs through ``image_io``, resampling through
``cv_ops``, which match OpenCV's).

Parity target: lib/datasets/nyuv2/nyuv2_dataset_training.py:17-346.
Pipeline (train): load pngs from {train,test}.txt lists (rgb / depth_raw /
depth / norm_v2 / labels_13), depth /1000, CutOffBlackBorder(45,15,45,40),
±5° nearest rotation, resize shorter-side->240, center-crop (224,304);
rgb & normal ToTensor-scaled then ImageNet-normalized; depth (5,5)-normalized
(holes become -1 on this path — no zero preservation here, matching the
shipped code, not the commented sparse variant); masks: gt_depth>1e-4,
normal any-channel>0 (computed pre-normalization).

Variants ported as modes of this class + siblings:
  * sample_from_raw: (256,256) resize + 500-pt sparsification
  * pseudo: raw depth as gt, stochastic corruption masks
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..registry import DATASETS
from . import cv_ops, image_io
from .base import BaseDataset
from .pseudo_hole import MaskBlacks, SegmentationHighLight, Spatter

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _resize_shorter(img: np.ndarray, target: int, nearest: bool) -> np.ndarray:
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = target, int(round(w * target / h))
    else:
        nh, nw = int(round(h * target / w)), target
    interp = cv_ops.INTER_NEAREST if nearest else cv_ops.INTER_LINEAR
    return cv_ops.resize(img, (nw, nh), interpolation=interp)


def _center_crop(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    y = max((h - hw[0]) // 2, 0)
    x = max((w - hw[1]) // 2, 0)
    return img[y:y + hw[0], x:x + hw[1]]


def _rotate_nearest(img: np.ndarray, deg: float) -> np.ndarray:
    m = cv_ops.rotation_matrix((img.shape[1] / 2, img.shape[0] / 2), deg,
                               1.0)
    return cv_ops.warp_affine(img, m, (img.shape[1], img.shape[0]),
                              flags=cv_ops.INTER_NEAREST)


class NYUV21400Dataset(BaseDataset):
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=_IMAGENET_MEAN, rgb_std=_IMAGENET_STD,
                 max_depth: float = 10.0, depth_mean=(5.0,), depth_std=(5.0,),
                 height: int = 240, width: int = 320,
                 crop_size_height: int = 224, crop_size_width: int = 304,
                 num_sample: int = 500, seed: int = 0,
                 decode_cache: Optional[str] = None, **unused):
        super().__init__(data_root, mode, rgb_mean, rgb_std, max_depth,
                         depth_mean, depth_std, seed,
                         decode_cache=decode_cache)
        self.height = height
        self.width = width
        self.crop_size = (crop_size_height, crop_size_width)
        self.num_sample = num_sample
        (self.rgb, self.raw_depth, self.gt_depth, self.gt_normal,
         self.labels) = self.load_file()

    # ------------------------------------------------------------------- io
    def load_file(self):
        prefix = "train" if self.mode == "train" else "test"
        with open(os.path.join(self.data_root, f"{prefix}.txt")) as f:
            indices = f.read().splitlines()
        return (
            [f"{prefix}/rgb/{i}.png" for i in indices],
            [f"{prefix}/depth_raw/{i}.png" for i in indices],
            [f"{prefix}/depth/{i}.png" for i in indices],
            [f"{prefix}/norm_v2/{i}.png" for i in indices],
            [f"{prefix}/labels_13/{i}.png" for i in indices],
        )

    def _load_raw(self, idx: int):
        cached = self._cache_load(self.rgb[idx])
        if cached is not None:
            return cached
        read = self._read
        rgb = image_io.bgr2rgb(read(self.rgb[idx]))
        normal = image_io.bgr2rgb(read(self.gt_normal[idx]))
        raw_depth = read(self.raw_depth[idx]).astype(np.float32) / 1000.0
        gt_depth = read(self.gt_depth[idx]).astype(np.float32) / 1000.0
        labels = read(self.labels[idx])
        s = dict(rgb=rgb, gt_normal=normal, raw_depth=raw_depth,
                 gt_depth=gt_depth, labels=labels)
        # CutOffBlackBorder(45,15,45,40) — nyuv2_dataset_training.py:77-82
        for k, v in s.items():
            s[k] = v[45: v.shape[0] - 15, 45: v.shape[1] - 40]
        self._cache_store(self.rgb[idx], s)
        return s

    # ------------------------------------------------------------- pipeline
    def _finalize(self, rgb, normal, raw_depth, gt_depth, labels):
        """ToTensor scaling + normalization + masks, shared train/test."""
        rgb = rgb.astype(np.float32) / 255.0
        normal = normal.astype(np.float32) / 255.0
        norm_valid = (normal > 0).any(axis=-1).astype(np.float32)

        rgb = (rgb - self.rgb_mean) / self.rgb_std
        normal = (normal - self.rgb_mean) / self.rgb_std

        depth_valid = (gt_depth > 1e-4).astype(np.float32)[..., None]
        gt_depth = (gt_depth - self.depth_mean) / self.depth_std
        raw_depth = (raw_depth - self.depth_mean) / self.depth_std

        return dict(
            rgb=rgb.astype(np.float32),
            raw_depth=raw_depth.astype(np.float32)[..., None],
            gt_depth=gt_depth.astype(np.float32)[..., None],
            depth_masks=depth_valid,
            gt_normal=normal.astype(np.float32),
            normal_masks=norm_valid,
            labels=labels.astype(np.int32),
        )

    def get_train_data(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        try:
            s = self._load_raw(idx)
        except Exception:
            return None
        rng = self._rng(idx)
        deg = float(rng.uniform(-5.0, 5.0))
        for k in s:
            s[k] = _rotate_nearest(s[k], deg)
        out = {}
        for k, v in s.items():
            nearest = k == "labels"
            v = _resize_shorter(v, self.height, nearest)
            out[k] = _center_crop(v, self.crop_size)
        return self._finalize(out["rgb"], out["gt_normal"], out["raw_depth"],
                              out["gt_depth"], out["labels"])

    def get_test_data(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        try:
            s = self._load_raw(idx)
        except Exception:
            return None
        out = {}
        for k, v in s.items():
            nearest = k == "labels"
            interp = cv_ops.INTER_NEAREST if nearest else cv_ops.INTER_LINEAR
            out[k] = cv_ops.resize(v, (self.crop_size[1], self.crop_size[0]),
                                   interpolation=interp)
        return self._finalize(out["rgb"], out["gt_normal"], out["raw_depth"],
                              out["gt_depth"], out["labels"])

    def get_sparse_depth(self, dep: np.ndarray, num_sample: int,
                         rng: np.random.Generator) -> np.ndarray:
        """500-point sparsification (nyuv2_dataset_training.py:254-272)."""
        flat = dep.reshape(-1)
        nnz = np.flatnonzero(flat > 1e-4)
        keep = rng.permutation(nnz.size)[:num_sample]
        mask = np.zeros_like(flat)
        mask[nnz[keep]] = 1.0
        return (flat * mask).reshape(dep.shape)

    def __len__(self):
        return len(self.rgb)


class NYUV21400SparseDataset(NYUV21400Dataset):
    """sample-from-raw variant: (256,256), 500-pt sparse input
    (nyuv2_dataset_training_sample_from_raw.py)."""

    def __init__(self, *args, **kw):
        kw.setdefault("height", 256)  # shorter-side resize target
        kw.setdefault("crop_size_height", 256)
        kw.setdefault("crop_size_width", 256)
        super().__init__(*args, **kw)

    def get_train_data(self, idx):
        sample = super().get_train_data(idx)
        if sample is None:
            return None
        rng = self._rng(idx ^ 0x5EED)
        raw = sample["raw_depth"]
        hole = raw <= -1.0 + 1e-6  # normalized zeros
        sp = self.get_sparse_depth((raw * self.depth_std + self.depth_mean)
                                   * (~hole), self.num_sample, rng)
        raw = (sp - self.depth_mean) / self.depth_std
        raw[sp <= 1e-8] = 0.0  # keep holes at exactly 0 in sparse mode
        sample["raw_depth"] = raw
        return sample


class NYUV21400PseudoDataset(NYUV21400Dataset):
    """pseudo-hole variant: raw depth is gt, input corrupted by stochastic
    masks each applied with p=0.5 (nyuv2_dataset_training_pesudo.py:78-99)."""

    def get_train_data(self, idx):
        sample = super().get_train_data(idx)
        if sample is None:
            return None
        rng = self._rng(idx ^ 0xABCD)
        # un-normalize rgb for the mask generators
        rgb255 = (sample["rgb"] * self.rgb_std + self.rgb_mean) * 255.0
        raw = sample["raw_depth"].copy()
        probe = dict(rgb=rgb255, raw_depth=raw[..., 0])
        mask = np.zeros(raw.shape[:2], bool)
        if rng.uniform() < 0.5:
            mask |= SegmentationHighLight()(probe)
        if rng.uniform() < 0.5:
            mask |= Spatter()(probe, rng)
        if rng.uniform() < 0.5:
            mask |= MaskBlacks()(probe)
        raw[mask] = 0.0
        sample["raw_depth"] = raw
        return sample


class NYUV21400RawDataset(NYUV21400Dataset):
    """Raw-Kinect evaluation variant (nyuv2_dataset_testing_raw.py): same
    png layout, (256,256) resize at test time."""

    def __init__(self, *args, **kw):
        kw.setdefault("crop_size_height", 256)
        kw.setdefault("crop_size_width", 256)
        super().__init__(*args, **kw)


DATASETS.register("nyuv2")(NYUV21400Dataset)
DATASETS.register("nyuv2_sparse")(NYUV21400SparseDataset)
DATASETS.register("nyuv2_pseudo")(NYUV21400PseudoDataset)
DATASETS.register("nyuv2_raw")(NYUV21400RawDataset)
