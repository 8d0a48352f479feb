"""SUNRGBD dataset — bit-shifted Kinect depth decode, pickle seg labels
(port of rdfc_gan_tpu/data/sunrgbd.py: PNGs through ``image_io``,
resampling through ``cv_ops``).

Parity target: lib/datasets/sunrgbd/ (sunrgbd_dataset.py, sunrgbd_base.py).
  * depth decode: right_shift(d,3) | left_shift(d,13), /1000 m
    (sunrgbd_dataset.py:258-264; the reference writes left_shift(d, 16-3)).
  * raw depth = 'depth', gt depth = 'depth_bfx' (inpainted).
  * file lists: {train,test}_{rgb,depth,depth_bfx,seg_label,normal}.txt.
  * train: ±5° nearest rotate, resize (256,256); rgb ImageNet-normalized,
    normal (0.5,0.5)-normalized; depth (5,5).
  * test adds origin_h/origin_w/real_idx passthrough for resize-back eval
    (sunrgbd_dataset.py:236-239).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from . import cv_ops, image_io
from .base import BaseDataset

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class SUNRGBDBase:
    MODES = ["train", "val", "test"]
    N_CLASSES = 37


class SUNRGBDPseudoDataset(SUNRGBDBase, BaseDataset):
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=_IMAGENET_MEAN, rgb_std=_IMAGENET_STD,
                 max_depth: float = 10.0, depth_mean=(5.0,), depth_std=(5.0,),
                 seed: int = 0, **unused):
        BaseDataset.__init__(self, data_root, mode, rgb_mean, rgb_std,
                             max_depth, depth_mean, depth_std, seed)
        assert mode in self.MODES
        (self.rgb, self.raw_depth, self.bfx_depth, self.label,
         self.gt_normal) = self.load_file()
        self.crop_size = (256, 256)
        self.with_input_origin = True

    def load_file(self):
        prefix = "train_" if self.mode == "train" else "test_"

        def rd(name):
            with open(os.path.join(self.data_root, f"{prefix}{name}.txt")) as f:
                return f.read().splitlines()

        return (rd("rgb"), rd("depth"), rd("depth_bfx"), rd("seg_label"),
                rd("normal"))

    # ------------------------------------------------------------------- io
    @staticmethod
    def get_depth_inpaint(depth: np.ndarray) -> np.ndarray:
        """(d >> 3) | (d << 13) in uint16, in metres (the numpy path of the
        JAX package's ``fastops.sunrgbd_depth_decode``)."""
        d = np.ascontiguousarray(depth, np.uint16)
        v = np.bitwise_or(np.right_shift(d, 3), np.left_shift(d, 13))
        return v.astype(np.float32) / 1000.0

    def _load(self, idx):
        read = self._read
        rgb = image_io.bgr2rgb(read(self.rgb[idx]))
        normal = image_io.bgr2rgb(read(self.gt_normal[idx]))
        raw = self.get_depth_inpaint(read(self.raw_depth[idx]))
        gt = self.get_depth_inpaint(read(self.bfx_depth[idx]))
        with open(os.path.join(self.data_root, self.label[idx]), "rb") as f:
            labels = pickle.load(f)
        return rgb, normal, raw, gt, np.asarray(labels)

    def _finalize(self, rgb, normal, raw, gt, labels):
        rgb = rgb.astype(np.float32) / 255.0
        normal = normal.astype(np.float32) / 255.0
        norm_valid = (normal > 0).any(axis=-1).astype(np.float32)
        rgb = (rgb - self.rgb_mean) / self.rgb_std
        normal = (normal - 0.5) / 0.5  # sunrgbd_dataset.py:141
        depth_valid = (gt > 1e-4).astype(np.float32)[..., None]
        gt = (gt - self.depth_mean) / self.depth_std
        raw = (raw - self.depth_mean) / self.depth_std
        return dict(
            rgb=rgb.astype(np.float32),
            raw_depth=raw.astype(np.float32)[..., None],
            gt_depth=gt.astype(np.float32)[..., None],
            depth_masks=depth_valid,
            gt_normal=normal.astype(np.float32),
            normal_masks=norm_valid,
            labels=labels.astype(np.int32),
        )

    def _resize_all(self, rgb, normal, raw, gt, labels):
        sz = (self.crop_size[1], self.crop_size[0])
        lin, near = cv_ops.INTER_LINEAR, cv_ops.INTER_NEAREST
        rgb = cv_ops.resize(rgb, sz, interpolation=lin)
        normal = cv_ops.resize(normal, sz, interpolation=lin)
        raw = cv_ops.resize(raw, sz, interpolation=lin)
        gt = cv_ops.resize(gt, sz, interpolation=lin)
        labels = cv_ops.resize(labels, sz, interpolation=near)
        return rgb, normal, raw, gt, labels

    def get_train_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb, normal, raw, gt, labels = self._load(idx)
        except Exception:
            return None
        rng = self._rng(idx)
        deg = float(rng.uniform(-5.0, 5.0))

        def rot(img):
            m = cv_ops.rotation_matrix(
                (img.shape[1] / 2, img.shape[0] / 2), deg, 1.0)
            return cv_ops.warp_affine(img, m, (img.shape[1], img.shape[0]),
                                      flags=cv_ops.INTER_NEAREST)

        rgb, normal, raw, gt, labels = map(rot, (rgb, normal, raw, gt, labels))
        rgb, normal, raw, gt, labels = self._resize_all(rgb, normal, raw, gt,
                                                        labels)
        return self._finalize(rgb, normal, raw, gt, labels)

    def get_test_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb, normal, raw, gt, labels = self._load(idx)
        except Exception:
            return None
        origin_h, origin_w = gt.shape[:2]
        rgb, normal, raw, gt, labels = self._resize_all(rgb, normal, raw, gt,
                                                        labels)
        sample = self._finalize(rgb, normal, raw, gt, labels)
        if self.with_input_origin:
            sample.update(
                origin_h=np.int32(origin_h), origin_w=np.int32(origin_w),
                real_idx=np.int32(idx))
        return sample

    def __len__(self):
        return len(self.rgb)


DATASETS.register("sunrgbd")(SUNRGBDPseudoDataset)
