"""NYUv2 sparse-to-dense HDF5 dataset, v1's default corpus (port of
rdfc_gan_tpu/data/nyuv2_s2d.py: frames through the port's HDF5 reader,
resampling through ``cv_ops``, which match h5py and OpenCV).

Parity target: RDF-GAN/lib/dataset/nyuv2/nyuv2_sparse_to_dense_dataset.py:
41-438 — nyu.json split file, h5 files with 'rgb' (3,H,W) and 'depth' (H,W)
keys; train: hflip p=0.5, ±5° nearest rotation, scale-jitter 1.0-1.5 (resize
shorter side to 240*s, CenterCrop (228,304), depth values / s), ColorJitter
(0.4,0.4,0.4); 500-pt sparse input with zero-preserving normalization;
test: resize 240 / CenterCrop, plus 'gt_depth_origin' passthrough (the v1
evaluator resizes predictions back, rdf_gan_evaluator.py:36-45).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..registry import DATASETS
from . import hdf5
from .base import BaseDataset
from .nyuv2 import _center_crop, _resize_shorter, _rotate_nearest

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def _color_jitter(rgb01: np.ndarray, rng: np.random.Generator,
                  strength: float = 0.4) -> np.ndarray:
    """torchvision ColorJitter(brightness, contrast, saturation) analog:
    random order, each factor ~ U[1-s, 1+s] (nyuv2_s2d.py:28-46)."""
    ops = ["brightness", "contrast", "saturation"]
    rng.shuffle(ops)
    out = rgb01
    for op in ops:
        f = float(rng.uniform(1 - strength, 1 + strength))
        if op == "brightness":
            out = out * f
        elif op == "contrast":
            mean = out.mean(axis=(0, 1), keepdims=True).mean()
            out = (out - mean) * f + mean
        else:  # saturation
            gray = out @ _GRAY
            out = (out - gray[..., None]) * f + gray[..., None]
        out = np.clip(out, 0.0, 1.0)
    return out


def load_h5_frame(path: str):
    """(rgb (H, W, 3) uint8, depth (H, W) f32) of one HDF5 frame."""
    with hdf5.File(path) as f:
        rgb = f["rgb"][:].transpose(1, 2, 0)
        depth = f["depth"][:].astype(np.float32)
    return rgb, depth


class NYUV2S2DDataset(BaseDataset):
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=_IMAGENET_MEAN, rgb_std=_IMAGENET_STD,
                 max_depth: float = 10.0, depth_mean=(5.0,), depth_std=(5.0,),
                 num_sample: int = 500, seed: int = 0, **unused):
        super().__init__(data_root, mode, rgb_mean, rgb_std, max_depth,
                         depth_mean, depth_std, seed)
        split_json = os.path.join(data_root, "nyu.json")
        if not os.path.exists(split_json):
            raise FileNotFoundError(
                "Please put the nyu.json file under the nyudepthv2 root")
        with open(split_json) as f:
            self.sample_list = json.load(f)[mode]
        self.num_sample = num_sample
        self.height, self.width = 240, 320
        self.crop_size = (228, 304)

    def __len__(self):
        return len(self.sample_list)

    def _load(self, idx):
        return load_h5_frame(os.path.join(
            self.data_root, self.sample_list[idx]["filename"]))

    def _sparse(self, depth: np.ndarray, rng) -> np.ndarray:
        flat = depth.reshape(-1)
        nnz = np.flatnonzero(flat > 1e-4)
        keep = rng.permutation(nnz.size)[: self.num_sample]
        mask = np.zeros_like(flat)
        mask[nnz[keep]] = 1.0
        return (flat * mask).reshape(depth.shape)

    def _pack(self, rgb01, depth, sparse):
        rgb = (rgb01 - self.rgb_mean) / self.rgb_std
        valid = (depth > 1e-4).astype(np.float32)[..., None]
        gt = (depth - self.depth_mean) / self.depth_std
        hole = sparse == 0.0
        sp = (sparse - self.depth_mean) / self.depth_std
        sp[hole] = 0.0
        return dict(rgb=rgb.astype(np.float32),
                    raw_depth=sp.astype(np.float32)[..., None],
                    gt_depth=gt.astype(np.float32)[..., None],
                    depth_masks=valid)

    def get_train_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb, depth = self._load(idx)
        except Exception:
            return None
        rng = self._rng(idx)
        scale = float(rng.uniform(1.0, 1.5))
        degree = float(rng.uniform(-5.0, 5.0))
        if rng.uniform() > 0.5:
            rgb, depth = rgb[:, ::-1], depth[:, ::-1]
        rgb, depth = _rotate_nearest(rgb, degree), _rotate_nearest(depth,
                                                                   degree)
        tgt = int(self.height * scale)
        rgb = _resize_shorter(rgb, tgt, nearest=False)
        depth = _resize_shorter(depth, tgt, nearest=False)
        rgb01 = _color_jitter(rgb.astype(np.float32) / 255.0, rng)
        rgb01 = _center_crop(rgb01, self.crop_size)
        depth = _center_crop(depth, self.crop_size) / scale
        sparse = self._sparse(depth, rng)
        return self._pack(rgb01, depth, sparse)

    def get_test_data(self, idx) -> Optional[Dict[str, np.ndarray]]:
        try:
            rgb, depth = self._load(idx)
        except Exception:
            return None
        rng = self._rng(idx)
        rgb = _center_crop(_resize_shorter(rgb, self.height, False),
                           self.crop_size)
        depth = _center_crop(_resize_shorter(depth, self.height, False),
                             self.crop_size)
        rgb01 = rgb.astype(np.float32) / 255.0
        sample = self._pack(rgb01, depth, self._sparse(depth, rng))
        sample["gt_depth_origin"] = depth.astype(np.float32)
        return sample

    def stat_depth(self, log=print):
        """Corpus depth statistics sweep (nyuv2_sparse_to_dense_dataset.py:
        401-438): min/max over all frames plus per-frame-averaged mean/std of
        the raw h5 depth maps. Returns (min, max, mean, std)."""
        lo, hi = np.inf, -np.inf
        mean = std = 0.0
        for i in range(len(self)):
            _, depth = self._load(i)
            lo = min(lo, float(depth.min()))
            hi = max(hi, float(depth.max()))
            mean += float(depth.mean())
            std += float(depth.std())
            if log is print:
                print(f"\r{i + 1}/{len(self)}", end="")
        mean /= max(len(self), 1)
        std /= max(len(self), 1)
        if log is print:
            print()
        log(f"min depth: {lo}, max depth: {hi}")
        log(f"mean: [{mean}], std: [{std}]")
        return lo, hi, mean, std


DATASETS.register("nyuv2_s2d")(NYUV2S2DDataset)
