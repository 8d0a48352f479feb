"""Dict-sample transforms for the depth-completion pipelines (port of
rdfc_gan_tpu/data/transforms.py, on ``cv_ops`` instead of OpenCV).

Parity targets: lib/datasets/preprocessing.py (Normalize with zero-preserving
raw-depth semantics :40-50, Rescale, RandomRescale, RandomCrop, RandomFlip,
CutOffBlackBorder) and the NYUv2 training pipeline's rotation/resize/crop
stack (nyuv2_dataset_training.py:73-156).

Host-side numpy ops on HWC arrays. All randomness flows through an
explicit ``np.random.Generator`` so corruption is reproducible from
(seed, epoch, index) — the deterministic, key-split analog the reference's
global-RNG pipeline lacks (SURVEY.md §7.3-6).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import cv_ops

Sample = Dict[str, np.ndarray]

IMG_KEYS = ("rgb", "raw_depth", "gt_depth", "gt_normal", "labels",
            "depth_masks", "normal_masks")
_NEAREST_KEYS = {"labels", "depth_masks", "normal_masks"}


def _resize(img: np.ndarray, hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    interp = cv_ops.INTER_NEAREST if nearest else cv_ops.INTER_LINEAR
    out = cv_ops.resize(img, (hw[1], hw[0]), interpolation=interp)
    if img.ndim == 3 and out.ndim == 2:
        out = out[..., None]
    return out


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class CutOffBlackBorder:
    """Crop the Kinect black border (pseudo_hole.py:178-193; NYUv2 uses
    top=45, bottom=15, left=45, right=40 — nyuv2_dataset_training.py:77-82)."""

    def __init__(self, top=45, bottom=15, left=45, right=40):
        self.top, self.bottom, self.left, self.right = top, bottom, left, right

    def __call__(self, sample: Sample, rng=None) -> Sample:
        for k in IMG_KEYS:
            if k in sample:
                v = sample[k]
                sample[k] = v[self.top: v.shape[0] - self.bottom,
                              self.left: v.shape[1] - self.right]
        return sample


class RandomRotate:
    """±degrees rotation of all aligned maps (nearest for labels/masks)."""

    def __init__(self, degrees: float = 5.0):
        self.degrees = degrees

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        ang = float(rng.uniform(-self.degrees, self.degrees))
        for k in IMG_KEYS:
            if k in sample:
                v = sample[k]
                m = cv_ops.rotation_matrix(
                    (v.shape[1] / 2, v.shape[0] / 2), ang, 1.0)
                flags = (cv_ops.INTER_NEAREST if k in _NEAREST_KEYS
                         else cv_ops.INTER_LINEAR)
                out = cv_ops.warp_affine(v, m, (v.shape[1], v.shape[0]),
                                         flags=flags)
                if v.ndim == 3 and out.ndim == 2:
                    out = out[..., None]
                sample[k] = out
        return sample


class Rescale:
    def __init__(self, height: int, width: int):
        self.hw = (height, width)

    def __call__(self, sample: Sample, rng=None) -> Sample:
        for k in IMG_KEYS:
            if k in sample:
                sample[k] = _resize(sample[k], self.hw, k in _NEAREST_KEYS)
        return sample


class RandomRescale:
    """Scale-jitter by a factor in [lo, hi] (v1 pipelines use 1.0-1.4/1.5).
    Depth values divide by the scale (closer when zoomed in,
    nyuv2_sparse_to_dense_dataset.py:117,144)."""

    def __init__(self, lo: float = 1.0, hi: float = 1.4,
                 scale_depth_values: bool = False):
        self.lo, self.hi = lo, hi
        self.scale_depth_values = scale_depth_values

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        s = float(rng.uniform(self.lo, self.hi))
        for k in IMG_KEYS:
            if k in sample:
                v = sample[k]
                hw = (int(round(v.shape[0] * s)), int(round(v.shape[1] * s)))
                sample[k] = _resize(v, hw, k in _NEAREST_KEYS)
        if self.scale_depth_values:
            for k in ("raw_depth", "gt_depth"):
                if k in sample:
                    sample[k] = sample[k] / s
        return sample


class RandomCrop:
    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        any_img = next(sample[k] for k in IMG_KEYS if k in sample)
        H, W = any_img.shape[:2]
        y = int(rng.integers(0, max(H - self.h, 0) + 1))
        x = int(rng.integers(0, max(W - self.w, 0) + 1))
        for k in IMG_KEYS:
            if k in sample:
                sample[k] = sample[k][y:y + self.h, x:x + self.w]
        return sample


class CenterCrop:
    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, sample: Sample, rng=None) -> Sample:
        any_img = next(sample[k] for k in IMG_KEYS if k in sample)
        H, W = any_img.shape[:2]
        y = max((H - self.h) // 2, 0)
        x = max((W - self.w) // 2, 0)
        for k in IMG_KEYS:
            if k in sample:
                sample[k] = sample[k][y:y + self.h, x:x + self.w]
        return sample


class RandomFlip:
    """Horizontal flip p=0.5; the normal x component negates under a flip."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.uniform() < self.p:
            for k in IMG_KEYS:
                if k in sample:
                    sample[k] = np.ascontiguousarray(sample[k][:, ::-1])
            if "gt_normal" in sample:
                sample["gt_normal"] = sample["gt_normal"] * np.array(
                    [-1.0, 1.0, 1.0], dtype=sample["gt_normal"].dtype)
        return sample


class Normalize:
    """rgb: (x - 0.5)/0.5; depth: (x - 5)/5 with ZERO-PRESERVING semantics on
    raw depth — missing pixels stay exactly 0 (preprocessing.py:40-50)."""

    def __init__(self, rgb_mean=0.5, rgb_std=0.5, depth_mean=5.0,
                 depth_std=5.0, normal_mean: Optional[float] = None,
                 normal_std: Optional[float] = None):
        self.rm, self.rs = rgb_mean, rgb_std
        self.dm, self.ds = depth_mean, depth_std
        self.nm, self.ns = normal_mean, normal_std

    def __call__(self, sample: Sample, rng=None) -> Sample:
        if "rgb" in sample:
            sample["rgb"] = (sample["rgb"] - self.rm) / self.rs
        if "gt_depth" in sample:
            sample["gt_depth"] = (sample["gt_depth"] - self.dm) / self.ds
        if "raw_depth" in sample:
            raw = sample["raw_depth"]
            hole = raw <= 1e-8
            raw = (raw - self.dm) / self.ds
            raw[hole] = 0.0
            sample["raw_depth"] = raw
        if self.nm is not None and "gt_normal" in sample:
            sample["gt_normal"] = (sample["gt_normal"] - self.nm) / self.ns
        return sample


class SparseSampler:
    """Keep ``num_samples`` random valid pixels of the input depth — the
    sparse-to-dense 500-point protocol (nyuv2_dataset_training.py:254-272)."""

    def __init__(self, num_samples: int = 500, key: str = "raw_depth"):
        self.n = num_samples
        self.key = key

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        d = sample[self.key]
        flat = d.reshape(-1)
        valid = np.flatnonzero(flat > 1e-8)
        out = np.zeros_like(flat)
        if valid.size > 0:
            chosen = rng.choice(valid, size=min(self.n, valid.size),
                                replace=False)
            out[chosen] = flat[chosen]
        sample[self.key] = out.reshape(d.shape)
        return sample


class MultiScaleLabel:
    """Nearest-neighbor label pyramids for pyramid supervision
    (RDF-GAN/lib/dataset/transforms/transforms.py:330-354): adds
    ``label_down`` = {rate: (H//rate, W//rate) labels} for the ESANet
    side-output losses at 1/8, 1/16, 1/32."""

    def __init__(self, downsampling_rates: Optional[Sequence[int]] = None,
                 key: str = "labels"):
        self.rates = list(downsampling_rates or (8, 16, 32))
        self.key = key

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        label = np.asarray(sample[self.key])
        if label.ndim == 3:
            label = label.squeeze(-1)
        h, w = label.shape
        # FLAT per-rate keys (label_down_8/16/32), not the reference's
        # nested dict (transforms.py:345-352): dict-valued sample keys
        # np.stack into object arrays in the DataLoader and cannot be
        # batched or device_put
        for rate in self.rates:
            sample[f"label_down_{rate}"] = cv_ops.resize(
                label, (w // rate, h // rate),
                interpolation=cv_ops.INTER_NEAREST)
        return sample


class TypeCheck:
    """uint8/uint16 -> float32 cast by key
    (RDF-GAN/lib/dataset/transforms/format.py:32-45)."""

    def __init__(self, keys: Sequence[str]):
        self.keys = list(keys)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for k in self.keys:
            v = sample[k]
            if v.dtype in (np.uint8, np.uint16):
                sample[k] = v.astype(np.float32)
        return sample


class EnsureChannels:
    """Formatter (format.py:14-29 ToTensor analog): guarantee HWC rank-3
    arrays by key. The torch CHW permute is dropped — this framework's
    device layout is NHWC."""

    def __init__(self, keys: Sequence[str]):
        self.keys = list(keys)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for k in self.keys:
            v = np.asarray(sample[k])
            if v.ndim < 3:
                v = v[..., None]
            sample[k] = v
        return sample
