"""Pseudo-hole corruption library — synthetic depth-sensor failure modes
(port of rdfc_gan_tpu/data/pseudo_hole.py).

Parity target: lib/datasets/pseudo_hole.py:8-193. The reference's numba-jit
rectangle placer is vectorized numpy; the skimage gaussian blob generator is
OpenCV's Gaussian blur (``cv_ops.gaussian_blur``, as in the JAX package).
All randomness uses an explicit np.random.Generator.

Mask conventions follow the reference: each functor returns a boolean mask of
pixels to VOID (True = hole), except RandomPseudoHole which directly writes
``raw_depth``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import cv_ops


def hole_image(image: np.ndarray, width: int, height: int, nums: int,
               rng: np.random.Generator) -> np.ndarray:
    """Zero out ``nums`` non-overlapping (width x height) rectangles."""
    H, W = image.shape[:2]
    rows, cols = H - height + 1, W - width + 1
    optional = np.ones(rows * cols, dtype=bool)
    masks = np.ones_like(image)
    for _ in range(nums):
        cand = np.flatnonzero(optional)
        if cand.size == 0:
            break
        idx = int(rng.choice(cand))
        x, y = idx // cols, idx % cols
        masks[x: x + width, y: y + height] = 0
        lb, rb = max(0, x - width + 1), min(x + width - 1, cols)
        ub, bb = max(0, y - height + 1), min(y + height - 1, rows)
        blocked = np.zeros((rows, cols), dtype=bool)
        blocked[ub:bb, lb:rb] = True  # reference's (j, i) index order
        optional &= ~blocked.reshape(-1)
    return image * masks


class RandomPseudoHole:
    """Punch random rectangles into gt_depth -> raw_depth."""

    def __init__(self, hole_height: int, hole_width: int, hole_num: int):
        self.hole_height = hole_height
        self.hole_width = hole_width
        self.hole_num = hole_num

    def __call__(self, sample, rng: np.random.Generator):
        gt = sample["gt_depth"].copy()
        sample["raw_depth"] = hole_image(gt, self.hole_width,
                                         self.hole_height, self.hole_num, rng)
        return sample


class DeterministicPseudoHole:
    """Hole mask from semantic classes (fixed list + 2 random extra labels)."""

    def __init__(self, label: Sequence[int], random_filtered_label_nums: int = 2):
        self.label = list(label)
        self.k = random_filtered_label_nums

    def __call__(self, sample, rng: np.random.Generator) -> np.ndarray:
        labels = sample["labels"]
        present = np.nonzero(np.bincount(labels.reshape(-1).astype(np.int64)))[0]
        extra = rng.choice(present, self.k) if present.size else np.array([], int)
        to_filter = self.label + extra.tolist()
        mask = np.zeros(labels.shape[:2], bool)
        for l in to_filter:
            mask |= (labels.squeeze() == l)
        return mask


class MaskBlacks:
    """Mask pixels whose RGB is uniformly near-black (sensor absorbs)."""

    def __init__(self, vmin: float = 0, vmax: float = 5):
        self.vmin, self.vmax = vmin, vmax

    def __call__(self, sample, rng=None) -> np.ndarray:
        rgb = sample["rgb"]
        m = ((rgb >= self.vmin) & (rgb <= self.vmax)).sum(2)
        return m == 3


class SegmentationHighLight:
    """Specular-highlight mask (pseudo_hole.py:99-133)."""

    def __init__(self, T1: float = 210):
        self.T1 = T1

    def __call__(self, sample, rng=None) -> np.ndarray:
        rgb = sample["rgb"]
        cR, cG, cB = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        cE = 0.2989 * cR + 0.5870 * cG + 0.1140 * cB
        rGE = (cG * 0.95) / (cE * 0.95 + 1e-8)
        rBE = (cB * 0.95) / (cE * 0.95 + 1e-8)
        mask = (cG > rGE * self.T1) & (cB > rBE * self.T1) & (cE > self.T1)
        return mask


class Spatter:
    """Gaussian-blob voids: threshold a blurred uniform field at a percentile
    (pseudo_hole.py:136-175)."""

    def __init__(self, granularity: int = 8, percentile_void: float = 0.05):
        self.granularity = granularity
        self.percentile_void = percentile_void

    def __call__(self, sample, rng: np.random.Generator) -> np.ndarray:
        shape = sample["raw_depth"].shape[:2]
        field = rng.uniform(size=shape).astype(np.float32)
        k = int(self.granularity * 4) | 1  # the JAX package's kernel size
        field = cv_ops.gaussian_blur(field, (k, k), self.granularity)
        thr = np.percentile(field.reshape(-1), 100 * (1 - self.percentile_void))
        return field > thr
