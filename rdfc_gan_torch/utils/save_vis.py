"""Visualization dumps: image grids and label colorization (port of
rdfc_gan_tpu/utils/save_vis.py; reference lib/utils/save_vis.py:7-75).

Grids are written as PNG through ``data.image_io``: the card's machine has
no JPEG encoder, so where the JAX package writes ``.jpg`` the port writes
``.png`` of the same uint8 grid (lossless, so the file decodes to exactly
``merge_images``' result).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..data import image_io

# the 14 colours of the NYUv2-13 label grids (rdfc_gan.py:465-469)
PALETTE = [(0, 0, 0), (0, 0, 255), (232, 88, 47), (0, 217, 0),
           (148, 0, 240), (222, 241, 23), (255, 205, 205), (0, 223, 228),
           (106, 135, 204), (116, 28, 41), (240, 35, 235), (0, 166, 156),
           (249, 139, 0), (225, 228, 194)]


def to_data(img) -> np.ndarray:
    """(B,H,W,C) [-1,1] or [0,1] -> [0, 255] float array for dumping."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 4 and arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    lo, hi = arr.min(), arr.max()
    if lo < -0.01:  # [-1, 1] -> [0, 255]
        arr = (arr + 1.0) * 127.5
    elif hi <= 1.0:
        arr = arr * 255.0
    return np.clip(arr, 0, 255)


def color_label(labels, palette: Sequence, num_classes: int) -> np.ndarray:
    """(B,H,W) int -> (B,H,W,3) palette colors."""
    labels = np.asarray(labels).astype(np.int64)
    pal = np.asarray(list(palette) + [(0, 0, 0)] * num_classes)[:num_classes]
    return pal[np.clip(labels, 0, num_classes - 1)].astype(np.float32)


def merge_images(image_lists: List[np.ndarray], num_imgs_per_scene: int,
                 batch_size: int = 8) -> np.ndarray:
    """Row per scene, ``num_imgs_per_scene`` columns (save_vis.py merge)."""
    assert len(image_lists) == num_imgs_per_scene
    b = min(batch_size, image_lists[0].shape[0])
    h, w = image_lists[0].shape[1:3]
    canvas = np.zeros((b * h, num_imgs_per_scene * w, 3), np.float32)
    for col, imgs in enumerate(image_lists):
        for row in range(b):
            canvas[row * h:(row + 1) * h, col * w:(col + 1) * w] = imgs[row]
    return canvas


def save_image_grid(path: str, image_lists: List[np.ndarray],
                    num_imgs_per_scene: int, batch_size: int = 8):
    """Write the merged grid of NHWC arrays as an RGB PNG at ``path``."""
    merged = merge_images([to_data(x) for x in image_lists],
                          num_imgs_per_scene, batch_size)
    image_io.imwrite(path, merged.astype(np.uint8)[..., ::-1])
