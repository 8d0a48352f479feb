"""ImagePool, the CycleGAN history buffer of generated images (reference
helper.py:19-77; port of rdfc_gan_tpu/utils/image_pool.py, shipped but
unused by the v2 engine). Once full, each incoming image is swapped with a
stored one with probability 0.5. The decisions come from numpy's
``default_rng(seed)`` in the JAX pool's order, so one seed makes the same
swaps in both."""

from __future__ import annotations

import numpy as np
import torch


class ImagePool:
    def __init__(self, pool_size: int = 50, seed: int = 0):
        self.pool_size = pool_size
        self.images = []
        self._rng = np.random.default_rng(seed)

    def query(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, ...) tensor. Returns a batch of the same shape, on
        the same device, in which each item may be a stored earlier one."""
        if self.pool_size == 0:
            return images
        out = []
        for img in images:
            if len(self.images) < self.pool_size:
                self.images.append(img.clone())
                out.append(img)
            elif self._rng.uniform() > 0.5:
                idx = int(self._rng.integers(0, self.pool_size))
                out.append(self.images[idx].clone())
                self.images[idx] = img.clone()
            else:
                out.append(img)
        return torch.stack(out, dim=0)
