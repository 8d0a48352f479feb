"""The cell's inputs, made on the host from the seed in a few bulk draws:
a pool of distinct batches in the synthetic dataset's form (rgb in
[-1, 1]; depth 0.7-10 m normalised by mean 5 and std 5, 60% of the raw
depth's pixels dropped to 0; unit normals; labels in [0, classes)), and
each train step's random draws."""

from __future__ import annotations

from typing import Dict, List

import torch

DEPTH_MEAN = DEPTH_STD = 5.0


def batch_pool(seed: int, n: int, batch: int, height: int, width: int,
               train: bool, classes: int = 14) -> List[Dict[str, torch.Tensor]]:
    """``n`` distinct host batches (NCHW, f32; labels int64)."""
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    shape = (n, batch, 1, height, width)
    depth = 0.7 + 9.3 * torch.rand(shape, generator=gen)
    keep = (torch.rand(shape, generator=gen) > 0.6).float()
    pool = dict(rgb=torch.rand((n, batch, 3, height, width),
                               generator=gen) * 2 - 1,
                raw_depth=(depth * keep - DEPTH_MEAN) / DEPTH_STD * keep)
    if train:
        normal = torch.randn((n, batch, 3, height, width), generator=gen)
        normal /= normal.norm(dim=2, keepdim=True) + 1e-8
        pool.update(
            gt_depth=(depth - DEPTH_MEAN) / DEPTH_STD,
            depth_masks=torch.ones(shape),
            gt_normal=normal,
            normal_masks=torch.ones((n, batch, height, width)),
            labels=torch.randint(0, classes, (n, batch, height, width),
                                 generator=gen))
    return [{k: v[i].contiguous() for k, v in pool.items()}
            for i in range(n)]


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in batch.items()}


def step_draws(seed: int, step: int, batch: int, height: int, width: int,
               keep_shapes, device) -> dict:
    """Step ``step``'s draws for the flagship's step: the pepper noise's
    batch uniform and (B, 1, H, W) field, and G_label's two keep masks
    (kept with probability 0.9), from a generator on ``device`` seeded by
    (seed, step)."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + int(step)) % (2 ** 63))
    active = torch.rand((), generator=gen, device=device)
    field = torch.rand((batch, 1, height, width), generator=gen,
                       device=device)
    keep = tuple(torch.rand(s, generator=gen, device=device) < 0.9
                 for s in keep_shapes)
    return dict(pepper=(active, field), keep=keep)
