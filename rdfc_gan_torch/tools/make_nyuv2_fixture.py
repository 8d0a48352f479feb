"""Generate a miniature NYUv2-1400-layout dataset (port of the repository's
``tools/make_nyuv2_fixture.py``, with its own copy of the scene generator,
written through ``rdfc_gan_torch.data.image_io``; real on-disk format:
{split}.txt + rgb/ depth/ depth_raw/ norm_v2/ labels_13/ pngs,
nyuv2_dataset_training.py:286-302) with STRUCTURED synthetic scenes —
planar depth + spherical bumps, RGB correlated with geometry, normals from
the depth gradient, region labels — so train.py -> test.py exercises the
full real-data protocol end to end and produces a learnable metric table.

Usage: python -m rdfc_gan_torch.tools.make_nyuv2_fixture --out DIR \
           [--n_train 48] [--n_test 12] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import cv_ops, image_io
from ..data.pseudo_hole import Spatter, hole_image


def _scene(rng: np.random.RandomState, h: int = 480, w: int = 640):
    """One synthetic indoor-ish scene. Returns (rgb u8, depth_mm u16,
    raw_mm u16, normal u8, labels u8)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yn, xn = yy / h, xx / w
    # floor-like plane receding with y + a wall gradient with x
    depth = 1.5 + 6.0 * (1.0 - yn) * rng.uniform(0.6, 1.0) \
        + 1.5 * xn * rng.uniform(-1, 1)
    labels = np.full((h, w), 5, np.uint8)  # floor
    labels[yn < 0.5] = 12  # wall
    # spherical objects
    for _ in range(rng.randint(2, 5)):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        r = rng.uniform(0.05, 0.18) * h
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        m = d2 < r * r
        bump = np.sqrt(np.maximum(r * r - d2, 0.0)) / r
        obj_depth = rng.uniform(1.0, 4.0)
        depth = np.where(m, np.minimum(depth, obj_depth - 0.3 * bump), depth)
        labels[m] = rng.randint(0, 13)
    # box-like furniture: axis-aligned rectangles with tilted planar tops
    # (tables/cabinets) — adds the planar-patch depth statistics and sharp
    # rectangular occlusion edges the spheres don't cover
    for _ in range(rng.randint(1, 4)):
        y0 = int(rng.uniform(0.3, 0.75) * h)
        x0 = int(rng.uniform(0.05, 0.7) * w)
        bh = int(rng.uniform(0.08, 0.3) * h)
        bw = int(rng.uniform(0.1, 0.35) * w)
        y1, x1 = min(y0 + bh, h), min(x0 + bw, w)
        top = rng.uniform(0.9, 3.5)
        tilt_y = rng.uniform(-0.4, 0.4) / max(bh, 1)
        tilt_x = rng.uniform(-0.4, 0.4) / max(bw, 1)
        plane = top + tilt_y * (yy[y0:y1, x0:x1] - y0) \
            + tilt_x * (xx[y0:y1, x0:x1] - x0)
        region = depth[y0:y1, x0:x1]
        depth[y0:y1, x0:x1] = np.minimum(region, plane)
        labels[y0:y1, x0:x1] = np.where(region > plane,
                                        rng.randint(0, 13),
                                        labels[y0:y1, x0:x1])
    depth = np.clip(depth, 0.71, 9.99)

    # normals from the depth gradient (camera-space-ish)
    gy, gx = np.gradient(depth)
    nz = np.ones_like(depth) * 0.01
    n = np.stack([-gx, -gy, nz], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8
    normal_u8 = ((n * 0.5 + 0.5) * 255).astype(np.uint8)

    # rgb correlated with geometry + label-dependent tint
    base = (255 * (0.2 + 0.6 * (depth - depth.min())
                   / (np.ptp(depth) + 1e-6)))[..., None]
    tint = (labels[..., None].astype(np.float32) * 17.0) % 255
    rgb = np.clip(0.7 * base + 0.3 * tint
                  + rng.normal(0, 6, (h, w, 1)), 0, 255)
    rgb = np.repeat(rgb, 3, axis=-1)
    rgb[..., 1] = np.clip(rgb[..., 1] * 0.9 + 10, 0, 255)
    rgb = rgb.astype(np.uint8)

    depth_mm = (depth * 1000).astype(np.uint16)
    raw = depth_mm.copy()
    # Kinect-like holes with the pseudo-hole library's failure modes
    # (data/pseudo_hole.py, lib/datasets/pseudo_hole.py:8-193), so the
    # fixture's raw-depth statistics stress the same regimes real scans do:
    #  1. border shadow (stereo baseline occlusion)
    raw[:, : rng.randint(10, 40)] = 0
    #  2. spatter blobs (specular/IR-absorbing surfaces)
    g = np.random.default_rng(rng.randint(1 << 31))
    void = Spatter()({"raw_depth": depth.astype(np.float32)}, g)
    raw[void] = 0
    #  3. rectangle dropouts (dead sensor patches)
    raw = hole_image(raw, width=rng.randint(20, 60),
                     height=rng.randint(15, 40), nums=rng.randint(1, 4),
                     rng=g)
    #  4. object-rim holes: depth discontinuities shed returns — void a
    #     dilated band around strong gradients (the dominant real NYUv2
    #     raw-depth hole mode)
    gy2, gx2 = np.gradient(depth)
    edges = (np.hypot(gx2, gy2) > 0.08).astype(np.uint8)
    band = cv_ops.dilate(edges, (5, 5)) > 0
    raw[band & (g.random(depth.shape) < 0.85)] = 0
    return rgb, depth_mm, raw, normal_u8, labels


def write_split(root: str, split: str, n: int, seed: int):
    """Write ``n`` scenes of ``split`` (ids 0000..) and its list file.
    Returns {path relative to root: the array written}."""
    rng = np.random.RandomState(seed)
    ids = [f"{i:04d}" for i in range(n)]
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.write("\n".join(ids))
    for sub in ("rgb", "depth", "depth_raw", "norm_v2", "labels_13"):
        os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    written = {}
    for i in ids:
        scene = _scene(rng)
        for sub, arr in zip(("rgb", "depth", "depth_raw", "norm_v2",
                             "labels_13"), scene):
            rel = f"{split}/{sub}/{i}.png"
            image_io.imwrite(os.path.join(root, rel), arr)
            written[rel] = arr
    return written


def write_fixture(out: str, n_train: int = 48, n_test: int = 12,
                  seed: int = 0):
    """Both splits under ``out``. Returns {path relative to out: the array
    written}."""
    os.makedirs(out, exist_ok=True)
    written = write_split(out, "train", n_train, seed)
    written.update(write_split(out, "test", n_test, seed + 1))
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n_train", type=int, default=48)
    p.add_argument("--n_test", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    write_fixture(args.out, args.n_train, args.n_test, args.seed)
    print(f"wrote {args.n_train} train / {args.n_test} test scenes "
          f"to {args.out}")


if __name__ == "__main__":
    main()
