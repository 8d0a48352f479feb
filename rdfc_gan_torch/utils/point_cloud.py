"""PointCloudsHandler: a depth map and its RGB to a coloured point cloud,
and the point cloud to an ASCII ``.pcd`` file (port of
rdfc_gan_tpu/utils/point_cloud.py; reference RDFC-GAN/helper.py:329-379):
intrinsics (h, w, fx, fy, cx, cy), pixels of depth 0 dropped, PCD v0.7
with the colour packed as r << 16 | g << 8 | b. The file is written byte
for byte as the JAX package writes it. It feeds the PointNet critic."""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..parallel import rank, world_size


class PointCloudsHandler:
    def __init__(self, intrinsic: Sequence[float]):
        assert isinstance(intrinsic, (list, tuple)) and len(intrinsic) == 6
        self.h, self.w, self.fx, self.fy, self.cx, self.cy = intrinsic
        self.inv_fx = 1.0 / self.fx
        self.inv_fy = 1.0 / self.fy

    def img2points(self, depth: np.ndarray, rgb: np.ndarray) -> np.ndarray:
        """(H, W) depth and (H, W, 3) rgb -> (N, 6) [x y z r g b], the
        pixels of depth 0 dropped."""
        depth = np.asarray(depth).reshape(self.h, self.w)
        invalid = depth == 0
        x, y = np.meshgrid(np.arange(self.w), np.arange(self.h))
        x3 = (x - self.cx) * depth * self.inv_fx
        y3 = (y - self.cy) * depth * self.inv_fy
        pts = np.stack([x3.reshape(-1), y3.reshape(-1), depth.reshape(-1)], 1)
        keep = ~invalid.reshape(-1)
        cols = np.asarray(rgb).reshape(-1, 3)[keep]
        return np.concatenate([pts[keep], cols], axis=1)

    def points2pcd(self, points: np.ndarray, save_file: str):
        assert os.path.splitext(save_file)[-1] == ".pcd"
        n = points.shape[0]
        with open(save_file, "w") as f:
            f.write("# .PCD v0.7 - Point Cloud Data file format\n"
                    "Version 0.7\nFIELDS x y z rgb\n")
            f.write(f"SIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n"
                    f"WIDTH {n}\nHEIGHT 1\n")
            f.write(f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii")
            for i in range(n):
                r, g, b = (int(points[i, 3]), int(points[i, 4]),
                           int(points[i, 5]))
                packed = r << 16 | g << 8 | b
                f.write(f"\n{points[i, 0]} {points[i, 1]} "
                        f"{points[i, 2]} {packed}")


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size) of this process (the reference's dist_utils
    contract, RDF-GAN/lib/tools/helper.py:152), from ``parallel``."""
    return rank(), world_size()
