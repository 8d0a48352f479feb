"""Generate a miniature NYUv2 sparse-to-dense corpus in its on-disk layout
(Fangchang Ma's HDF5 frames, as ``nyuv2_s2d`` and ``nyuv2_r2r`` read them,
nyuv2_sparse_to_dense_dataset.py:41-75): ``nyu.json`` with the ``train``
and ``val`` file lists, and one ``.h5`` a frame holding ``rgb`` (3x480x640
uint8) and ``depth`` (480x640 f32 meters), contiguous, written by the
port's own HDF5 writer (``data/hdf5.py``). The frames are the NYUv2
fixture's seeded scenes (``make_nyuv2_fixture``): the depth is the raw
depth, with its edges and holes.

Usage: python -m rdfc_gan_torch.tools.make_s2d_fixture --out DIR \\
           [--n_train 16] [--n_val 8] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import hdf5
from .make_nyuv2_fixture import _scene


def write_fixture(out: str, n_train: int = 16, n_val: int = 8,
                  seed: int = 0):
    """Both splits under ``out``. Returns {file name: {dataset: array}}."""
    written, split = {}, {}
    for mode, n, s in (("train", n_train, seed), ("val", n_val, seed + 1)):
        rng = np.random.RandomState(s)
        os.makedirs(os.path.join(out, mode), exist_ok=True)
        split[mode] = []
        for i in range(n):
            rgb, _, raw_mm, _, _ = _scene(rng)
            fn = f"{mode}/{i:05d}.h5"
            arrays = {"rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                      "depth": raw_mm.astype(np.float32) / 1000.0}
            hdf5.write_contiguous(os.path.join(out, fn), arrays)
            written[fn] = arrays
            split[mode].append({"filename": fn})
    with open(os.path.join(out, "nyu.json"), "w") as f:
        json.dump(split, f)
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n_train", type=int, default=16)
    p.add_argument("--n_val", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    write_fixture(args.out, args.n_train, args.n_val, args.seed)
    print(f"wrote {args.n_train} train / {args.n_val} val frames to "
          f"{args.out}")


if __name__ == "__main__":
    main()
