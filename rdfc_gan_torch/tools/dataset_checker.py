"""Dataset smoke checker (port of tools/dataset_checker.py; reference
RDFC-GAN/dataset_checker.py:8-54): builds one registered dataset, pulls
its first sample and prints each key's shape, type and range.

    python -m rdfc_gan_torch.tools.dataset_checker [--dataset synthetic] \\
        [--data_root ROOT] [--mode train|val]
"""

from __future__ import annotations

import argparse

import numpy as np


def check(name: str, **kwargs):
    from .. import data  # noqa: F401  (registers the datasets)
    from ..registry import build_dataset

    try:
        ds = build_dataset(dict(type=name, **kwargs))
        sample = ds[0]
        print(f"[{name}] len={len(ds)}")
        for k, v in sample.items():
            v = np.asarray(v)
            print(f"  {k}: shape={v.shape} dtype={v.dtype} "
                  f"range=({v.min():.3f}, {v.max():.3f})")
    except Exception as e:
        print(f"[{name}] FAILED: {type(e).__name__}: {e}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data_root", default=None)
    p.add_argument("--mode", default="train")
    args = p.parse_args(argv)
    kwargs = {"mode": args.mode}
    if args.data_root:
        kwargs["data_root"] = args.data_root
    check(args.dataset, **kwargs)


if __name__ == "__main__":
    main()
