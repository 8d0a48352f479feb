"""Single-image inference (port of the repository's ``tools/inference.py``;
reference RDF-GAN/lib/tools/inference.py:38-94).

    python -m rdfc_gan_torch.inference \\
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml \\
        --load_from W/best.pth --rgb img.png --depth depth.png \\
        --out pred.png [--out_height 224 --out_width 304] [--depth_only] \\
        [--device cuda|cpu]

Reads an RGB PNG and a raw-depth PNG in millimetres, resizes them to
(out_height, out_width) (the RGB linearly in f32, the depth by nearest
neighbour, as OpenCV does), normalizes them with the training statistics,
runs the engine's ``forward_test`` on ``--device`` (default cuda, which
raises without a card) and writes the completed depth as a uint16 PNG in
millimetres at ``--out``, and a VIRIDIS colour map of it at
``<out>_vis.png`` (PNG: the card's machine has no JPEG encoder, where the
JAX tool writes ``_vis.jpg``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rdfc_gan_torch.inference")
    p.add_argument("--model_cfg_path", required=True)
    p.add_argument("--load_from", default=None)
    p.add_argument("--rgb", required=True)
    p.add_argument("--depth", required=True)
    p.add_argument("--out", default="pred_depth.png")
    p.add_argument("--out_height", type=int, default=224)
    p.add_argument("--out_width", type=int, default=304)
    p.add_argument("--depth_only", action="store_true", default=False,
                   help="skip G_label, whose labels pred_depth never reads")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) raises when no card is present")
    return p


def load_inputs(rgb_path: str, depth_path: str, size):
    """The normalized (1, 3, H, W) rgb and (1, 1, H, W) depth of the two
    files, ``size`` = (width, height)."""
    from .data import cv_ops, image_io

    rgb = image_io.bgr2rgb(image_io.imread(rgb_path)).astype(
        np.float32) / 255.0
    depth = image_io.imread(depth_path).astype(np.float32) / 1000.0  # m
    rgb = cv_ops.resize(rgb, size)
    depth = cv_ops.resize(depth, size, interpolation=cv_ops.INTER_NEAREST)
    rgb_n = ((rgb - np.asarray(_MEAN)) / np.asarray(_STD)).astype(np.float32)
    depth_n = (depth - 5.0) / 5.0
    return (torch.from_numpy(rgb_n).permute(2, 0, 1)[None].contiguous(),
            torch.from_numpy(np.ascontiguousarray(depth_n))[None, None])


def run(argv=None) -> dict:
    """Returns the predicted depth in metres (H, W) and the written paths."""
    from .config import default_config, load_config
    from .data import cv_ops, image_io
    from .engines import build_engine, resolve_device
    from .utils import set_random_seed
    from .utils.checkpoint import load_checkpoint

    args = build_parser().parse_args(argv)
    cfg = default_config()
    load_config(cfg, args.model_cfg_path)
    cfg.merge(dict(out_height=args.out_height, out_width=args.out_width,
                   device=args.device))
    device = resolve_device(args.device)
    rgb, depth = load_inputs(args.rgb, args.depth,
                             (args.out_width, args.out_height))
    set_random_seed(cfg.seed)
    engine = build_engine(cfg, is_train=False)
    if args.load_from:
        load_checkpoint(engine.modules, args.load_from, cfg=cfg)
    ret = engine.forward_test(rgb=rgb.to(device), raw_depth=depth.to(device),
                              depth_only=args.depth_only)
    pred = ret["pred_depth"][0, 0].float().cpu().numpy() * 5.0 + 5.0  # m
    image_io.imwrite(args.out, (pred * 1000.0).astype(np.uint16))
    vis = cv_ops.apply_colormap(
        np.clip(pred / 10.0 * 255.0, 0, 255).astype(np.uint8),
        cv_ops.COLORMAP_VIRIDIS)
    vis_path = os.path.splitext(args.out)[0] + "_vis.png"
    image_io.imwrite(vis_path, vis)
    print(f"saved {args.out}; depth range [{pred.min():.3f}, "
          f"{pred.max():.3f}] m")
    return dict(pred=pred, out=args.out, vis=vis_path)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
