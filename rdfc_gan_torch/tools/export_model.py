"""Serving export (port of the repository's ``tools/export_model.py``):
``engine.forward_test`` in eval mode, without gradients, as a
``torch.export`` program written to a ``.pt2`` file.

    python -m rdfc_gan_torch.tools.export_model \\
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml \\
        --load_from W/best.pth --out model.pt2 --batch_size 4 \\
        --out_height 224 --out_width 304 [--depth_only] [--check] \\
        [--device cuda|cpu]

Shapes are static, as in the JAX tool: the program serves the exported
batch and size. The weights travel in the file as the program's lifted
parameters and buffers (the JAX artifact takes them as arguments). With
``--depth_only`` the exported module holds no G_label, so none of its
weights are in the file. After ``--load_from`` one forward of the sample
batch probes the NLSPN offsets (``ops.nlspn_guard``) and rebuilds the
generator where the stencil radius does not cover them, before export, as
``rdfc_gan_torch.test`` does. ``--check`` loads the file back and holds
its pred_depth against the live engine (rtol = atol = 2e-5).

The served kernels (the shift-mask scatter, the NLSPN chain, the instance
norm's forward) stay in the program as the dispatcher ops
``rdfc_gan_torch::*``. So a host that loads the file imports
``rdfc_gan_torch.ops.kernels`` first, which registers them (and builds each
kernel with ``nvcc`` at its first launch), and nothing more of the port:

    import torch
    import rdfc_gan_torch.ops.kernels
    serve = torch.export.load("model.pt2").module()
    with torch.no_grad():
        out = serve(rgb, raw_depth)   # {"pred_depth": ..., ...}

``--device`` defaults to cuda and raises without a card; the kernels run
only on the card, the ops' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

# the JAX tool's round-trip tolerance
CHECK_RTOL = CHECK_ATOL = 2e-5


def parse_args(argv=None):
    p = argparse.ArgumentParser("rdfc_gan_torch.tools.export_model",
                                description=__doc__.splitlines()[0])
    p.add_argument("--model_cfg_path", required=True)
    p.add_argument("--load_from", default="",
                   help="a port .pth or a JAX driver's .ckpt whose nets "
                        "the program carries; omit to export the seeded "
                        "random init")
    p.add_argument("--out", required=True, help="output .pt2 path")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--out_height", type=int, default=224)
    p.add_argument("--out_width", type=int, default=304)
    p.add_argument("--num_classes", type=int, default=14)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) raises when no card is present")
    p.add_argument("--check", action="store_true",
                   help="load the file back, run it and compare pred_depth "
                        "with the live engine")
    p.add_argument("--depth_only", action="store_true", default=False,
                   help="export the pred_depth-only program: G_label is "
                        "skipped (its logits never feed pred_depth, "
                        "reference quirk rdfc_gan.py:172-180) and its "
                        "weights are left out of the file")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def sample_inputs(batch: int, height: int, width: int, seed: int, device):
    """The JAX tool's sample batch, the same draws from numpy's
    ``default_rng(seed)``, in NCHW: rgb (B, 3, H, W), raw_depth
    (B, 1, H, W)."""
    rng = np.random.default_rng(seed)
    rgb = rng.standard_normal((batch, height, width, 3), dtype=np.float32)
    depth = rng.standard_normal((batch, height, width, 1), dtype=np.float32)
    return tuple(torch.from_numpy(a.transpose(0, 3, 1, 2).copy()).to(device)
                 for a in (rgb, depth))


def build(args):
    """The engine of ``--model_cfg_path`` on ``--device`` (seeded random
    weights, or ``--load_from``'s, NLSPN radius escalated where the probe
    needs it), and the sample (rgb, raw_depth)."""
    from ..config import default_config, load_config
    from ..engines import build_engine, resolve_device
    from ..ops.nlspn_guard import guard_loaded_engine
    from ..utils import set_random_seed
    from ..utils.checkpoint import load_checkpoint

    cfg = default_config()
    load_config(cfg, args.model_cfg_path)
    cfg.merge(dict(batch_size=args.batch_size, out_height=args.out_height,
                   out_width=args.out_width, num_classes=args.num_classes,
                   seed=args.seed, device=args.device))
    device = resolve_device(args.device)
    set_random_seed(args.seed)
    engine = build_engine(cfg, is_train=False)
    rgb, depth = sample_inputs(args.batch_size, args.out_height,
                               args.out_width, args.seed, device)
    if args.load_from:
        meta = load_checkpoint(engine.modules, args.load_from, print,
                               cfg=cfg)
        print(f"loaded {args.load_from} (epoch {meta.get('epoch')})")

        def rebuild():
            fresh = build_engine(cfg, is_train=False)
            load_checkpoint(fresh.modules, args.load_from, cfg=cfg)
            return fresh

        engine, max_offset, changed = guard_loaded_engine(
            cfg, engine, dict(rgb=rgb, raw_depth=depth), rebuild)
        if changed:
            g = cfg.model.G
            print(f"NLSPN max|offset|={max_offset:.2f}: rebuilt the "
                  f"generator with {g.get('nlspn_impl', 'auto')!r} impl, "
                  f"R={g.get('nlspn_offset_radius')}")
    return engine, rgb, depth


class ServedForward(torch.nn.Module):
    """``engine.forward_test(rgb, raw_depth, depth_only)`` as a module that
    holds the nets it reads (without G_label for ``depth_only``), so that
    export lifts exactly their parameters and buffers."""

    def __init__(self, engine, depth_only: bool = False):
        super().__init__()
        self.nets = torch.nn.ModuleDict({
            k: m for k, m in engine.modules.items()
            if not (depth_only and k == "G_label")})
        self.engine = engine
        self.depth_only = depth_only

    def forward(self, rgb: torch.Tensor, raw_depth: torch.Tensor) -> dict:
        return self.engine.forward_test(rgb=rgb, raw_depth=raw_depth,
                                        depth_only=self.depth_only)


def run(argv=None) -> dict:
    """Export (and ``--check``). Returns the engine, the sample inputs, the
    program, the file's path and size, the export's seconds and, with
    ``--check``, the max |pred_depth| difference."""
    args = parse_args(argv)
    engine, rgb, depth = build(args)
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(ServedForward(engine, args.depth_only),
                                 (rgb, depth))
    torch.export.save(ep, args.out)
    seconds = time.perf_counter() - t0
    size = os.path.getsize(args.out)
    print(f"exported {args.out}: {size / 1e6:.2f} MB in {seconds:.2f} s, "
          f"device={args.device}")
    out = dict(engine=engine, inputs=(rgb, depth), program=ep,
               path=args.out, bytes=size, seconds=seconds)
    if args.check:
        served = torch.export.load(args.out).module()
        with torch.no_grad():
            got = served(rgb, depth)["pred_depth"]
        want = engine.forward_test(rgb=rgb, raw_depth=depth,
                                   depth_only=args.depth_only)["pred_depth"]
        diff = float((got.float() - want.float()).abs().max())
        print(f"roundtrip check: max |pred_depth - live| = {diff:.3e}")
        torch.testing.assert_close(got, want, rtol=CHECK_RTOL,
                                   atol=CHECK_ATOL)
        print("roundtrip check OK: the loaded program matches the live "
              "engine's pred_depth")
        out["max_diff"] = diff
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
