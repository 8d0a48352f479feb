"""Evaluation driver of the port (port of the repository's ``test.py``;
reference RDFC-GAN/test.py:1-92).

    python -m rdfc_gan_torch.test --dataset synthetic \\
        --model_cfg_path configs/rdf_gan_nlspn_config.yaml --work_dir work/t \\
        [--load_from G.pth] [--cal_fps] [--device cuda|cpu]
    python -m rdfc_gan_torch.test --dataset synthetic \\
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml \\
        --work_dir work/f [--depth_only] [--cal_fps] [--load_from x.pth]
    python -m rdfc_gan_torch.test --dataset nyuv2 --data_root NYU \\
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml \\
        --work_dir work/n --load_from W/best.pth

Builds the engine of ``model.type`` (RDFGAN, or the flagship RDFCGAN) on
``--device`` (default cuda, which raises without a card) and the val split
of ``--dataset`` (a file dataset needs ``--data_root``), optionally loads
a reference ``.pth`` or a JAX driver's ``.ckpt`` (the nets the engine
has; the others are logged as left unread; the format is told by the
file's first bytes), runs the val split through ``forward_test`` and
prints the 8 depth metrics. ``--depth_only`` skips the RDFCGAN's G_label, whose labels
pred_depth never reads. After a load, one probe batch checks an RDFGAN's
NLSPN offsets against the stencil radius and rebuilds the generator with a
larger radius or the gather path when needed.
``--cal_fps`` runs the FPS harness instead (RDF-GAN/lib/tools/main.py:
318-350): 300 images after 5 warm-up forwards, each bracketed by a device
synchronize.

Over N ranks (``torchrun``), as the JAX ``test.py:74-80`` shards its
batch over the mesh: where N divides ``--batch_size`` each rank serves its
shard of the split at batch_size / N and the evaluator gathers the rows;
otherwise every rank serves the whole split. Every rank probes its first
batch and all take the max offset, so all rebuild alike. ``--cal_fps``
runs on rank 0 alone, unsharded; rank 0 alone writes the log.

Width-sharded serving (the JAX ``spatial_sharding``): a ``mesh_shape``
``{"data": D, "model": M}`` in the model config, D x M ranks. The rows go
over the D data rows as above over N, and every image's width over the M
ranks of its row (``parallel.spatial``; M must divide W); each batch's
predictions are assembled in the row before the metrics, which are those of
one rank serving alone:

    torchrun --nproc_per_node 4 -m rdfc_gan_torch.test \\
        --model_cfg_path sharded.yaml ...   # its mesh_shape:
                                            #   {data: 2, model: 2}
"""

from __future__ import annotations

import sys

from .cli import parse_config
from .data import DataLoader
from .engines import build_engine
from .evaluator import Eval
from .ops.nlspn_guard import guard_loaded_engine
from .parallel import (broadcast_from_rank0, destroy, init_distributed,
                       is_main, rank, world_size)
from .parallel.dist import mesh_axes
from .parallel.grid import make_grid
from .registry import build_dataset
from .utils import Logger, set_random_seed
from .utils.checkpoint import load_checkpoint
from .utils.profiling import fps_harness


def cal_fps(engine, loader, n_images: int = 300, warmup: int = 5,
            logger=None, depth_only: bool = False) -> float:
    """img/s served: ``utils.profiling.fps_harness`` over ``forward_test``."""
    fps = fps_harness(
        lambda b: engine.forward_test(rgb=b["rgb"], raw_depth=b["raw_depth"],
                                      depth_only=depth_only),
        loader, n_images=n_images, warmup=warmup)
    (logger.log if logger else print)(
        f"FPS: {fps:.2f} ({n_images} imgs after {warmup} warm-up forwards)")
    return fps


def build_split(cfg, mode: str):
    """The ``mode`` ("train" or "val") split of ``cfg.dataset``: the
    synthetic set at (out_height, out_width), or a file dataset (``nyuv2``,
    ``nyuv2_sparse``, ``nyuv2_pseudo``, ``nyuv2_raw``, ``sunrgbd``,
    ``nyuv2_s2d``, ``nyuv2_r2r``, ``ddrnet_human``, ``cleargrasp``,
    ``thuman``) under ``data_root`` (train.py:36-43), which raises without
    one."""
    from . import data  # noqa: F401  (registers the datasets)

    common = dict(num_classes=cfg.num_classes, seed=cfg.seed)
    ds_kwargs = dict(data_root=cfg.data_root, **common)
    if cfg.dataset == "synthetic":
        ds_kwargs = dict(height=cfg.out_height, width=cfg.out_width, **common)
    return build_dataset(dict(type=cfg.dataset, mode=mode, **ds_kwargs))


def build_val_loader(cfg, device, batch_size=None,
                     rows=(0, 1)) -> DataLoader:
    """The val split in order, padded to whole batches of ``batch_size``
    (default ``cfg.batch_size``); ``rows`` (index, count): that shard of
    it, (rank, world size) for this rank's."""
    return DataLoader(build_split(cfg, "val"), batch_size or cfg.batch_size,
                      device=device, num_workers=cfg.num_workers,
                      rank=rows[0], world=rows[1])


def run(cfg) -> dict:
    """Serve ``cfg``. Returns the metrics (or the FPS, rank 0 only), the
    engine, the loader, the per-batch seconds and the number of generator
    forwards."""
    device, made = init_distributed(cfg)
    cfg.device = str(device)
    try:
        return _serve(cfg)
    finally:
        destroy(made)


def _serve(cfg) -> dict:
    set_random_seed(cfg.seed, cfg.get("deterministic", False))
    logger = Logger(cfg.work_dir)
    engine = build_engine(cfg, is_train=False)
    # rows over the ranks, or over the data rows of a grid whose model axis
    # shards the width
    grid = None
    rows = (rank(), world_size())
    if mesh_axes(cfg.get("mesh_shape"), world_size())[1] > 1:
        grid = make_grid(cfg.get("mesh_shape"))
        rows = (grid.d, grid.D)
    if rows[1] > 1 and cfg.batch_size % rows[1] == 0:
        loader = build_val_loader(cfg, engine.device,
                                  cfg.batch_size // rows[1], rows=rows)
    else:
        loader = build_val_loader(cfg, engine.device)
    forwards = 0
    max_offset = None
    if cfg.load_from:
        meta = load_checkpoint(engine.modules, cfg.load_from, logger.log,
                               cfg=cfg)
        logger.log(f"loaded {cfg.load_from} (epoch {meta.get('epoch')})")

        def rebuild():
            fresh = build_engine(cfg, is_train=False)
            load_checkpoint(fresh.modules, cfg.load_from, cfg=cfg)
            return fresh

        probed = engine
        engine, max_offset, changed = guard_loaded_engine(
            cfg, engine, next(iter(loader)), rebuild)
        if changed:
            g = cfg.model.G
            logger.log(f"NLSPN max|offset|={max_offset:.2f}: rebuilt the "
                       f"generator with {g.get('nlspn_impl', 'auto')!r} "
                       f"impl, R={g.get('nlspn_offset_radius')}")
            forwards += probed.n_forward  # the probe's, on the old engine
    broadcast_from_rank0([t for m in engine.modules.values()
                          for t in (*m.parameters(), *m.buffers())])

    out = dict(engine=engine, loader=loader, max_offset=max_offset)
    depth_only = bool(cfg.get("depth_only", False))
    if cfg.cal_fps:
        if is_main():
            out["fps"] = cal_fps(engine, loader, logger=logger,
                                 depth_only=depth_only)
    else:
        evaluator = Eval(loader, depth_only=depth_only, grid=grid)
        out["metrics"] = evaluator.evaluate(engine, logger)
        out["batch_seconds"] = evaluator.batch_seconds
    out["forwards"] = forwards + engine.n_forward
    logger.close()
    return out


def main(argv=None) -> int:
    run(parse_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
