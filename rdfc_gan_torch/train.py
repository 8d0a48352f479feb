"""Training entry point of the port (port of the repository's ``train.py``;
reference RDFC-GAN/train.py:1-189).

    python -m rdfc_gan_torch.train --dataset synthetic \\
        --model_cfg_path configs/rdf_gan_nlspn_config.yaml --work_dir W \\
        [--n_epochs N] [--batch_size 4] [--out_height 224 --out_width 304] \\
        [--device cuda|cpu] [--load_from G_and_D.pth]
    python -m rdfc_gan_torch.train --dataset synthetic \\
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml --work_dir W \\
        [--device cuda|cpu] [--load_from six_nets.pth]

Builds the shuffled, ``drop_last`` train loader (its order a pure function
of (seed, epoch)) and the padded val loader, the engine on ``--device``
(default cuda, which raises without a card), then runs the epoch loop:
``train_step`` per batch; the losses stay on the device until a log
boundary (every ``log_interval`` steps and at the end of each epoch), where
the whole window is read back in one transfer, averaged and logged with the
``nlspn_max_offset`` warning; ``epoch_{n}.pth`` every ``save_interval``
epochs; evaluation (``engine.forward_test``) every ``val_interval`` epochs
from ``start_eval_epoch`` on, with ``best.pth`` on
``criterion_to_get_best_ckpt``. The engine is ``model.type``'s: the RDFGAN
(G and D) or the flagship RDFCGAN (six nets, four optimizers). Checkpoints
are the reference schema (``{net}_state_dict`` for every net and
``meta``), which ``python -m rdfc_gan_torch.test --load_from`` serves.
Sample dumps, resume and optimizer state are not ported yet.
"""

from __future__ import annotations

import os
import sys
import time

import torch
import yaml

from .cli import parse_config
from .data import DataLoader
from .engines import build_engine, resolve_device
from .evaluator import Eval
from .test import build_split, build_val_loader
from .utils import Logger, MovingAverage, set_random_seed
from .utils.checkpoint import load_checkpoint, save_checkpoint

_MINIMIZE = ("RMSE", "MAE", "iRMSE", "iMAE", "REL")


def build_train_loader(cfg, device) -> DataLoader:
    return DataLoader(build_split(cfg, "train"), cfg.batch_size,
                      device=device, num_workers=cfg.num_workers,
                      shuffle=True, drop_last=True, seed=cfg.seed)


class _LossLog:
    """Loss dicts of device scalars, kept on the device and read back one
    window at a time."""

    def __init__(self, cfg, logger, radius):
        self.cfg, self.logger, self.radius = cfg, logger, radius
        self.avg = MovingAverage(window=cfg.log_interval)
        self.pending = []
        self.t0 = time.perf_counter()

    def add(self, stats):
        self.pending.append(stats)

    def flush(self, epoch: int, i: int, batch_size: int):
        if not self.pending:
            return
        keys = sorted(self.pending[0])
        rows = torch.stack([torch.stack([s[k] for k in keys])
                            for s in self.pending]).cpu().tolist()
        for row in rows:
            self.avg.update(dict(zip(keys, row)))
        ips = len(rows) * batch_size / (time.perf_counter() - self.t0)
        self.pending.clear()
        m = self.avg.mean()
        if self.radius is not None and m.get("nlspn_max_offset",
                                             0.0) > self.radius:
            self.logger.log(
                f"WARNING: NLSPN max|offset| {m['nlspn_max_offset']:.2f} "
                f"exceeds stencil radius {self.radius}; training gradients "
                f"are clamped: raise nlspn_offset_radius or set nlspn_impl: "
                f"gather (ops/nlspn_guard.py)")
        msg = " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items()))
        self.logger.log(f"epoch {epoch} iter {i} ({ips:.1f} img/s) {msg}")
        self.t0 = time.perf_counter()


def run(cfg) -> dict:
    """Train ``cfg``. Returns the engine, the last evaluation's metrics,
    the best criterion, the last logged window's mean losses, the host
    seconds of each step (a step that ends at a log boundary includes the
    device sync of its readback) and the number of steps."""
    if cfg.resume_from:
        raise NotImplementedError("--resume_from: resume and optimizer "
                                  "state are not ported yet")
    set_random_seed(cfg.seed)
    logger = Logger(cfg.work_dir, filename="train.log")
    device = resolve_device(cfg.get("device", "cuda"))
    train_loader = build_train_loader(cfg, device)
    val_loader = build_val_loader(cfg, device)
    engine = build_engine(cfg, is_train=True,
                          steps_per_epoch=len(train_loader))
    logger.log(f"device {device}, train batches/epoch {len(train_loader)}, "
               f"compute dtype {engine.compute_dtype or torch.float32}")
    if cfg.load_from:
        meta = load_checkpoint(engine.modules, cfg.load_from)
        logger.log(f"loaded {cfg.load_from} (epoch {meta.get('epoch')})")
    os.makedirs(cfg.work_dir, exist_ok=True)
    with open(os.path.join(cfg.work_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)

    # the NLSPN generator: the RDFGAN's G or the flagship's G_A2B
    G = engine.modules.get("G", engine.modules.get("G_A2B"))
    radius = G.nlspn_offset_radius if G.use_nlspn_refine else None
    losses = _LossLog(cfg, logger, radius)
    evaluator = Eval(val_loader)
    minimize = cfg.criterion_to_get_best_ckpt in _MINIMIZE
    best = float("inf") if minimize else float("-inf")
    metrics = None
    step_seconds = []
    it = start = cfg.epoch * len(train_loader)
    for epoch in range(cfg.epoch, cfg.n_epochs):
        train_loader.set_epoch(epoch)
        t_prev = time.perf_counter()
        i = -1
        for i, batch in enumerate(train_loader):
            losses.add(engine.train_step(batch))
            it += 1
            if it % cfg.log_interval == 0:
                losses.flush(epoch, i, cfg.batch_size)
            t = time.perf_counter()
            step_seconds.append(t - t_prev)
            t_prev = t
        # the trailing partial window is logged too
        losses.flush(epoch, i, cfg.batch_size)

        if (epoch + 1) % cfg.save_interval == 0:
            save_checkpoint(engine.modules,
                            os.path.join(cfg.work_dir,
                                         f"epoch_{epoch + 1}.pth"),
                            meta=dict(epoch=epoch + 1))
        if ((epoch + 1) % cfg.val_interval == 0
                and epoch + 1 >= cfg.start_eval_epoch):
            metrics = evaluator.evaluate(engine, logger)
            crit = metrics[cfg.criterion_to_get_best_ckpt]
            if crit < best if minimize else crit > best:
                best = crit
                save_checkpoint(engine.modules,
                                os.path.join(cfg.work_dir, "best.pth"),
                                meta=dict(epoch=epoch + 1, best=best))
                logger.log(f"new best {cfg.criterion_to_get_best_ckpt}: "
                           f"{best}")
    logger.close()
    return dict(engine=engine, metrics=metrics, best=best,
                losses=losses.avg.mean(), step_seconds=step_seconds,
                steps=it - start)


def main(argv=None) -> int:
    run(parse_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
