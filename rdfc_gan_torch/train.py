"""Training entry point of the port (port of the repository's ``train.py``;
reference RDFC-GAN/train.py:1-189).

    python -m rdfc_gan_torch.train --dataset nyuv2 --data_root NYU \
        --model_cfg_path configs/rdf_cycle_patchgan_config.yaml --work_dir W \
        [--n_epochs N] [--batch_size 4] [--device cuda|cpu] \
        [--resume_from W/epoch_5.pth | --load_from six_nets.pth] \
        [--loader_backend thread|process] [--sample_interval 1000] \
        [--profile_dir P] [--deterministic]
    python -m rdfc_gan_torch.train --dataset synthetic \
        --model_cfg_path configs/rdf_gan_nlspn_config.yaml --work_dir W ...
    torchrun --nproc_per_node N -m rdfc_gan_torch.train ... --batch_size 4

Over N ranks (``torchrun``; ``parallel.init_distributed`` before the
loaders) each rank loads its shard of every epoch's order at
``--batch_size`` rows (a rank's batch, as each JAX device's), the state is
broadcast from rank 0 after any load, and each step is the step of the
global batch of N x batch_size rows (the engines' collectives). The logged
losses are summed over the ranks (their shares) and ``nlspn_max_offset``
is their max; rank 0 alone writes the log, ``config.yaml``, the
checkpoints (a barrier follows each), the sample grids and the trace.

Builds the shuffled, ``drop_last`` train loader (its order a pure function
of (seed, epoch); thread or process workers) and the padded val loader, the
engine on ``--device`` (default cuda, which raises without a card), then
runs the epoch loop: the loader's and the dataset's epoch set (the
per-sample augmentation draws are keyed by (seed, epoch, index));
``train_step`` per batch; the losses stay on the device until a log
boundary (every ``log_interval`` steps and at the end of each epoch), where
the whole window is read back in one transfer, averaged and logged with the
``nlspn_max_offset`` warning; every ``sample_interval`` steps the engine's
sample grids (RDFCGAN: ``save_samples``) of two fixed batches, the first
train batch and the first val batch, under ``work_dir/samples``; a
``torch.profiler`` Chrome trace of step 50 under ``profile_dir``; ``epoch_{n}.pth`` every ``save_interval`` epochs;
evaluation (``engine.forward_test``) every ``val_interval`` epochs from
``start_eval_epoch`` on, with ``best.pth`` on
``criterion_to_get_best_ckpt``. The engine is ``model.type``'s: the RDFGAN
(G and D) or the flagship RDFCGAN (six nets, four optimizers). Checkpoints
are the reference schema (``{net}_state_dict`` for every net, each
optimizer's and scheduler's state, ``meta`` {epoch, batch_size}), which
``python -m rdfc_gan_torch.test --load_from`` serves and ``--resume_from``
continues: the nets, optimizers, schedulers and the global step (the
per-step draws are seeded by it) are restored, so a resumed run gives the
straight run's checkpoint. ``--resume_from`` and ``--load_from`` also take
the JAX ``train.py``'s ``.ckpt`` (nets, optax states, step; told apart from
a ``.pth`` by its first bytes); what this driver trains goes to ``.pth``.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from .cli import parse_config
from .config import dump_config
from .data import DataLoader
from .engines import build_engine
from .evaluator import Eval
from .parallel import (all_reduce_max, all_reduce_sum, broadcast_from_rank0,
                       destroy, init_distributed, is_main, rank, world_size)
from .test import build_split, build_val_loader
from .utils import Logger, MovingAverage, set_random_seed
from .utils.checkpoint import load_checkpoint, resume_from, save_checkpoint
from .utils.profiling import StepTimer, trace

_MINIMIZE = ("RMSE", "MAE", "iRMSE", "iMAE", "REL")
_PROFILE_STEP = 50  # the traced step of --profile_dir (train.py:121)


def nlspn_radius(G) -> "int | None":
    """The stencil radius of G's NLSPN stage (a DCVGANGenerator's is its
    ``core``'s), or None without one (the vanilla v1 build has none)."""
    core = getattr(G, "core", G)
    if getattr(core, "use_nlspn_refine", False):
        return core.nlspn_offset_radius
    return None


def build_train_loader(cfg, device) -> DataLoader:
    """The shuffled, drop_last train loader of this rank's shard."""
    return DataLoader(build_split(cfg, "train"), cfg.batch_size,
                      device=device, num_workers=cfg.num_workers,
                      shuffle=True, drop_last=True, seed=cfg.seed,
                      worker_backend=cfg.get("loader_backend", "thread"),
                      rank=rank(), world=world_size())


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
        # a step that skips the G update (the v1 driver's n_critic) has no
        # G losses: a window's rows hold the keys of all its steps, and
        # each step's mean takes only the keys it has
        keys = sorted(set().union(*self.pending))
        zero = next(iter(self.pending[0].values())).new_zeros(())
        present = [[k in s for k in keys] for s in self.pending]
        rows = torch.stack([torch.stack([s.get(k, zero) for k in keys])
                            for s in self.pending])
        if world_size() > 1:
            # the ranks' loss shares add up to the global losses; the
            # offsets take their max
            is_max = torch.tensor([k == "nlspn_max_offset" for k in keys],
                                  device=rows.device)
            sums = all_reduce_sum(torch.where(is_max, 0.0, rows))
            rows = torch.where(is_max, all_reduce_max(rows.clone()), sums)
        rows = rows.cpu().tolist()
        for row, has in zip(rows, present):
            self.avg.update({k: v for k, v, h in zip(keys, row, has) if h})
        ips = (len(rows) * batch_size * world_size()
               / (time.perf_counter() - self.t0))
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
    device sync of its readback), the host seconds each step waited for
    its batch, the number of steps, the epoch it started from and the
    sample grids written. Over ranks every rank returns the same."""
    device, made = init_distributed(cfg)
    cfg.device = str(device)
    set_random_seed(cfg.seed, cfg.get("deterministic", False))
    logger = Logger(cfg.work_dir, filename="train.log")
    try:
        train_loader = build_train_loader(cfg, device)
        val_loader = build_val_loader(cfg, device,
                                      rows=(rank(), world_size()))
        try:
            return _train(cfg, logger, device, train_loader, val_loader)
        finally:
            train_loader.close()
            val_loader.close()
    finally:
        logger.close()
        destroy(made)


def _train(cfg, logger, device, train_loader, val_loader) -> dict:
    engine = build_engine(cfg, is_train=True,
                          steps_per_epoch=len(train_loader))
    logger.log(f"device {device}, rank {rank()} of {world_size()}, train "
               f"batches/epoch {len(train_loader)}, compute dtype "
               f"{engine.compute_dtype or torch.float32}, "
               f"loader {train_loader.worker_backend}")
    # fixed train + val batches for the sample grids (train.py:85-87)
    vis_batches = {}
    if hasattr(engine, "save_samples"):
        vis_batches = {"train": next(iter(train_loader)),
                       "test": next(iter(val_loader))}
    start_epoch = cfg.epoch
    if cfg.resume_from:
        start_epoch = resume_from(engine, cfg.resume_from)
        logger.log(f"resumed from {cfg.resume_from} at epoch {start_epoch}")
    elif cfg.load_from:
        meta = load_checkpoint(engine.modules, cfg.load_from, cfg=cfg)
        logger.log(f"loaded {cfg.load_from} (epoch {meta.get('epoch')})")
    # replicate_state (train.py:89): every rank starts from rank 0's nets
    broadcast_from_rank0([t for m in engine.modules.values()
                          for t in (*m.parameters(), *m.buffers())])
    if is_main():
        os.makedirs(cfg.work_dir, exist_ok=True)
        dump_config(cfg, os.path.join(cfg.work_dir, "config.yaml"))

    # the NLSPN generator: the RDFGAN's G or the flagship's G_A2B
    G = engine.modules.get("G", engine.modules.get("G_A2B"))
    radius = nlspn_radius(G)
    losses = _LossLog(cfg, logger, radius)
    evaluator = Eval(val_loader)
    minimize = cfg.criterion_to_get_best_ckpt in _MINIMIZE
    best = float("inf") if minimize else float("-inf")
    metrics = None
    step_seconds, wait_seconds, samples = [], [], []
    timer = StepTimer()
    profile_dir = cfg.get("profile_dir") if is_main() else None

    def checkpoint(name, **meta):
        save_checkpoint(engine.modules, os.path.join(cfg.work_dir, name),
                        meta=dict(batch_size=cfg.batch_size, **meta),
                        train_state=engine.train_state())

    # the global step continues across --resume_from: the per-step draws
    # are seeded by it, so a resumed run replays the straight run's
    it = start = start_epoch * len(train_loader)
    for epoch in range(start_epoch, cfg.n_epochs):
        train_loader.set_epoch(epoch)
        if hasattr(train_loader.dataset, "set_epoch"):
            train_loader.dataset.set_epoch(epoch)
        t_prev = time.perf_counter()
        i = -1
        for i, batch in enumerate(train_loader):
            with trace(profile_dir if it == _PROFILE_STEP else None):
                losses.add(engine.train_step(batch))
            timer.tick()
            it += 1
            if it % cfg.log_interval == 0:
                losses.flush(epoch, i, cfg.batch_size)
            if it % cfg.sample_interval == 0 and is_main():
                for split, vb in vis_batches.items():
                    samples.append(engine.save_samples(
                        vb, os.path.join(cfg.work_dir, "samples"), it,
                        prefix=f"sample-{split}"))
            t = time.perf_counter()
            step_seconds.append(t - t_prev)
            t_prev = t
        wait_seconds += train_loader.wait_seconds
        # the trailing partial window is logged too
        losses.flush(epoch, i, cfg.batch_size)
        logger.log(f"epoch {epoch}: step mean {timer.mean_ms:.1f} ms, max "
                   f"{timer.max_ms:.1f} ms (last {len(timer.times)})")

        if (epoch + 1) % cfg.save_interval == 0:
            checkpoint(f"epoch_{epoch + 1}.pth", epoch=epoch + 1)
        if ((epoch + 1) % cfg.val_interval == 0
                and epoch + 1 >= cfg.start_eval_epoch):
            metrics = evaluator.evaluate(engine, logger)
            crit = metrics[cfg.criterion_to_get_best_ckpt]
            if crit < best if minimize else crit > best:
                best = crit
                checkpoint("best.pth", epoch=epoch + 1, best=best)
                logger.log(f"new best {cfg.criterion_to_get_best_ckpt}: "
                           f"{best}")
    return dict(engine=engine, metrics=metrics, best=best,
                losses=losses.avg.mean(), step_seconds=step_seconds,
                wait_seconds=wait_seconds, steps=it - start,
                start_epoch=start_epoch, samples=samples)


def main(argv=None) -> int:
    run(parse_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
