"""The v1 (RDF-GAN, CVPR 2022) train / evaluate / FPS driver of the port
(port of tools/main_v1.py; reference RDF-GAN/lib/tools/main.py:25-653).

    python -m rdfc_gan_torch.tools.main_v1 --dataset nyuv2_s2d \\
        --data_root S2D --use_guidance --use_nlspn_to_refine --work_dir W \\
        [--inference | --cal_fps] [--load_from W/epoch_10.pth] \\
        [--device cuda|cpu]
    python -m rdfc_gan_torch.tools.main_vanilla ...   (--model vanilla)

The RDFGAN engine with the v1 generator (``DCVGANGenerator``: the
ESANetOneModality guidance net feeding an RDFGenerator core, or with
``--model vanilla`` the ``DCVGANGeneratorVanilla`` build) and the PatchGAN
D. Each step updates D, then G only where ``it % n_critic == 0``
(main.py:492-575); ``epoch_{n}.pth`` every ``--save_interval`` epochs and
an ``EvalV1`` evaluation (predictions resized back to the ground truth's
origin size) every ``--val_interval``. ``--inference`` evaluates and exits;
``--cal_fps`` runs ``rdfc_gan_torch.test.cal_fps`` (300 images after 5
warm-up forwards) and exits. ``--resume_from`` continues from a
checkpoint this driver or the JAX driver wrote (nets, optimizers,
schedulers, global step); ``--load_from`` loads the nets of a ``.pth`` or
of the JAX driver's ``.ckpt`` (told apart by their first bytes,
``utils.checkpoint``). This driver writes ``.pth``.

Every flag of the JAX driver's ``build_parser`` is here with its default,
aliases and choices, plus ``--device`` (cuda by default, which raises
without a card; cpu only when asked for). Two JAX defaults stay: the
guidance net and NLSPN are off unless ``--use_guidance`` and
``--use_nlspn_to_refine`` are given, and ``--fuse_depth_in_rgb_decoder``
is ``AdaIN`` (no instance-norm kernel) for the guided model too. Flags the
JAX driver accepts and never reads are accepted and left unread here too.
The model's compute type is the framework default's (bf16 on the card,
f32 on the CPU).

Over N ranks (``torchrun``) each rank loads its shard of the train order,
the step is that of the global batch (the engine's collectives), the
evaluation gathers the ranks' results, and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..cli import _device
from ..config import Config, default_config

UNREAD = "accepted as by the JAX driver, which never reads it"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("rdf-gan v1 driver")
    add = p.add_argument
    add("--dataset", default="nyuv2_s2d",
        choices=["nyuv2_s2d", "nyuv2", "sunrgbd", "ddrnet_human", "synthetic"])
    add("--data_root", default=None)
    add("--height", type=int, default=None)
    add("--width", type=int, default=None)
    add("--num_classes", type=int, default=40)
    add("--batch_size", type=int, default=4)
    add("--lr", type=float, default=2e-3)
    add("--beta1", type=float, default=0.5)
    add("--beta2", type=float, default=0.999)
    add("--n_epochs", type=int, default=150)
    add("--optimizer", default="Adam")
    add("--scheduler", default="linear",
        choices=["linear", "step", "cosine", "onecycle", "lambda"])
    add("--decay_epoch", type=int, default=100)
    # scheduler knobs (RDF-GAN/lib/tools/main.py:251-294)
    add("--lr_decay_epochs", type=int, nargs="+", default=[60, 90, 120])
    add("--lr_decay_rate", type=float, default=0.1)
    add("--div_factor", type=float, default=25.0)
    add("--pct_start", type=float, default=0.3)
    add("--t_max", type=int, default=None)
    add("--lambda_lr_decay", type=int, nargs="+", default=[30, 60, 90])
    add("--lambda_lr_gamma", type=float, nargs="+", default=[1.0, 0.5, 0.1])
    add("--gan_loss_type", default="lsgan",
        choices=["lsgan", "vanilla", "wgan", "wgangp"])
    add("--n_critic", type=int, default=1)
    add("--wgan_clip_value", type=float, default=0.01)
    add("--warm_up", action="store_true")
    add("--warm_up_lr", type=float, default=1e-6)
    add("--warm_up_steps", type=int, default=1)
    # guidance and NLSPN (RDF-GAN/lib/tools/config.py)
    add("--use_guidance", action="store_true", default=False)
    add("--guidance_classes", type=int, default=40)
    add("--guidance_encoder", default="resnet18")
    add("--guidance_encoder_block", default="BasicBlock")
    add("--guidance_channels_decoder", type=int, nargs="+",
        default=[128, 128, 128])
    add("--guidance_nr_decoder_blocks", type=int, nargs="+",
        default=[1, 1, 1])
    add("--guidance_encoder_decoder_fusion", default="add")
    add("--guidance_context_module", default="ppm")
    add("--guidance_weighting_in_encoder", default="SE-add")
    add("--guidance_upsampling", default="learned-3x3-zeropad")
    add("--guidance_pretrained_dir", default=None, help=UNREAD)
    add("--semantic_channels_in", type=int, default=3)
    add("--encoder_rgb", default="resnet18")
    add("--encoder_depth", default="resnet18")
    add("--encoder_block", default="BasicBlock")
    add("--rgb_channels_encoder", type=int, nargs="+",
        default=[64, 64, 128, 256, 512, 512])
    add("--depth_channels_encoder", type=int, nargs="+",
        default=[64, 64, 128, 256, 512, 512])
    add("--rgb_channels_decoder", type=int, nargs="+",
        default=[256, 128, 64, 64])
    add("--depth_channels_decoder", type=int, nargs="+",
        default=[256, 128, 64, 64])
    add("--rgb_encoder_decoder_fusion", default="concat")
    add("--depth_encoder_decoder_fusion", default="concat")
    add("--activation", default="LeakyReLU")
    add("--norm_layer_type", default="IN2d")
    add("--use_nlspn_to_refine", action="store_true", default=False)
    add("--prop_kernel", type=int, default=3)
    add("--prop_time", type=int, default=18)
    add("--affinity", default="TGASS", choices=["AS", "ASS", "TC", "TGASS"])
    add("--affinity_gamma", type=float, default=0.5)
    add("--conf_prop", action="store_true", default=True)
    add("--no_conf", action="store_true", default=False)
    add("--preserve_input", action="store_true", default=False)
    add("--disc_norm_type", default="BN2d")
    add("--disc_act_type", default="LeakyReLU")
    # the reference parses but never uses the l2 coefficients and the
    # encoder-decoder warm-start flags (main.py:558-563 uses l1 only; the
    # load_encoder_decoder path is commented out, main.py:48)
    add("--use_pretrained_encoder_decoder", action="store_true", help=UNREAD)
    add("--load_encoder_decoder_path", default=None, help=UNREAD)
    add("--freeze_encoder_decoder", action="store_true", help=UNREAD)
    add("--rgb_branch_l2_loss_coef", type=float, default=0.0, help=UNREAD)
    add("--depth_branch_l2_loss_coef", type=float, default=0.0, help=UNREAD)
    add("--final_l2_loss_coef", type=float, default=0.0, help=UNREAD)
    add("--generator_l1_loss_coef", type=float, default=1.0)
    add("--momentum", type=float, default=0.9)
    add("--weight_decay", type=float, default=0.0)
    add("--repeat_times", type=int, default=20)
    add("--num_workers", type=int, default=8)
    add("--pretrained_on_imagenet", action="store_true", default=False)
    add("--pretrained_resnet_path", default=None)
    add("--init_disc", action="store_true", default=False)
    add("--sample_interval", type=int, default=1000, help=UNREAD)
    add("--sample_dir", default="./")
    add("--gpus", default="0", help=UNREAD + "; the card is --device's")
    add("--start_epoch", type=int, default=0)
    # reference aliases
    add("--max_epoch", type=int, default=None,
        help="alias of --n_epochs (reference name)")
    add("--learning_rate", type=float, default=None,
        help="alias of --lr (reference name)")
    add("--rgb_branch_l1_loss_coef", type=float, default=None,
        help="alias of --lambda_l1_rgb_branch")
    add("--depth_branch_l1_loss_coef", type=float, default=None,
        help="alias of --lambda_l1_depth_branch")
    add("--final_l1_loss_coef", type=float, default=None,
        help="alias of --lambda_l1_fusion")
    add("--lambda_l1_rgb_branch", type=float, default=100.0)
    add("--lambda_l1_depth_branch", type=float, default=100.0)
    add("--lambda_l1_fusion", type=float, default=100.0)
    add("--work_dir", required=True)
    add("--load_from", default=None)
    add("--resume_from", default=None)
    add("--log_interval", type=int, default=30)
    add("--save_interval", type=int, default=10)
    add("--val_interval", type=int, default=1)
    add("--seed", type=int, default=0)
    add("--inference", action="store_true")
    add("--cal_fps", action="store_true")
    # --model vanilla drives the vanilla generator build (the reference's
    # missing main_vanilla.py driver, bash/test_nyuv2_Rs2T.sh:4)
    add("--model", default="guided", choices=["guided", "vanilla"])
    add("--upsampling_mode", default="bilinear")
    add("--nr_decoder_blocks", type=int, nargs="+", default=[1, 1, 1, 0, 0])
    add("--fuse_depth_in_rgb_decoder", default="AdaIN")
    add("--adain_weighting", action="store_true", default=False)
    add("--device", type=_device, default="cuda",
        help="cuda (default; cuda:LOCAL_RANK under torchrun) raises when "
             "no card is present; cuda:N takes card N as given; cpu only "
             "when asked for")
    return p


def make_cfg(args) -> Config:
    """The framework defaults, the parsed flags (aliases resolved) and the
    v1 model (main_v1.py:157-228)."""
    if args.max_epoch is not None:
        args.n_epochs = args.max_epoch
    if args.learning_rate is not None:
        args.lr = args.learning_rate
    if args.rgb_branch_l1_loss_coef is not None:
        args.lambda_l1_rgb_branch = args.rgb_branch_l1_loss_coef
    if args.depth_branch_l1_loss_coef is not None:
        args.lambda_l1_depth_branch = args.depth_branch_l1_loss_coef
    if args.final_l1_loss_coef is not None:
        args.lambda_l1_fusion = args.final_l1_loss_coef
    if args.no_conf:
        args.conf_prop = False

    cfg = default_config()
    cfg.merge(vars(args))
    if args.model == "vanilla":
        g_cfg = {
            "type": "DCVGANGeneratorVanilla",
            "use_guidance": args.use_guidance,
            "guidance_classes": args.guidance_classes,
            "nr_decoder_blocks": list(args.nr_decoder_blocks),
            "fuse_depth_in_rgb_decoder": args.fuse_depth_in_rgb_decoder,
            "upsampling_mode": args.upsampling_mode,
            "adain_weighting": args.adain_weighting,
        }
    else:
        g_cfg = {
            "type": "DCVGANGenerator",
            "use_guidance": args.use_guidance,
            "guidance_classes": args.guidance_classes,
            "guidance_encoder": args.guidance_encoder,
            "guidance_channels_decoder": list(args.guidance_channels_decoder),
            "guidance_nr_decoder_blocks": list(
                args.guidance_nr_decoder_blocks),
            "guidance_encoder_decoder_fusion":
                args.guidance_encoder_decoder_fusion,
            "guidance_context_module": args.guidance_context_module,
            "guidance_weighting_in_encoder":
                args.guidance_weighting_in_encoder,
            "guidance_upsampling": args.guidance_upsampling,
            "encoder_rgb": args.encoder_rgb,
            "encoder_depth": args.encoder_depth,
            "rgb_channels_encoder": list(args.rgb_channels_encoder),
            "depth_channels_encoder": list(args.depth_channels_encoder),
            "rgb_channels_decoder": list(args.rgb_channels_decoder),
            "depth_channels_decoder": list(args.depth_channels_decoder),
            "fuse_depth_in_rgb_decoder": args.fuse_depth_in_rgb_decoder,
            "adain_weighting": args.adain_weighting,
            # the reference's NLSPNIdentity unless --use_nlspn_to_refine
            # (every shipped recipe passes it)
            "use_nlspn_refine": args.use_nlspn_to_refine,
            "nlspn_configs": {
                "prop_kernel": args.prop_kernel,
                "prop_time": args.prop_time,
                "affinity": args.affinity,
                "affinity_gamma": args.affinity_gamma,
                "conf_prop": args.conf_prop,
                "preserve_input": args.preserve_input,
            },
        }
    cfg.merge({"model": {
        "type": "RDFGAN", "G": g_cfg,
        "D": {"type": "PatchGANDiscriminator", "in_channels": 1,
              "activation": "LeakyReLU"}}})
    return cfg


def build_datasets(cfg):
    """The train and val splits of ``cfg.dataset`` (main_v1.py:248-258):
    ``synthetic`` at --height x --width (32 each by default) with
    --num_classes, ``ddrnet_human`` repeated --repeat_times."""
    from .. import data  # noqa: F401  (registers the datasets)
    from ..registry import build_dataset

    kw = dict(seed=cfg.seed)
    if cfg.data_root:
        kw["data_root"] = cfg.data_root
    if cfg.dataset == "synthetic":
        kw.update(height=cfg.height or 32, width=cfg.width or 32,
                  num_classes=cfg.num_classes)
    if cfg.dataset == "ddrnet_human":
        kw["times"] = cfg.repeat_times
    return tuple(build_dataset(dict(type=cfg.dataset, mode=mode, **kw))
                 for mode in ("train", "val"))


def run(cfg) -> dict:
    """Train, evaluate (``cfg.inference``) or time (``cfg.cal_fps``) the v1
    model. Returns the engine, the metrics of the last evaluation, the FPS,
    the last logged window's mean losses, the host seconds of each step,
    the number of steps and of G updates, and the val loader."""
    from ..parallel import destroy, init_distributed

    device, made = init_distributed(cfg)
    cfg.device = str(device)
    try:
        return _run(cfg, device)
    finally:
        destroy(made)


def _run(cfg, device) -> dict:
    from ..data import DataLoader
    from ..engines import build_engine
    from ..evaluator import EvalV1
    from ..parallel import broadcast_from_rank0, is_main, rank, world_size
    from ..test import cal_fps
    from ..train import nlspn_radius
    from ..utils import Logger, set_random_seed
    from ..utils.checkpoint import load_checkpoint, resume_from

    set_random_seed(cfg.seed, cfg.get("deterministic", False))
    logger = Logger(cfg.work_dir)
    train_ds, val_ds = build_datasets(cfg)
    shard = dict(rank=rank(), world=world_size())
    train_loader = DataLoader(train_ds, cfg.batch_size, device=device,
                              num_workers=cfg.num_workers, shuffle=True,
                              drop_last=True, seed=cfg.seed, **shard)
    val_loader = DataLoader(val_ds, cfg.batch_size, device=device,
                            num_workers=cfg.num_workers, **shard)
    training = not (cfg.inference or cfg.cal_fps)
    out = dict(val_loader=val_loader)
    try:
        engine = build_engine(cfg, is_train=training,
                              steps_per_epoch=max(len(train_loader), 1))
        out["engine"] = engine
        start_epoch = 0
        if cfg.resume_from:
            start_epoch = resume_from(engine, cfg.resume_from)
            logger.log(f"resumed from {cfg.resume_from} at epoch "
                       f"{start_epoch}")
        elif cfg.load_from:
            meta = load_checkpoint(engine.modules, cfg.load_from, logger.log,
                                   cfg=cfg)
            logger.log(f"loaded {cfg.load_from} (epoch {meta.get('epoch')})")
        broadcast_from_rank0([t for m in engine.modules.values()
                              for t in (*m.parameters(), *m.buffers())])
        evaluator = EvalV1(val_loader)
        if cfg.cal_fps:
            if is_main():
                out["fps"] = cal_fps(engine, val_loader, logger=logger)
            return out
        if cfg.inference:
            out["metrics"] = evaluator.evaluate(engine, logger)
            return out
        out.update(_train(cfg, engine, train_loader, evaluator, logger,
                          start_epoch, nlspn_radius(engine.modules["G"])))
        return out
    finally:
        train_loader.close()
        val_loader.close()
        logger.close()


def _train(cfg, engine, train_loader, evaluator, logger, start_epoch,
           radius) -> dict:
    from ..train import _LossLog
    from ..utils.checkpoint import save_checkpoint

    losses = _LossLog(cfg, logger, radius)
    n_critic = max(int(cfg.n_critic), 1)
    metrics, step_seconds, g_updates = None, [], 0
    it = start = start_epoch * len(train_loader)
    for epoch in range(start_epoch, cfg.n_epochs):
        train_loader.set_epoch(epoch)
        if hasattr(train_loader.dataset, "set_epoch"):
            train_loader.dataset.set_epoch(epoch)
        t_prev, i = time.perf_counter(), -1
        for i, batch in enumerate(train_loader):
            update_g = it % n_critic == 0
            losses.add(engine.train_step(batch, update_g=update_g))
            g_updates += update_g
            it += 1
            if it % cfg.log_interval == 0:
                losses.flush(epoch, i, cfg.batch_size)
            t = time.perf_counter()
            step_seconds.append(t - t_prev)
            t_prev = t
        losses.flush(epoch, i, cfg.batch_size)
        if (epoch + 1) % cfg.save_interval == 0:
            save_checkpoint(
                engine.modules,
                os.path.join(cfg.work_dir, f"epoch_{epoch + 1}.pth"),
                meta=dict(epoch=epoch + 1, batch_size=cfg.batch_size),
                train_state=engine.train_state())
        if (epoch + 1) % cfg.val_interval == 0:
            metrics = evaluator.evaluate(engine, logger)
    return dict(metrics=metrics, losses=losses.avg.mean(),
                step_seconds=step_seconds, steps=it - start,
                g_updates=g_updates)


def parse_cfg(argv=None) -> Config:
    return make_cfg(build_parser().parse_args(argv))


def main(argv=None) -> int:
    run(parse_cfg(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
