"""CLI argument surface — parity with RDFC-GAN/config.py:5-123.

Same flags, same defaults; parsing is explicit (no import-time side effects).
"""

from __future__ import annotations

import argparse

from .config import Config, default_config, load_config


def _device(name: str) -> str:
    """cuda, cuda:N or cpu."""
    head, _, index = name.partition(":")
    if name in ("cuda", "cpu") or (head == "cuda" and index.isdigit()):
        return name
    raise argparse.ArgumentTypeError(
        f"device {name!r}: expected cuda, cuda:N or cpu")


def build_parser() -> argparse.ArgumentParser:
    d = default_config()
    p = argparse.ArgumentParser("rdfc_gan_torch")
    add = p.add_argument
    # dataset
    add("--dataset", type=str, default=d.dataset,
        choices=["nyuv2", "nyuv2_sparse", "nyuv2_pseudo", "cleargrasp",
                 "thuman", "sunrgbd", "synthetic", "nyuv2_s2d"])
    add("--data_root", type=str, default=None)
    add("--real_or_syn", type=str, default=d.real_or_syn)
    add("--obj_type", type=str, default=d.obj_type,
        choices=["known", "novel"])
    add("--batch_size", type=int, default=d.batch_size)
    add("--num_workers", type=int, default=d.num_workers)
    add("--loader_backend", type=str, default=d.loader_backend,
        choices=["thread", "process"],
        help="process = GIL-free worker pool (reference workers_per_gpu)")
    add("--num_classes", type=int, default=d.num_classes)
    add("--resize_height", type=int, default=d.resize_height)
    add("--resize_width", type=int, default=d.resize_width)
    add("--out_height", type=int, default=d.out_height)
    add("--out_width", type=int, default=d.out_width)
    add("--label_wall", type=int, default=d.label_wall)
    add("--label_floor", type=int, default=d.label_floor)
    add("--label_ceiling", type=int, default=d.label_ceiling)
    add("--model_cfg_path", type=str, required=True)
    # training
    add("--start_epoch", type=int, default=0)
    add("--lr", type=float, default=d.lr)
    add("--beta1", type=float, default=d.beta1)
    add("--beta2", type=float, default=d.beta2)
    add("--epoch", type=int, default=0)
    add("--n_epochs", type=int, default=d.n_epochs)
    add("--optimizer", type=str, default=d.optimizer)
    add("--scheduler", type=str, default=d.scheduler)
    add("--decay_epoch", type=int, default=d.decay_epoch)
    add("--lr_decay_epochs", type=int, nargs="+", default=d.lr_decay_epochs)
    add("--lr_decay_rate", type=float, default=d.lr_decay_rate)
    add("--weight_decay", type=float, default=d.weight_decay)
    add("--warm_up_lr", type=float, default=d.warm_up_lr)
    add("--warm_up", action="store_true", default=False)
    add("--warm_up_steps", type=int, default=d.warm_up_steps)
    add("--gan_loss_type", type=str, default=d.gan_loss_type,
        choices=["wgan", "wgangp", "lsgan", "vanilla"])
    add("--pool_size", type=int, default=d.pool_size)
    add("--clip_grad", action="store_true", default=False)
    add("--max_norm", type=float, default=d.max_norm)
    add("--norm_type", type=int, default=d.norm_type)
    # loss weights
    add("--lambda_A", type=float, default=d.lambda_A)
    add("--lambda_B", type=float, default=d.lambda_B)
    add("--lambda_L1", type=float, default=d.lambda_L1)
    add("--lambda_l1_rgb_branch", type=float, default=d.lambda_l1_rgb_branch)
    add("--lambda_l1_depth_branch", type=float,
        default=d.lambda_l1_depth_branch)
    add("--lambda_l1_fusion", type=float, default=d.lambda_l1_fusion)
    # io
    add("--work_dir", type=str, required=True)
    add("--resume_from", type=str, default=None)
    add("--load_from", type=str, default=None)
    add("--pretrained_resnet_path", type=str, default=None)
    add("--pretrained_normal_path", type=str, default=None)
    add("--pretrained_label_path", type=str, default=None)
    add("--log_interval", type=int, default=d.log_interval)
    add("--save_interval", type=int, default=d.save_interval)
    add("--sample_interval", type=int, default=d.sample_interval)
    add("--val_interval", type=int, default=d.val_interval)
    add("--criterion_to_get_best_ckpt", type=str, default="RMSE")
    add("--start_eval_epoch", type=int, default=d.start_eval_epoch)
    add("--sample_dir", type=str, default="./")
    add("--profile_dir", type=str, default=d.profile_dir,
        help="write a torch.profiler Chrome trace of train step 50")
    # runtime
    add("--seed", type=int, default=0)
    add("--gpus", type=str, default="0",
        help="accepted for CLI parity; the device is chosen by --device")
    add("--device", type=_device, default=d.device,
        help="cuda (default; cuda:LOCAL_RANK under torchrun) raises when "
             "no card is present; cuda:N takes card N as given; cpu only "
             "when asked for")
    add("--deterministic", action="store_true", default=False,
        help="deterministic cuDNN algorithms, no benchmark mode "
             "(set_random_seed's switch): a seeded run repeats bit for bit")
    add("--local_rank", type=int, default=0)
    add("--test_only", action="store_true", default=False)
    add("--init_disc", action="store_true", default=False)
    add("--cal_fps", action="store_true", default=False)
    add("--depth_only", action="store_true", default=False,
        help="inference: skip aux heads (G_label) whose outputs pred_depth "
             "never consumes (reference quirk rdfc_gan.py:172-180)")
    return p


def parse_config(argv=None) -> Config:
    """defaults <- model YAML <- CLI (reference train.py:22-24 order)."""
    args = build_parser().parse_args(argv)
    cfg = default_config()
    load_config(cfg, args.model_cfg_path)
    load_config(cfg, vars(args))
    return cfg
