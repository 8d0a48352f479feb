"""Layered configuration: defaults <- YAML model config <- CLI overrides.

Port of rdfc_gan_tpu/config/config.py: the same three merge layers as the
reference's yacs configurator (RDFC-GAN/lib/utils/configurator/yacs.py)
and the same defaults (RDFC-GAN/config.py:5-123), plus ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import yaml


class Config(dict):
    """Dict with attribute access and recursive merge."""

    def __init__(self, d: Mapping[str, Any] | None = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, Mapping) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return [Config._wrap(x) for x in v]
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def merge(self, other: Mapping[str, Any]):
        """Recursive merge; ``other`` wins. New keys are allowed (the
        reference's yaml adds whole sub-trees like ``model:``)."""
        for k, v in other.items():
            if isinstance(self.get(k), Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out

    def dump(self) -> str:
        """The YAML text of the config, keys in its own order (the JAX
        ``Config.dump``)."""
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def load_config(cfg: Config, source) -> Config:
    """Merge ``source`` into ``cfg``: a YAML path or a dict (reference
    ``load_config``, lib/utils/configurator/config.py:29-39)."""
    if source is None:
        return cfg
    if isinstance(source, str):
        with open(source) as f:
            source = yaml.safe_load(f) or {}
    return cfg.merge(source)


def dump_config(cfg: Config, path: str):
    """Write ``cfg.dump()`` to ``path`` (the JAX ``dump_config``)."""
    with open(path, "w") as f:
        f.write(cfg.dump())


def default_config() -> Config:
    """Framework defaults = the reference CLI defaults (RDFC-GAN/config.py:5-123)."""
    return Config(
        dict(
            # dataset
            dataset="nyuv2",
            data_root=None,
            real_or_syn="synthetic",
            obj_type="known",
            batch_size=4,
            num_workers=8,
            # "thread" overlaps GIL-released cv2 decode with the device
            # step; "process" is the reference's workers_per_gpu process
            # pool analog (helper.py:217-230) for hosts feeding many chips
            loader_backend="thread",
            num_classes=14,
            resize_height=240,
            resize_width=320,
            out_height=224,
            out_width=304,
            # semantic labels (NYUv2-13 taxonomy)
            label_wall=12,
            label_floor=5,
            label_ceiling=3,
            model_cfg_path=None,
            # training
            start_epoch=0,
            lr=2e-3,
            beta1=0.5,
            beta2=0.999,
            epoch=0,
            n_epochs=150,
            optimizer="Adam",
            scheduler="linear",
            decay_epoch=100,
            lr_decay_epochs=[280, 340],
            lr_decay_rate=0.1,
            weight_decay=0.01,
            warm_up_lr=1e-6,
            warm_up=False,
            warm_up_steps=1,
            gan_loss_type="lsgan",
            pool_size=50,
            clip_grad=False,
            max_norm=10.0,
            norm_type=2,
            # loss weights
            lambda_A=100.0,
            lambda_B=100.0,
            lambda_L1=100.0,
            lambda_l1_rgb_branch=100.0,
            lambda_l1_depth_branch=100.0,
            lambda_l1_fusion=100.0,
            # io
            work_dir=None,
            resume_from=None,
            load_from=None,
            log_interval=30,
            save_interval=10,
            sample_interval=1000,
            val_interval=1,
            criterion_to_get_best_ckpt="RMSE",
            start_eval_epoch=1,
            sample_dir="./",
            # torch.profiler Chrome trace of train step 50 (train.py:114)
            profile_dir=None,
            # runtime
            seed=0,
            test_only=False,
            init_disc=False,
            cal_fps=False,
            # the ranks' mesh: None puts every rank on 'data'; {'data': D,
            # 'model': M} with D x M the world size: rows over 'data', a
            # served image's width over 'model' (parallel.check_mesh_shape,
            # parallel.grid)
            mesh_shape=None,
            # deterministic cuDNN algorithms (utils.seed.set_random_seed)
            deterministic=False,
            # JAX-package knobs, read from shared YAMLs and ignored here
            compute_dtype="bfloat16",
            use_pallas="auto",
            donate=True,
            # where the port runs: cuda (default) or cpu, never chosen silently
            device="cuda",
            # pretrained torso checkpoints (.pth): torchvision resnet18/34
            # for the G_A2B branches (encoder_decoder/common.py:5-26), timm
            # tf_efficientnet_b5_ap for G_normal (encoder.py:10-13), dilated
            # R50 for G_label (backbone_resnet50.py:263-278)
            pretrained_resnet_path=None,
            pretrained_normal_path=None,
            pretrained_label_path=None,
            # remat: True (all nets) | False | 'selective' (remat_nets only).
            # Selective is the measured sweet spot on v5e: recompute only the
            # big aux torsos, keep generator/disc activations live —
            # 336 vs 411 ms/step at bs8 224x304 (docs/PERF_NOTES.md r2)
            remat="selective",
            remat_nets=["G_normal", "G_label"],
        )
    )
