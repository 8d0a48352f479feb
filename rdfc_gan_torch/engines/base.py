"""Engine base (port of rdfc_gan_tpu/engines/base.py): the engine's modules,
keyed like the reference checkpoint schema, the device they run on, the
compute type of the train step, the optimizers and the epoch-wise learning
rate schedules.

``train_state`` / ``load_train_state`` carry the optimizers' and
schedulers' state through a checkpoint (``utils.checkpoint.resume_from``).

The JAX package folds the per-epoch factor into an optax step schedule
(``epoch = count // steps_per_epoch``, evaluated at the count before the
update). Here each optimizer has a ``LambdaLR`` stepped once per optimizer
step, so update k runs at factor(k // steps_per_epoch), the same count.
``fused_optimizer`` (optax.flatten) changes no math and is ignored.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; never falls back from one to the
    other."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    return dev


def make_lr_factor_fn(cfg) -> Callable[[float], float]:
    """epoch -> learning-rate multiplier (base.py:37-100; reference
    get_lr_scheduler, lib/models/base.py:50-69)."""
    sched = cfg.scheduler.lower()
    if sched == "linear":
        start, decay, total = cfg.epoch, cfg.decay_epoch, cfg.n_epochs
        return lambda e: 1.0 - max(0.0, e + start - decay) / (total - decay)
    if sched == "step":
        milestones = [float(m) for m in cfg.lr_decay_epochs]
        gamma = cfg.lr_decay_rate
        return lambda e: gamma ** sum(e >= m for m in milestones)
    if sched == "cosine":
        total = cfg.get("t_max", None) or cfg.n_epochs
        return lambda e: 0.5 * (1.0 + math.cos(math.pi * e / total))
    if sched == "onecycle":
        # torch OneCycleLR stepped per epoch with total_steps = n_epochs
        total = cfg.n_epochs
        div = float(cfg.get("div_factor", 25.0))
        pct = float(cfg.get("pct_start", 0.3))
        final_div = float(cfg.get("final_div_factor", 1e4))
        up_end = max(float(pct * total) - 1.0, 1e-6)
        down_len = max(float(total - 1) - up_end, 1e-6)
        f0 = 1.0 / div
        f_min = f0 / final_div

        def anneal(start, end, p):
            return end + (start - end) * 0.5 * (1.0 + math.cos(math.pi * p))

        def onecycle(e):
            if e <= up_end:
                return anneal(f0, 1.0, min(max(e / up_end, 0.0), 1.0))
            return anneal(1.0, f_min,
                          min(max((e - up_end) / down_len, 0.0), 1.0))

        return onecycle
    if sched == "lambda":
        # factor gamma[i] for the first decay[i] > epoch, else gamma[-1]
        decay = [float(d) for d in cfg.lambda_lr_decay]
        gamma = [float(g) for g in cfg.lambda_lr_gamma]
        return lambda e: gamma[min(sum(d <= e for d in decay),
                                   len(gamma) - 1)]
    raise NotImplementedError(sched)


def make_lr_schedule(cfg, steps_per_epoch: int,
                     lr_mult: float = 1.0) -> Callable[[int], float]:
    """optimizer step count -> learning rate, with the optional linear
    warm-up from ``warm_up_lr`` over ``warm_up_steps`` epochs (base.py:
    make_optimizer's ``schedule``)."""
    factor = make_lr_factor_fn(cfg)
    base_lr = cfg.lr * lr_mult
    spe = max(int(steps_per_epoch), 1)
    warm_up = bool(cfg.get("warm_up", False))
    warm_lr = float(cfg.get("warm_up_lr", 1e-6)) * lr_mult
    warm_steps = spe * max(int(cfg.get("warm_up_steps", 1)), 1)

    def schedule(count: int) -> float:
        if warm_up and count < warm_steps:
            return warm_lr + (base_lr - warm_lr) * (count / warm_steps)
        return base_lr * factor(float(count // spe))

    return schedule


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop's defaults, which torch's RMSprop does not reproduce:
    decay 0.9, nu from 0, eps inside the square root:
    nu <- 0.9 nu + 0.1 g^2;  p <- p - lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.sub_(group["lr"] * p.grad * torch.rsqrt(nu + group["eps"]))


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int, *, lr_mult: float = 1.0,
                   kind: Optional[str] = None, weight_decay: float = 0.0
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.LambdaLR]:
    """Optimizer factory (base.py:103-151): adam / adamw / sgd / rmsprop
    with optax's defaults, and its per-step schedule. Step the scheduler
    once after each optimizer step. ``clip_grad`` is applied by the engine
    (``clip_gradients``) before the step."""
    kind = (kind or cfg.optimizer).lower()
    params = [p for p in params if p.requires_grad]
    base_lr = cfg.lr * lr_mult
    betas = (cfg.beta1, cfg.beta2)
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=betas, eps=1e-8)
    elif kind == "adamw":
        opt = torch.optim.AdamW(params, lr=base_lr, betas=betas, eps=1e-8,
                                weight_decay=weight_decay)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr)
    elif kind == "rmsprop":
        opt = OptaxRMSprop(params, lr=base_lr)
    else:
        raise NotImplementedError(kind)
    schedule = make_lr_schedule(cfg, steps_per_epoch, lr_mult)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / base_lr)
    return opt, sched


def clip_gradients(cfg, params: Iterable[torch.nn.Parameter]):
    """optax.clip_by_global_norm(max_norm) ahead of the optimizer, when
    ``clip_grad`` is set (torch adds 1e-6 to the norm before dividing)."""
    if cfg.get("clip_grad", False):
        torch.nn.utils.clip_grad_norm_(list(params), cfg.max_norm,
                                       norm_type=cfg.get("norm_type", 2))


def compute_dtype(cfg) -> Optional[torch.dtype]:
    """The train step's activation type: bf16 for ``compute_dtype``
    bfloat16/bf16 (the default), None for float32, the parity mode."""
    name = str(cfg.get("compute_dtype", "bfloat16")).lower()
    return torch.bfloat16 if name in ("bf16", "bfloat16") else None


class BaseEngine:
    def __init__(self, cfg, is_train: bool = False, steps_per_epoch: int = 1):
        self.cfg = cfg
        self.is_train = is_train
        self.steps_per_epoch = max(int(steps_per_epoch), 1)
        self.device = resolve_device(cfg.get("device", "cuda"))
        if self.device.type == "cuda":
            # f32 in full f32, as the JAX package's f32 "highest": cuDNN
            # would otherwise run f32 convolutions in TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        # bf16 activations under autocast with f32 master weights and f32
        # optimizer state (JAX _apply's cast, base.py:156-161, 202-215);
        # the norms' statistics stay f32 (models.layers.BatchNorm2d). On
        # the CPU, where the parity tests run, the step is f32.
        self.compute_dtype = (compute_dtype(cfg)
                              if self.device.type == "cuda" else None)
        self.modules: Dict[str, torch.nn.Module] = {}
        self.optimizers: Dict[str, torch.optim.Optimizer] = {}
        self.schedulers: Dict[str, torch.optim.lr_scheduler.LambdaLR] = {}

    def autocast(self):
        """The train step's precision context: bf16 autocast on the card
        for compute_dtype bfloat16, else f32."""
        if self.compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast("cuda", dtype=self.compute_dtype)

    def train_state(self) -> Dict[str, dict]:
        """The checkpoint entries of training (reference schema):
        ``{k}_optimizer_state_dict`` and ``{k}_lr_scheduler_state_dict``
        for each optimizer ``k``."""
        out = {}
        for k, opt in self.optimizers.items():
            out[f"{k}_optimizer_state_dict"] = opt.state_dict()
            out[f"{k}_lr_scheduler_state_dict"] = \
                self.schedulers[k].state_dict()
        return out

    def load_train_state(self, entries: Dict[str, dict], start_step: int):
        """Restore what ``train_state`` wrote, every entry checked first
        (KeyError naming the first missing one), and continue the global
        step at ``start_step`` (the per-step generators are seeded from
        it)."""
        for k in self.optimizers:
            for suffix in ("optimizer", "lr_scheduler"):
                if f"{k}_{suffix}_state_dict" not in entries:
                    raise KeyError(f"checkpoint has no "
                                   f"{k}_{suffix}_state_dict: it cannot "
                                   f"resume training")
        for k, opt in self.optimizers.items():
            opt.load_state_dict(entries[f"{k}_optimizer_state_dict"])
            self.schedulers[k].load_state_dict(
                entries[f"{k}_lr_scheduler_state_dict"])
        self.n_step = int(start_step)
