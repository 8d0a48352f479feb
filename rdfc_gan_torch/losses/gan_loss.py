"""Losses of the two train steps (port of rdfc_gan_tpu/losses/gan_loss.py;
reference RDFC-GAN/lib/losses/gan_loss.py), NCHW: the JAX ``[..., k]``
channel index is ``[:, k]`` here.

Every L1/L2/BCE loss is a weighted SUM of elementwise terms in f32. The
default weight is uniform 1 / (numel + 1e-6), which is a mean up to that
1e-6 and not ``F.mse_loss``'s exact mean; a weight with one dimension fewer
than the loss broadcasts over the channel axis. The normal losses
(``nor_loss``, ``manhattan_loss``) average over the pixels whose term is
non-zero, with 1e-6 in the count, so an empty mask gives exactly 0.
``manhattan_loss`` returns its three terms scaled by ``weight`` or 1 (the
reference returns None for a falsy weight; the JAX package fixed that).

At a world size above 1 (``parallel``) every mean and count divides this
rank's numerator by the global denominator: the global element count, or
a detached count summed over the ranks, with the 1e-6 added once to the
global count as JAX adds it. A rank's loss is then its share, and the sum
over the ranks is the JAX value of the global batch. At world 1 each form
is the one-process form, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..parallel import all_reduce_sum, rank_rows, world_size

_EPS6 = 1e-6


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the global batch: this rank's sum over the
    global count (``t.mean()`` at world 1)."""
    world = world_size()
    if world == 1:
        return t.mean()
    return t.sum() / (t.numel() * world)


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A detached count (or sum) ``t``, summed over the ranks."""
    return all_reduce_sum(t.detach())


def _apply_weight(loss: torch.Tensor,
                  weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return loss * (1.0 / (loss.numel() * world_size() + _EPS6))
    weight = weight.to(loss.dtype)
    if weight.dim() != loss.dim():
        weight = weight.unsqueeze(1)
    return loss * weight


def l1_loss(pred, target, weight=None) -> torch.Tensor:
    loss = torch.abs(pred.float() - target.float())
    return _apply_weight(loss, weight).sum()


def l2_loss(pred, target, weight=None) -> torch.Tensor:
    loss = (pred.float() - target.float()) ** 2
    return _apply_weight(loss, weight).sum()


# the reference defines mse_loss as L2_loss (gan_loss.py:104-120)
mse_loss = l2_loss


def binary_cross_entropy_loss(pred, target, weight=None) -> torch.Tensor:
    """BCE with logits, weighted-sum reduced (gan_loss.py:158-171)."""
    pred, target = pred.float(), target.float()
    loss = torch.clamp(pred, min=0) - pred * target + torch.log1p(
        torch.exp(-torch.abs(pred)))
    return _apply_weight(loss, weight).sum()


class GANLoss:
    """lsgan (weighted-sum MSE), vanilla (BCE with logits), wgan / wgangp
    (signed mean) adversarial loss (gan_loss.py:169-206)."""

    def __init__(self, gan_mode: str, target_real_label: float = 1.0,
                 target_fake_label: float = 0.0):
        if gan_mode not in ("lsgan", "vanilla", "wgan", "wgangp"):
            raise NotImplementedError(f"gan mode {gan_mode} not implemented")
        self.gan_mode = gan_mode
        self.real_label = target_real_label
        self.fake_label = target_fake_label

    def __call__(self, prediction: torch.Tensor, target_is_real: bool,
                 weight=None) -> torch.Tensor:
        if self.gan_mode in ("lsgan", "vanilla"):
            tgt = self.real_label if target_is_real else self.fake_label
            target = torch.full_like(prediction, tgt)
            crit = (mse_loss if self.gan_mode == "lsgan"
                    else binary_cross_entropy_loss)
            return crit(prediction, target, weight)
        p = global_mean(prediction.float())
        return -p if target_is_real else p


def softmax_cross_entropy_loss(logits: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of (B, C, H, W) logits against (B, H, W)
    integer labels in [0, C) (torch's CrossEntropyLoss default, as the JAX
    one-hot contraction computes it), in f32."""
    logz = torch.log_softmax(logits.float(), dim=1)
    return -global_mean(torch.gather(logz, 1, labels.long()[:, None]))


def _safe_norm(x: torch.Tensor, dim: int = 1,
               eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(x^2) + eps): a finite gradient at x == 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + eps)


def _cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = 1,
                       eps: float = 1e-8) -> torch.Tensor:
    """torch.cosine_similarity: dot / (max(|a|, eps) max(|b|, eps)), with
    the norms of ``_safe_norm``."""
    an = torch.clamp_min(_safe_norm(a, dim), eps)
    bn = torch.clamp_min(_safe_norm(b, dim), eps)
    return torch.sum(a * b, dim=dim) / (an * bn)


def nor_loss(pred: torch.Tensor, target: torch.Tensor,
             norm_masks: torch.Tensor) -> torch.Tensor:
    """Mean of (1 - cos(pred, target)) over the valid pixels whose detached
    cosine lies inside (-0.999, 0.999) (gan_loss.py:122-132). pred, target:
    (B, 3, H, W); norm_masks (B, H, W) or (B, C, H, W) (channel 0 read)."""
    dot = _cosine_similarity(pred.float(), target.float())
    m = norm_masks[:, 0] if norm_masks.dim() == 4 else norm_masks
    dsg = dot.detach()
    valid = (m.float() * (dsg < 0.999) * (dsg > -0.999)) > 0.0
    contrib = (1.0 - dot) * valid
    count = global_count(torch.sum(contrib != 0.0))
    return contrib.sum() / (count + _EPS6)


def manhattan_loss(normal: torch.Tensor, semantic_logits: torch.Tensor,
                   norm_mask, label_wall: int, label_floor: int,
                   label_ceiling: int, weight: Optional[float] = None):
    """Manhattan-world priors on the (B, 3, H, W) normals where the argmax
    of the (B, C, H, W) logits names the floor (normal along +y), the
    ceiling (along -y) or a wall (perpendicular to y) (gan_loss.py:50-99).
    ``norm_mask`` is unused, as in the reference. Returns (floor, wall,
    ceiling), each times ``weight`` (None: 1)."""
    sem = torch.argmax(semantic_logits, dim=1)
    normal = normal.float()
    ny = normal[:, 1]

    def directional(mask, sign):
        maskf = mask.float()
        cos = sign * (ny * maskf) / torch.clamp_min(
            _safe_norm(normal * maskf[:, None]), 1e-8)
        contrib = (1.0 - cos) * maskf
        count = global_count(torch.sum(contrib != 0.0))
        return contrib.sum() / (count + _EPS6)

    floor_loss = directional(sem == label_floor, 1.0)
    ceiling_loss = directional(sem == label_ceiling, -1.0)
    wall = (sem == label_wall).float()
    wall_cos = (ny * wall) / torch.clamp_min(
        _safe_norm(normal * wall[:, None]), 1e-8)
    wall_contrib = wall_cos * wall * 2.0
    wall_count = global_count(torch.sum(wall_contrib != 0.0))
    wall_loss = torch.abs(wall_contrib).sum() / (wall_count + _EPS6)
    w = 1.0 if weight is None else weight
    return floor_loss * w, wall_loss * w, ceiling_loss * w


def norm_normalize(norm_out: torch.Tensor) -> torch.Tensor:
    """The first 3 channels of a (B, C, H, W) normal map, L2-normalised
    over the channels with eps inside the square root (gan_loss.py:87-96),
    which keeps the gradient finite at a zero vector."""
    xyz = norm_out[:, :3]
    return xyz / torch.sqrt(torch.sum(xyz ** 2, dim=1, keepdim=True) + 1e-12)


def gradient_penalty(disc: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     lam: float = 10.0) -> torch.Tensor:
    """WGAN-GP penalty lam * mean((||grad_x disc(x_hat)||_2 - 1)^2) on
    x_hat = eps * real + (1 - eps) * fake, eps (B, 1, 1, 1) uniform in
    [0, 1): passed in (this rank's rows; the tests hand in JAX's draw) or
    drawn from ``generator`` for the global batch, of which this rank takes
    its rows. Differentiable in the discriminator's parameters."""
    b = real.shape[0]
    if eps is None:
        eps = rank_rows(torch.rand(
            (b * world_size(),) + (1,) * (real.dim() - 1),
            device=real.device, generator=generator))
    eps = eps.to(real.dtype)
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc(x_hat).sum(), x_hat, create_graph=True)
    gnorm = torch.sqrt(torch.sum(grads.float().reshape(b, -1) ** 2, dim=1)
                       + 1e-12)
    return lam * global_mean((gnorm - 1.0) ** 2)
