"""Image-space utilities (port of rdfc_gan_tpu/utils/image_ops.py;
reference helper.py:384-409), NCHW."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pepper_draw(shape, generator: Optional[torch.Generator] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draw of ``add_pepper_noise`` for a (B, C, H, W) image: one
    uniform for the batch (kept below p: the noise is on) and a (B, 1, H,
    W) uniform field shared by the channels."""
    b, _, h, w = shape
    active = torch.rand((), generator=generator, device=device)
    return active, torch.rand((b, 1, h, w), generator=generator,
                              device=device)


def add_pepper_noise(img: torch.Tensor, active: torch.Tensor,
                     u: torch.Tensor, snr: float = 0.98,
                     p: float = 0.9) -> torch.Tensor:
    """Salt-and-pepper corruption of a generated depth map (helper.py:
    384-402): if the batch uniform ``active`` is below ``p``, each pixel
    becomes +1 where its uniform ``u`` lies in [snr, snr + (1 - snr) / 2)
    and -1 where it lies above, in every channel. The gradient flows only
    through the pixels left as they were (the reference's in-place write
    detaches the others)."""
    on = active < p
    half = snr + (1.0 - snr) / 2.0
    salt = (u >= snr) & (u < half) & on
    pepper = (u >= half) & on
    img = torch.where(salt, torch.ones_like(img), img)
    return torch.where(pepper, -torch.ones_like(img), img)
