"""PatchGAN discriminator (port of rdfc_gan_tpu/models/discriminators.py:
PatchGANDiscriminator; reference patch_gan_discriminator.py:6-40), NCHW.

Convs 64-128-256-512-1, kernel 4, strides 2,2,2,1,1, padding 1, each with a
bias; BatchNorm on the middle layers only, LeakyReLU(0.2) on all but the
last. The module names are the reference's mmcv ConvModule stack,
``model.{i}.conv`` / ``model.{i}.bn``, so a reference ``.pth`` loads
strictly. Conv weights start N(0, 0.02) (layers.py:gan_kernel_init), biases
at zero. ``packed_width`` is a TPU layout and is read and ignored.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import DISCRIMINATORS
from .layers import BatchNorm2d


class _ConvModule(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, bn: bool, act: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding)
        nn.init.normal_(self.conv.weight, 0.0, 0.02)
        nn.init.zeros_(self.conv.bias)
        self.bn = BatchNorm2d(cout, eps=1e-5) if bn else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.leaky_relu(x, 0.2) if self.act else x


class PatchGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1,
                 out_channels: Sequence[int] = (64, 128, 256, 512, 1),
                 kernel_size: Sequence[int] = (4, 4, 4, 4, 4),
                 stride: Sequence[int] = (2, 2, 2, 1, 1),
                 padding: Sequence[int] = (1, 1, 1, 1, 1),
                 norm_cfg: Optional[dict] = None,
                 activation: str = "LeakyReLU", axis_name=None,
                 packed_width: bool = False):
        super().__init__()
        if out_channels[-1] != 1:
            raise ValueError("the PatchGAN's last conv has one channel")
        if activation.lower() != "leakyrelu":
            raise NotImplementedError(f"activation {activation!r}: this port "
                                      f"builds LeakyReLU only")
        if norm_cfg not in (None, {"type": "BN2d"}):
            raise NotImplementedError(f"norm_cfg {norm_cfg!r}: this port "
                                      f"builds BN2d only")
        n = len(out_channels)
        cin, mods = in_channels, []
        for i in range(n):
            mods.append(_ConvModule(cin, out_channels[i], kernel_size[i],
                                    stride[i], padding[i], bn=0 < i < n - 1,
                                    act=i < n - 1))
            cin = out_channels[i]
        self.model = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


DISCRIMINATORS.register("PatchGANDiscriminator")(PatchGANDiscriminator)
