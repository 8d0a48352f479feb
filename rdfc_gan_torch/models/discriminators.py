"""PatchGAN discriminator (port of rdfc_gan_tpu/models/discriminators.py:
PatchGANDiscriminator; reference patch_gan_discriminator.py:6-40), NCHW.

Convs 64-128-256-512-1, kernel 4, strides 2,2,2,1,1, padding 1, each with a
bias; BatchNorm on the middle layers only, the activation (``LeakyReLU``
0.2, ``relu`` or ``None``, discriminators.py:23-31) on all but the last.
``norm_cfg`` is read and ignored: the JAX module builds BatchNorm whatever
it says (discriminators.py:84-86). The module names are the reference's
mmcv ConvModule stack, ``model.{i}.conv`` / ``model.{i}.bn``, so a
reference ``.pth`` loads strictly. Conv weights start N(0, 0.02)
(layers.py:gan_kernel_init), biases at zero. ``packed_width`` is a TPU layout and is read and ignored.
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
                 padding: int, bn: bool, act: Optional[str]):
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
        if self.act == "leakyrelu":
            return F.leaky_relu(x, 0.2)
        return F.relu(x) if self.act == "relu" else x


class PatchGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1,
                 out_channels: Sequence[int] = (64, 128, 256, 512, 1),
                 kernel_size: Sequence[int] = (4, 4, 4, 4, 4),
                 stride: Sequence[int] = (2, 2, 2, 1, 1),
                 padding: Sequence[int] = (1, 1, 1, 1, 1),
                 norm_cfg: Optional[dict] = None,
                 activation: Optional[str] = "LeakyReLU", axis_name=None,
                 packed_width: bool = False):
        super().__init__()
        if out_channels[-1] != 1:
            raise ValueError("the PatchGAN's last conv has one channel")
        act = None if activation is None else activation.lower()
        if act not in (None, "leakyrelu", "relu"):
            raise NotImplementedError(activation)
        n = len(out_channels)
        cin, mods = in_channels, []
        for i in range(n):
            mods.append(_ConvModule(cin, out_channels[i], kernel_size[i],
                                    stride[i], padding[i], bn=0 < i < n - 1,
                                    act=act if i < n - 1 else None))
            cin = out_channels[i]
        self.model = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


DISCRIMINATORS.register("PatchGANDiscriminator")(PatchGANDiscriminator)
