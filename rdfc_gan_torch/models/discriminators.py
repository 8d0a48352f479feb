"""Discriminators (port of rdfc_gan_tpu/models/discriminators.py): the
PatchGAN (reference patch_gan_discriminator.py:6-40), NCHW, and the v1
family's PixelGAN and PointNet critics (discriminators.py:92-131).

Convs 64-128-256-512-1, kernel 4, strides 2,2,2,1,1, padding 1, each with a
bias; BatchNorm on the middle layers only, the activation (``LeakyReLU``
0.2, ``relu`` or ``None``, discriminators.py:23-31) on all but the last.
``norm_cfg`` is read and ignored: the JAX module builds BatchNorm whatever
it says (discriminators.py:84-86). The module names are the reference's
mmcv ConvModule stack, ``model.{i}.conv`` / ``model.{i}.bn``, so a
reference ``.pth`` loads strictly. Conv weights start N(0, 0.02)
(layers.py:gan_kernel_init), biases at zero. ``packed_width`` is a TPU layout and is read and ignored.

``PixelGANDiscriminator``: 1x1 convs ndf (bias) -> LeakyReLU(0.2) -> 2 ndf
(no bias) -> BatchNorm2d -> LeakyReLU(0.2) -> 1 (bias), weights N(0, 0.02),
named as pix2pix's ``PixelDiscriminator`` (``net.{0,2,3,5}``).
``PointNetDiscriminator``: a per-point critic of (B, N, 3) clouds, no STN:
Linear 64 -> 128 -> 1024 (BatchNorm1d-style over the B N points, ReLU on
the first two), the max over the points concatenated to each point's
64-wide feature, then 512 -> 256 -> 128 (BatchNorm, ReLU) -> 1, (B, N, 1).
Each BatchNorm is ``layers.BatchNorm2d`` over a (B N, C, 1, 1) view: the
JAX rounding, synced over ranks. The PixelGAN's ``in_channels`` is the
port's, as the PatchGAN's (Flax reads it from the input); PointNet's
names are the port's own.
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


class PixelGANDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, ndf: int = 64, axis_name=None):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(in_channels, ndf, 1), nn.LeakyReLU(0.2),
            nn.Conv2d(ndf, 2 * ndf, 1, bias=False),
            BatchNorm2d(2 * ndf, eps=1e-5), nn.LeakyReLU(0.2),
            nn.Conv2d(2 * ndf, 1, 1))
        for m in self.net:
            if isinstance(m, nn.Conv2d):
                nn.init.normal_(m.weight, 0.0, 0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PointNetDiscriminator(nn.Module):
    WIDTHS = (64, 128, 1024, 512, 256, 128)

    def __init__(self):
        super().__init__()
        w = self.WIDTHS
        cins = (3, w[0], w[1], w[0] + w[2], w[3], w[4])
        for i, (cin, cout) in enumerate(zip(cins, w)):
            setattr(self, f"fc{i + 1}", nn.Linear(cin, cout))
            setattr(self, f"bn{i + 1}", BatchNorm2d(cout, eps=1e-5))
        self.fc7 = nn.Linear(w[-1], 1)

    def _layer(self, i: int, h: torch.Tensor, relu: bool = True):
        h = getattr(self, f"fc{i}")(h)
        B, N, C = h.shape
        h = getattr(self, f"bn{i}")(h.reshape(B * N, C, 1, 1)).reshape(
            B, N, C)
        return F.relu(h) if relu else h

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        """pts: (B, N, 3) -> (B, N, 1)."""
        point_feat = self._layer(1, pts)
        h = self._layer(3, self._layer(2, point_feat), relu=False)
        glob = h.max(dim=1, keepdim=True).values.expand_as(h)
        h = torch.cat([point_feat, glob], dim=-1)
        for i in (4, 5, 6):
            h = self._layer(i, h)
        return self.fc7(h)


DISCRIMINATORS.register("PatchGANDiscriminator")(PatchGANDiscriminator)
DISCRIMINATORS.register("PixelGANDiscriminator")(PixelGANDiscriminator)
DISCRIMINATORS.register("PointNetDiscriminator")(PointNetDiscriminator)
