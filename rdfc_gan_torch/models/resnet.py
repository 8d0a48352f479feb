"""ResNet stages (port of rdfc_gan_tpu/models/resnet.py), with torchvision
state-dict names (conv1/bn1/conv2/bn2[/conv3/bn3]/downsample.{0,1}) so
torchvision and reference weights load as they are:

  * ``BasicBlock`` stages of resnet18/34, the RDFGenerator's torsos;
  * ``Bottleneck`` stages of resnet50, plain or dilated (PSPNet's output
    stride 8, backbone_resnet50.py:126-235);
  * ``DeepStem``, the PSPNet backbone's deep_base stem
    (backbone_resnet50.py:139-154);
  * ``ResNetStem``, torchvision's 7x7/2 stem and max-pool (resnet.py:
    211-225), ESANet's and the vanilla v1 generator's.

In train mode a ``BasicBlock`` with stride 1, dilation 1 and an identity
shortcut runs as one autograd Function on the fused conv3x3 + moments
kernels (``ops/fused_block``; their plain versions on the CPU); eval mode,
projection blocks and ``Bottleneck`` run torch's convolutions.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fused_block import basic_block
from .layers import BatchNorm2d

BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
          "resnet50": (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, dilation, dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False),
                BatchNorm2d(planes, eps=1e-5))

    def fused(self) -> bool:
        return (self.training and self.downsample is None
                and self.conv1.stride == (1, 1)
                and self.conv1.dilation == (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused():
            out, (m1, v1, m2, v2) = basic_block(
                x, self.conv1.weight, self.bn1.weight, self.bn1.bias,
                self.conv2.weight, self.bn2.weight, self.bn2.bias,
                self.bn1.eps)
            self.bn1.update_running(m1, v1)
            self.bn2.update_running(m2, v2)
            return out
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1 x4, BN eps 1e-5, projection
    when the stride or the width changes (resnet.py:Bottleneck)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                BatchNorm2d(cout, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


def make_stages(encoder_type: str, cin: int, planes: Sequence[int],
                dilated: bool = False) -> list:
    """torchvision layer1..layer4: strides (1, 2, 2, 2); the first block of
    each stage strides and projects. ``dilated`` (resnet.py:make_stages):
    output stride 8, strides (1, 2, 1, 1) and dilations (1, 1, 2, 4), where
    layer3's first block runs at dilation 1 and layer4 takes the multi-grid
    (1, 2, 4), i.e. dilations 4, 8, 16."""
    block = Bottleneck if encoder_type == "resnet50" else BasicBlock
    strides, dils = ((1, 2, 1, 1), (1, 1, 2, 4)) if dilated else (
        (1, 2, 2, 2), (1, 1, 1, 1))
    stages = []
    for li, (p, n, s, d) in enumerate(zip(planes, BLOCKS[encoder_type],
                                          strides, dils)):
        blocks = []
        for i in range(n):
            di = d
            if dilated and li == 2 and i == 0:
                di = 1
            if dilated and li == 3:
                di = d * (1, 2, 4)[i % 3]
            blocks.append(block(cin, p, s if i == 0 else 1, di))
            cin = p * block.expansion
        stages.append(nn.Sequential(*blocks))
    return stages


class DeepStem(nn.Sequential):
    """3x3/2 conv -> BN -> ReLU -> 3x3 conv -> BN -> ReLU -> 3x3 conv to
    2x ``features``, then BN -> ReLU -> 3x3/2 max-pool (resnet.py:
    DeepStem). As a Sequential its state dict is the reference's
    ``initial``: ``0.{0,1,3,4,6}`` and ``1``."""

    def __init__(self, features: int = 64):
        f = features
        conv1 = nn.Sequential(
            nn.Conv2d(3, f, 3, 2, 1, bias=False), BatchNorm2d(f, eps=1e-5),
            nn.ReLU(),
            nn.Conv2d(f, f, 3, 1, 1, bias=False), BatchNorm2d(f, eps=1e-5),
            nn.ReLU(),
            nn.Conv2d(f, 2 * f, 3, 1, 1, bias=False))
        super().__init__(conv1, BatchNorm2d(2 * f, eps=1e-5), nn.ReLU(),
                         nn.MaxPool2d(3, 2, 1))


class ResNetStem(nn.Module):
    """7x7/2 conv (no bias) -> BN (eps 1e-5) -> ReLU -> 3x3/2 max-pool
    padded with -inf (resnet.py:ResNetStem; torchvision's conv1, bn1,
    maxpool). ``in_channels`` is 3 for an image; the vanilla v1 generator's
    depth stem takes the depth and the guidance map, 1 + C channels."""

    def __init__(self, in_channels: int = 3, features: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(features, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
