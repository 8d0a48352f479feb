"""ResNet BasicBlock stages (port of rdfc_gan_tpu/models/resnet.py, the
resnet18/34 path), with torchvision state-dict names (conv1/bn1/conv2/bn2/
downsample.{0,1}) so torchvision and reference weights load as they are."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d

BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False),
                BatchNorm2d(planes, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


def make_stages(encoder_type: str, cin: int,
                planes: Sequence[int]) -> list:
    """torchvision layer1..layer4: strides (1, 2, 2, 2); the first block of
    each stage strides and projects."""
    stages = []
    for p, n, s in zip(planes, BLOCKS[encoder_type], (1, 2, 2, 2)):
        blocks = [BasicBlock(cin, p, s)] + [BasicBlock(p, p)
                                            for _ in range(n - 1)]
        stages.append(nn.Sequential(*blocks))
        cin = p
    return stages
