"""PSPNet, the semantic-label net G_label (port of
rdfc_gan_tpu/models/label_net.py; reference lib/models/generator/
label_net/): the deep stem and a dilated ResNet (output stride 8), a
pyramid pooling module with bins 1, 2, 3, 6, a 1x1 class conv and an
align-corners resize back to the input size. In train mode, or with
``force_aux``, it also returns the auxiliary head on layer3.

State-dict names are the reference's (labels_model.py:44-96):
``initial.*`` (``DeepStem``), ``layer1..4``, ``master_branch.0.stages.{i}.
{1,2}``, ``master_branch.0.bottleneck.{0,1}``, ``master_branch.1`` and
``auxiliary_branch.{0,1,4}``. The pooling is torch's
``AdaptiveAvgPool2d``, whose windows [floor(i H / b), ceil((i + 1) H / b))
the JAX ``_adaptive_avg_pool`` copies. ``Dropout2d`` is the identity in
eval mode; its train-mode draws differ from JAX's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import BatchNorm2d, bilinear_resize
from .resnet import DeepStem, make_stages


class PSPModule(nn.Module):
    def __init__(self, cin: int, bin_sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        c = cin // len(bin_sizes)
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b),
                          nn.Conv2d(cin, c, 1, bias=False),
                          BatchNorm2d(c, eps=1e-5), nn.ReLU())
            for b in bin_sizes)
        self.bottleneck = nn.Sequential(
            nn.Conv2d(cin + c * len(bin_sizes), c, 1),
            BatchNorm2d(c, eps=1e-5), nn.ReLU(), nn.Dropout2d(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (x.shape[2], x.shape[3])
        pyramids = [x] + [bilinear_resize(s(x), size) for s in self.stages]
        return self.bottleneck(torch.cat(pyramids, dim=1))


class PSPNet(nn.Module):
    def __init__(self, num_classes: int = 14, backbone_depth: int = 50,
                 planes: Sequence[int] = (64, 128, 256, 512),
                 stem_features: int = 64):
        super().__init__()
        p = list(planes)
        self.initial = DeepStem(stem_features)
        self.layer1, self.layer2, self.layer3, self.layer4 = make_stages(
            f"resnet{backbone_depth}", 2 * stem_features, p, dilated=True)
        exp = self.layer4[0].expansion
        self.master_branch = nn.Sequential(
            PSPModule(p[3] * exp), nn.Conv2d(p[3] * exp // 4, num_classes, 1))
        self.auxiliary_branch = nn.Sequential(
            nn.Conv2d(p[2] * exp, p[3], 3, padding=1, bias=False),
            BatchNorm2d(p[3], eps=1e-5), nn.ReLU(), nn.Dropout2d(0.1),
            nn.Conv2d(p[3], num_classes, 1))

    def forward(self, x: torch.Tensor, force_aux: bool = False):
        """x (B, 3, H, W) -> class logits (B, num_classes, H, W); with the
        aux head (train mode or ``force_aux``) the list [main, aux]."""
        size = (x.shape[2], x.shape[3])
        h = self.layer2(self.layer1(self.initial(x)))
        x_aux = self.layer3(h)
        out = bilinear_resize(self.master_branch(self.layer4(x_aux)), size)
        if self.training or force_aux:
            return [out, bilinear_resize(self.auxiliary_branch(x_aux), size)]
        return out
