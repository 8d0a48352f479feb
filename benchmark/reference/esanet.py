"""Plain f32 ESANet, one modality: the guidance net of RDF-GAN's v1
generator (ESANet, Seichter et al., https://arxiv.org/abs/2011.06961, as
RDF-GAN configures it: ResNet-18 with SE gates, the pyramid pooling
context, three decoder stages of one NonBottleneck1D each, learned 3x3
zero-padded upsampling; the 40 class logits of NYUv2 out). Written from
the paper and from the JAX package's ``models/esanet.py``; imports
``torch`` and this folder's ``models.py`` only.

  * the torso: a 7x7/2 conv, BatchNorm, ReLU and a 3x3/2 max pool, then
    ResNet-18's four stages (``models.TorchBasicBlock``), an SE gate
    (x * sigmoid(conv(relu(conv(mean_hw x)))), C -> C / 16 -> C, both
    convs with a bias) after the stem and after each stage;
  * the context: for each bin b of (1, 5), an adaptive average pool to
    b x b, a 1x1 conv-BN-ReLU to C / 2 and a half-pixel bilinear resize
    back to the plane; the plane and both pyramids concatenated, a 1x1
    conv-BN-ReLU to the decoder's width;
  * the skips of stages 1-3, each through a 1x1 conv-BN-ReLU where its
    width is not the decoder stage's;
  * three decoder stages: a 3x3 conv-BN-ReLU, a NonBottleneck1D (3x1,
    ReLU, 1x3, BN, ReLU, 3x1, ReLU, 1x3, BN, plus the input, ReLU; every
    conv with a bias, BN eps 1e-3), a learned 2x upsampling and the skip
    added;
  * a 3x3 class conv and two learned 2x upsamplings to the input's size.

A learned upsampling is the nearest 2x (each pixel repeated 2 x 2) and a
depthwise 3x3 conv with a bias, zero-padded.

Departures from the published net, each the JAX package's:
  * a decoder stage's upsampling keeps the leading rows and columns of
    the skip's size, so that a plane of an odd size (15 x 19 at 228 x 304)
    takes its skip; the published net upsamples by 2 and needs planes that
    halve evenly;
  * the context's resize back to the plane is ``jax.image.resize``'s
    bilinear: half-pixel, and antialiased where the plane is smaller than
    a bin (never at 228 x 304, whose last plane is 8 x 10);
  * no pyramid supervision (RDF-GAN builds it off) and no dropout (eval);
  * module and parameter names are the measured program's (``stem``,
    ``layer1-4``, ``se_layer0-4``, ``context_module``, ``skip_layer1-3``,
    ``decoder1-3``, ``conv_out``, ``upsample1-2``), whose state it loads
    strictly; the published checkpoint's names differ.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import models

STAGE_PLANES = (64, 128, 256, 512)


class ConvBNAct(nn.Module):
    """k x k conv (no bias, padding k // 2), BatchNorm (eps 1e-5), ReLU."""

    def __init__(self, cin, cout, kernel=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, 1, kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class SqueezeAndExcitation(nn.Module):
    def __init__(self, channels, reduction=16):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc = nn.Sequential(nn.Conv2d(channels, mid, 1), nn.ReLU(),
                                nn.Conv2d(mid, channels, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(F.adaptive_avg_pool2d(x, 1))


class Stem(nn.Module):
    def __init__(self, cin=3, features=64):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)


class PyramidPooling(nn.Module):
    def __init__(self, cin, out_dim, bins=(1, 5)):
        super().__init__()
        red = cin // len(bins)
        self.features = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(b), ConvBNAct(cin, red, 1))
            for b in bins)
        self.final_conv = ConvBNAct(cin + red * len(bins), out_dim, 1)

    def forward(self, x):
        size = (x.shape[2], x.shape[3])
        outs = [x] + [F.interpolate(f(x), size, mode="bilinear",
                                    align_corners=False, antialias=True)
                      for f in self.features]
        return self.final_conv(torch.cat(outs, dim=1))


class LearnedUpsample(nn.Module):
    """Nearest 2x, cut to ``size``, then a zero-padded depthwise 3x3."""

    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, 1, 1, groups=channels)

    def forward(self, x, size=None):
        h, w = size or (2 * x.shape[2], 2 * x.shape[3])
        y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(y[:, :, :h, :w])


class NonBottleneck1D(nn.Module):
    def __init__(self, planes):
        super().__init__()
        self.conv3x1_1 = nn.Conv2d(planes, planes, (3, 1), 1, (1, 0))
        self.conv1x3_1 = nn.Conv2d(planes, planes, (1, 3), 1, (0, 1))
        self.conv3x1_2 = nn.Conv2d(planes, planes, (3, 1), 1, (1, 0))
        self.conv1x3_2 = nn.Conv2d(planes, planes, (1, 3), 1, (0, 1))
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-3)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-3)

    def forward(self, x):
        out = F.relu(self.conv3x1_1(x))
        out = F.relu(self.bn1(self.conv1x3_1(out)))
        out = F.relu(self.conv3x1_2(out))
        out = self.bn2(self.conv1x3_2(out))
        return F.relu(out + x)


class DecoderStage(nn.Module):
    def __init__(self, cin, channels, blocks=1):
        super().__init__()
        self.conv3x3 = ConvBNAct(cin, channels, 3)
        self.decoder_blocks = nn.Sequential(
            *(NonBottleneck1D(channels) for _ in range(blocks)))
        self.upsample = LearnedUpsample(channels)

    def forward(self, x, skip):
        out = self.decoder_blocks(self.conv3x3(x))
        return self.upsample(out, (skip.shape[2], skip.shape[3])) + skip


class ESANetOneModality(nn.Module):
    """The image (B, 3, H, W), H and W multiples of 4, to (B, classes, H,
    W) logits."""

    def __init__(self, num_classes=40, channels_decoder=(128, 128, 128),
                 nr_decoder_blocks=(1, 1, 1)):
        super().__init__()
        cd = list(channels_decoder)
        ch = (64,) + STAGE_PLANES
        self.stem = Stem()
        for i, (cin, p) in enumerate(zip(ch[:4], STAGE_PLANES)):
            setattr(self, f"layer{i + 1}",
                    models._resnet_layer(cin, p, 2, 1 if i == 0 else 2))
        for i, c in enumerate(ch):
            setattr(self, f"se_layer{i}", SqueezeAndExcitation(c))
        self.context_module = PyramidPooling(ch[4], cd[0])
        # the skips of stages 1, 2, 3 meet decoder stages 3, 2, 1
        for i, (c, d) in enumerate(zip(ch[1:4], cd[::-1])):
            setattr(self, f"skip_layer{i + 1}",
                    ConvBNAct(c, d, 1) if c != d else None)
        for i in range(3):
            setattr(self, f"decoder{i + 1}", DecoderStage(
                cd[0] if i == 0 else cd[i - 1], cd[i], nr_decoder_blocks[i]))
        self.conv_out = nn.Conv2d(cd[2], num_classes, 3, 1, 1)
        self.upsample1 = LearnedUpsample(num_classes)
        self.upsample2 = LearnedUpsample(num_classes)

    def forward(self, image):
        out = self.se_layer0(self.stem(image))
        skips = []
        for i in range(1, 5):
            out = getattr(self, f"se_layer{i}")(
                getattr(self, f"layer{i}")(out))
            skips.append(out)
        out = self.context_module(out)
        for i in range(3):
            skip = skips[2 - i]
            proj = getattr(self, f"skip_layer{3 - i}")
            out = getattr(self, f"decoder{i + 1}")(
                out, skip if proj is None else proj(skip))
        return self.upsample2(self.upsample1(self.conv_out(out)))
