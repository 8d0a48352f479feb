"""NNET, the surface-normal net G_normal (port of
rdfc_gan_tpu/models/normal_net.py; reference lib/models/generator/
normal_net/): an EfficientNet encoder (the B0 recipe scaled by width and
depth, B5 at 1.6 / 2.2) whose taps after stages 0, 1, 2, 4 and the bare
head conv feed a skip-connected UpSampleBN decoder with 4 output channels
(normal xyz and kappa), resized align-corners to (out_height, out_width).

State-dict names are those of the reference's timm/gen-efficientnet graph
(``encoder.original_model.{conv_stem,bn1,blocks.s.b.*,conv_head,bn2}``) and
decoder (``decoder.{conv2,up{1-4}._net.{0,1,3,4},conv3}``), so a reference
``.pth`` loads strictly. ``bn2`` after the head conv is built and never
used: the decoder taps the head conv's output before it.

Depthwise and stem convs pad as TF "SAME" (JAX ``padding="SAME"``): the
padding is computed from each call's input size, total =
max((ceil(i / s) - 1) s + k - i, 0), split lo = total // 2, so a stride-2
conv on an odd size pads symmetrically and on an even one one more at the
end. The encoder's BatchNorms take eps 1e-3, the decoder's 1e-5; the
decoder's LeakyReLU has torch's default slope 0.01.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .layers import BatchNorm2d, bilinear_resize


def round_channels(c: float, width: float, divisor: int = 8) -> int:
    c *= width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


# B0 recipe: (expand, channels, repeats, stride, kernel)
B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
TAP_STAGES = (0, 1, 2, 4)
ENC_EPS, DEC_EPS = 1e-3, 1e-5


class Conv2dSame(nn.Conv2d):
    """Conv with TF "SAME" padding computed from the input size (under a
    width-sharded forward, the global width's pads; no shard is padded)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(cin, cout, k, stride, 0, 1, groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in ((spatial.plane_size(x)[1], self.kernel_size[1],
                            self.stride[1]),
                           (x.shape[2], self.kernel_size[0], self.stride[0])):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if spatial.active() is not None:
            return spatial.conv2d(x, self.weight, self.bias, self.stride,
                                  self.dilation, self.groups,
                                  (pads[2], pads[3]), (pads[0], pads[1]))
        return super().forward(F.pad(x, pads))


class SqueezeExcite(nn.Module):
    def __init__(self, chs: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, chs, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.conv_reduce(spatial.plane_mean(x)))
        return x * torch.sigmoid(self.conv_expand(s))


class MBConv(nn.Module):
    """normal_net.py:MBConv. ``expand`` 1 is gen-efficientnet's
    DepthwiseSeparable (conv_dw, bn1, se, conv_pw, bn2), else its
    InvertedResidual (conv_pw, bn1, conv_dw, bn2, se, conv_pwl, bn3); the SE
    reduction is a quarter of the block's input channels."""

    def __init__(self, cin: int, cout: int, expand: int, k: int,
                 stride: int):
        super().__init__()
        self.expand = expand
        mid = cin * expand
        se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        if expand == 1:
            self.conv_dw = Conv2dSame(cin, cin, k, stride, groups=cin)
            self.bn1 = BatchNorm2d(cin, eps=ENC_EPS)
            self.se = se
            self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
            self.bn2 = BatchNorm2d(cout, eps=ENC_EPS)
        else:
            self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
            self.bn1 = BatchNorm2d(mid, eps=ENC_EPS)
            self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid)
            self.bn2 = BatchNorm2d(mid, eps=ENC_EPS)
            self.se = se
            self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
            self.bn3 = BatchNorm2d(cout, eps=ENC_EPS)
        self.has_residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.expand == 1:
            h = self.se(F.silu(self.bn1(self.conv_dw(x))))
            h = self.bn2(self.conv_pw(h))
        else:
            h = F.silu(self.bn1(self.conv_pw(x)))
            h = self.se(F.silu(self.bn2(self.conv_dw(h))))
            h = self.bn3(self.conv_pwl(h))
        return h + x if self.has_residual else h


class EfficientNet(nn.Module):
    """The scaled EfficientNet graph under the reference's names."""

    def __init__(self, width: float = 1.6, depth: float = 2.2):
        super().__init__()
        stem = round_channels(32, width)
        self.conv_stem = Conv2dSame(3, stem, 3, 2)
        self.bn1 = BatchNorm2d(stem, eps=ENC_EPS)
        stages, cin = [], stem
        for e, c, r, s, k in B0_BLOCKS:
            cout = round_channels(c, width)
            blocks = []
            for bi in range(round_repeats(r, depth)):
                blocks.append(MBConv(cin, cout, e, k, s if bi == 0 else 1))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        head = round_channels(1280, width)
        self.conv_head = nn.Conv2d(cin, head, 1, bias=False)
        # built but unused, as in the reference
        self.bn2 = BatchNorm2d(head, eps=ENC_EPS)


class EfficientNetEncoder(nn.Module):
    """Returns the five decoder taps: stages 0, 1, 2, 4 (1/2 .. 1/16) and
    the head conv's output (1/32) before bn2 and its activation."""

    def __init__(self, width: float = 1.6, depth: float = 2.2):
        super().__init__()
        self.original_model = EfficientNet(width, depth)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        m = self.original_model
        h = F.silu(m.bn1(m.conv_stem(x)))
        taps = []
        for si, stage in enumerate(m.blocks):
            h = stage(h)
            if si in TAP_STAGES:
                taps.append(h)
        taps.append(m.conv_head(h))
        return taps


class UpSampleBN(nn.Module):
    """Resize to the skip's size (not 2x: 10 -> 19 at 304 wide), concat,
    then twice conv3x3 + BN + LeakyReLU(0.01)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(cin, features, 3, 1, 1), BatchNorm2d(features,
                                                           eps=DEC_EPS),
            nn.LeakyReLU(0.01),
            nn.Conv2d(features, features, 3, 1, 1),
            BatchNorm2d(features, eps=DEC_EPS), nn.LeakyReLU(0.01))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = bilinear_resize(x, spatial.plane_size(skip), align_corners=True)
        return self._net(torch.cat([up, skip], dim=1))


class NormalDecoder(nn.Module):
    """Four outputs: normal xyz and kappa."""

    def __init__(self, width: float = 1.6):
        super().__init__()
        head = round_channels(1280, width)
        taps = [round_channels(B0_BLOCKS[s][1], width) for s in TAP_STAGES]
        self.conv2 = nn.Conv2d(head, head, 1)
        self.up1 = UpSampleBN(head + taps[3], head // 2)
        self.up2 = UpSampleBN(head // 2 + taps[2], head // 4)
        self.up3 = UpSampleBN(head // 4 + taps[1], head // 8)
        self.up4 = UpSampleBN(head // 8 + taps[0], head // 16)
        self.conv3 = nn.Conv2d(head // 16, 4, 3, 1, 1)

    def forward(self, taps: List[torch.Tensor]) -> torch.Tensor:
        b0, b1, b2, b3, b4 = taps
        h = self.up1(self.conv2(b4), b3)
        h = self.up4(self.up3(self.up2(h, b2), b1), b0)
        return self.conv3(h)


class NNET(nn.Module):
    def __init__(self, out_height: int = 224, out_width: int = 304,
                 width: float = 1.6, depth: float = 2.2):
        super().__init__()
        self.out_size = (out_height, out_width)
        self.encoder = EfficientNetEncoder(width, depth)
        self.decoder = NormalDecoder(width)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, 3, H, W) -> (B, 4, out_height, out_width)."""
        return bilinear_resize(self.decoder(self.encoder(img)),
                               self.out_size, align_corners=True)


def norm_normalize_kappa(norm_out: torch.Tensor,
                         min_kappa: float = 0.01) -> torch.Tensor:
    """Unit xyz and an ELU-floored kappa of a (B, 4, H, W) map
    (normal_net.py:norm_normalize_kappa)."""
    xyz, kappa = norm_out[:, :3], norm_out[:, 3:4]
    n = torch.sqrt(torch.sum(xyz ** 2, dim=1, keepdim=True) + 1e-12)
    return torch.cat([xyz / n, F.elu(kappa) + 1.0 + min_kappa], dim=1)
