"""ESANet, the v1 generator's guidance net (port of
rdfc_gan_tpu/models/esanet.py; reference segmentator/esa_net/), NCHW:

  * ``ESANetOneModality`` (esanet.py:120-196): a resnet torso behind
    ``ResNetStem`` with an optional SE gate after the stem and each stage
    (``SE-add``), the pyramid pooling context (bins (1, 5)), 1x1
    projections of the skips whose width differs from the decoder's, three
    ``ESADecoderModule`` stages of ``NonBottleneck1D`` blocks, a 3x3 class
    conv and two 2x upsamplings; in train mode with
    ``pyramid_supervision`` it returns (out, s8, s16, s32), the side
    outputs at 1/8, 1/16 and 1/32;
  * ``ESANet`` (esanet.py:199-268): the two-modality net, RGB and depth
    torsos fused into the RGB stream by ``SqueezeAndExciteFusionAdd`` after
    the stems and each stage;
  * ``SqueezeAndExcitation``, ``SqueezeAndExciteFusionAdd``,
    ``ConvBNActESA``, ``PyramidPoolingModule`` and ``LearnedUpsample``
    (esanet.py:27-117).

Every BatchNorm is ``layers.BatchNorm2d`` (the JAX rounding, synced over
ranks); the identity BasicBlocks of the torsos run the fused conv3x3
kernels in train mode (``resnet.BasicBlock``). ``LearnedUpsample``'s
nearest step is an ``expand`` and a ``reshape``, whose backward is a sum
over the copies, and the half-pixel resize is the interpolation matmuls of
``layers.bilinear_resize``: no atomics in the backward.

The module names follow the JAX class names (``stem``, ``layer1-4``,
``se_layer0-4``, ``context_module``, ``skip_layer1-3``, ``decoder1-3``,
``conv_out``, ``upsample1-2``): the reference's ESANet state-dict names
are not in the repository, so a reference ``.pth`` does not load as it
is. ``utils.convert.esanet_state_dict_from_jax`` carries JAX weights
across. ``height``, ``width``, ``encoder_decoder_fusion`` (always ``add``
in JAX) and ``axis_name`` are read and ignored, as in JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .label_net import AdaptiveAvgPool
from .layers import BatchNorm2d, NonBottleneck1D, bilinear_resize, reflect_pad
from .resnet import ResNetStem, make_stages

ENCODER_PLANES = (64, 128, 256, 512)
UPSAMPLINGS = ("bilinear", "nearest", "learned-3x3", "learned-3x3-zeropad")

# the depthwise 3x3 that starts as bilinear interpolation
# (rdf model_utils.py:226-282)
_BILINEAR_3X3 = ((0.0625, 0.125, 0.0625), (0.125, 0.25, 0.125),
                 (0.0625, 0.125, 0.0625))


def torso_channels(encoder: str) -> Tuple[int, ...]:
    """Widths of the stem and the four stages of a resnet torso."""
    e = 4 if encoder == "resnet50" else 1
    return (64,) + tuple(p * e for p in ENCODER_PLANES)


class SqueezeAndExcitation(nn.Module):
    """x * sigmoid(conv(relu(conv(mean_hw(x))))), C -> max(C // 16, 1) -> C,
    both convs with a bias (esanet.py:27-37)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(channels // reduction, 1)
        self.fc = nn.Sequential(nn.Conv2d(channels, mid, 1), nn.ReLU(),
                                nn.Conv2d(mid, channels, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3), keepdim=True))


class SqueezeAndExciteFusionAdd(nn.Module):
    """SE(rgb) + SE(depth) (esanet.py:40-44)."""

    def __init__(self, channels: int):
        super().__init__()
        self.se_rgb = SqueezeAndExcitation(channels)
        self.se_depth = SqueezeAndExcitation(channels)

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        return self.se_rgb(rgb) + self.se_depth(depth)


class ConvBNActESA(nn.Sequential):
    """k x k conv (no bias, padding k // 2) -> BatchNorm2d (eps 1e-5) ->
    ReLU (esanet.py:47-60)."""

    def __init__(self, cin: int, cout: int, kernel: int = 1):
        super().__init__(OrderedDict(
            conv=nn.Conv2d(cin, cout, kernel, 1, kernel // 2, bias=False),
            bn=BatchNorm2d(cout, eps=1e-5), act=nn.ReLU()))
        nn.init.kaiming_normal_(self.conv.weight, nonlinearity="relu")


class PyramidPoolingModule(nn.Module):
    """For each bin b: adaptive average pool to b x b -> 1x1 ConvBNAct to
    C // len(bins) -> half-pixel bilinear back to H x W; the input and the
    pyramids concatenated -> 1x1 ConvBNAct to ``out_dim``
    (esanet.py:63-79)."""

    def __init__(self, cin: int, out_dim: int, bins: Sequence[int] = (1, 5)):
        super().__init__()
        red = cin // len(bins)
        self.features = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(b), ConvBNActESA(cin, red, 1))
            for b in bins)
        self.final_conv = ConvBNActESA(cin + red * len(bins), out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (x.shape[2], x.shape[3])
        outs = [x] + [bilinear_resize(f(x), size) for f in self.features]
        return self.final_conv(torch.cat(outs, dim=1))


def nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Each pixel repeated 2 x 2, as an ``expand`` and a ``reshape``: the
    backward sums the four copies (``repeat_interleave``'s CUDA backward is
    an atomic ``index_add``)."""
    B, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(B, C, H, 2, W, 2).reshape(
        B, C, 2 * H, 2 * W)


class LearnedUpsample(nn.Module):
    """2x upsampling to ``size`` (default twice the input), esanet.py:82-
    117: ``learned-3x3`` / ``learned-3x3-zeropad``, the nearest 2x step
    cropped to ``size`` (the leading rows and columns) and a depthwise 3x3
    that starts as the bilinear kernel with a zero bias, padded by the
    fixed-order reflect pad or by zeros; ``nearest``, the cropped nearest
    step; ``bilinear``, the half-pixel resize to ``size``."""

    def __init__(self, channels: int, mode: str = "bilinear"):
        super().__init__()
        if mode not in UPSAMPLINGS:
            raise NotImplementedError(f"upsampling {mode!r}")
        self.mode = mode
        self.conv = None
        if "learned-3x3" in mode:
            self.conv = nn.Conv2d(channels, channels, 3, 1,
                                  0 if mode == "learned-3x3" else 1,
                                  groups=channels)
            with torch.no_grad():
                self.conv.weight.copy_(torch.tensor(_BILINEAR_3X3).expand(
                    channels, 1, 3, 3))
                self.conv.bias.zero_()

    def forward(self, x: torch.Tensor,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h, w = size or (2 * x.shape[2], 2 * x.shape[3])
        if self.mode == "bilinear":
            return bilinear_resize(x, (h, w))
        y = nearest_2x(x)[:, :, :h, :w]
        if self.conv is None:
            return y
        if self.mode == "learned-3x3":
            y = reflect_pad(y, 1)
        return self.conv(y)


class ESADecoderModule(nn.Module):
    """3x3 ConvBNAct -> ``nr_blocks`` NonBottleneck1D -> (train mode with
    pyramid supervision: a 1x1 side conv to the classes) -> upsampling to
    the skip's size -> + skip (esanet.py:120-140). Returns (out, side or
    None)."""

    def __init__(self, cin: int, channels_dec: int, nr_blocks: int = 1,
                 num_classes: int = 37, upsampling_mode: str = "bilinear",
                 pyramid_supervision: bool = True):
        super().__init__()
        self.conv3x3 = ConvBNActESA(cin, channels_dec, 3)
        self.decoder_blocks = nn.Sequential(*(
            NonBottleneck1D(channels_dec) for _ in range(nr_blocks)))
        self.side_output = (nn.Conv2d(channels_dec, num_classes, 1)
                            if pyramid_supervision else None)
        self.upsample = LearnedUpsample(channels_dec, upsampling_mode)

    def forward(self, x: torch.Tensor, skip: torch.Tensor):
        out = self.decoder_blocks(self.conv3x3(x))
        side = None
        if self.training and self.side_output is not None:
            side = self.side_output(out)
        out = self.upsample(out, (skip.shape[2], skip.shape[3]))
        return out + skip, side


def _skip_projection(cin: int, cout: int) -> Optional[ConvBNActESA]:
    """The 1x1 ConvBNAct of a skip whose width is not the decoder's."""
    return ConvBNActESA(cin, cout, 1) if cin != cout else None


class _Decoder(nn.Module):
    """The shared tail of both ESANets: skip projections, three decoder
    stages, the class conv and two 2x upsamplings."""

    def _build_decoder(self, cin: int, skips: Sequence[int],
                       channels_decoder: Sequence[int],
                       nr_decoder_blocks: Sequence[int], num_classes: int,
                       upsampling: str, pyramid_supervision: bool):
        cd = list(channels_decoder)
        # skips (1/4, 1/8, 1/16) project to cd[2], cd[1], cd[0]
        for i, (c, d) in enumerate(zip(skips, cd[::-1])):
            setattr(self, f"skip_layer{i + 1}", _skip_projection(c, d))
        for i in range(3):
            setattr(self, f"decoder{i + 1}", ESADecoderModule(
                cin if i == 0 else cd[i - 1], cd[i], nr_decoder_blocks[i],
                num_classes, upsampling, pyramid_supervision))
        self.conv_out = nn.Conv2d(cd[2], num_classes, 3, 1, 1)
        self.upsample1 = LearnedUpsample(num_classes, upsampling)
        self.upsample2 = LearnedUpsample(num_classes, upsampling)
        self.pyramid_supervision = pyramid_supervision

    def _decode(self, out: torch.Tensor, skip1: torch.Tensor,
                skip2: torch.Tensor, skip3: torch.Tensor):
        skips = []
        for i, s in enumerate((skip1, skip2, skip3)):
            proj = getattr(self, f"skip_layer{i + 1}")
            skips.append(s if proj is None else proj(s))
        out, s32 = self.decoder1(out, skips[2])
        out, s16 = self.decoder2(out, skips[1])
        out, s8 = self.decoder3(out, skips[0])
        out = self.upsample2(self.upsample1(self.conv_out(out)))
        if self.training and self.pyramid_supervision:
            return out, s8, s16, s32
        return out


class ESANetOneModality(_Decoder):
    def __init__(self, height: int = 480, width: int = 640,
                 num_classes: int = 37, encoder: str = "resnet18",
                 channels_decoder: Sequence[int] = (128, 128, 128),
                 nr_decoder_blocks: Sequence[int] = (1, 1, 1),
                 encoder_decoder_fusion: str = "add",
                 context_module: str = "ppm",
                 weighting_in_encoder: str = "None",
                 upsampling: str = "bilinear",
                 pyramid_supervision: bool = True, axis_name=None):
        super().__init__()
        ch = torso_channels(encoder)
        self.stem = ResNetStem(3)
        for i, stage in enumerate(make_stages(encoder, 64, ENCODER_PLANES)):
            setattr(self, f"layer{i + 1}", stage)
        use_se = weighting_in_encoder == "SE-add"
        for i, c in enumerate(ch):
            setattr(self, f"se_layer{i}",
                    SqueezeAndExcitation(c) if use_se else nn.Identity())
        cd = list(channels_decoder)
        self.context_module = None
        if context_module == "ppm":
            self.context_module = PyramidPoolingModule(ch[4], cd[0])
        self._build_decoder(cd[0] if self.context_module else ch[4],
                            ch[1:4], cd, nr_decoder_blocks, num_classes,
                            upsampling, pyramid_supervision)

    def forward(self, image: torch.Tensor):
        out = self.se_layer0(self.stem(image))
        skip1 = self.se_layer1(self.layer1(out))
        skip2 = self.se_layer2(self.layer2(skip1))
        skip3 = self.se_layer3(self.layer3(skip2))
        out = self.se_layer4(self.layer4(skip3))
        if self.context_module is not None:
            out = self.context_module(out)
        return self._decode(out, skip1, skip2, skip3)


class ESANet(_Decoder):
    """The depth torso's stem takes one channel, the depth image."""

    def __init__(self, height: int = 480, width: int = 640,
                 num_classes: int = 37, encoder: str = "resnet18",
                 channels_decoder: Sequence[int] = (128, 128, 128),
                 nr_decoder_blocks: Sequence[int] = (1, 1, 1),
                 upsampling: str = "bilinear",
                 pyramid_supervision: bool = True, axis_name=None):
        super().__init__()
        ch = torso_channels(encoder)
        self.stem_rgb = ResNetStem(3)
        self.stem_depth = ResNetStem(1)
        for br in ("rgb", "depth"):
            for i, stage in enumerate(make_stages(encoder, 64,
                                                  ENCODER_PLANES)):
                setattr(self, f"{br}_layer{i + 1}", stage)
        for i, c in enumerate(ch):
            setattr(self, f"se_layer{i}", SqueezeAndExciteFusionAdd(c))
        self.context_module = PyramidPoolingModule(ch[4], channels_decoder[0])
        self._build_decoder(channels_decoder[0], ch[1:4], channels_decoder,
                            nr_decoder_blocks, num_classes, upsampling,
                            pyramid_supervision)

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        z = self.stem_depth(depth)
        r = self.se_layer0(self.stem_rgb(rgb), z)
        skips = []
        for i in range(1, 5):
            r = getattr(self, f"rgb_layer{i}")(r)
            z = getattr(self, f"depth_layer{i}")(z)
            r = getattr(self, f"se_layer{i}")(r, z)
            skips.append(r)
        return self._decode(self.context_module(r), *skips[:3])
