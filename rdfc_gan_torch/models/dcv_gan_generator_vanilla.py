"""DCVGANGeneratorVanilla, the v1 alternative build (port of
rdfc_gan_tpu/models/dcv_gan_generator_vanilla.py; reference
rdf_gan_generator_vanilla.py:9-374), NCHW.

Two resnet torsos behind ``ResNetStem``s: the RGB branch reads the
guidance map (ESANetOneModality's logits, or the RGB without guidance),
the depth branch the depth concatenated with it (1 + C channels). Five
``VanillaDecoderModule`` stages a branch, the RGB branch's first three
adding the RGB torso's skips at 1/16, 1/8 and 1/4 (1x1 ConvBNAct
projections where the widths differ), the depth branch's upsampling to
the same sizes; six fuse points (``fuse_layer1-6``: AdaIN, or W-AdaIN with
``fuse_depth_in_rgb_decoder="WAdaIN"``, whose instance norms run the IN
kernels on the card) ahead of every RGB decoder stage and of the heads;
3x3 depth (tanh) and confidence heads a branch; the two depths mixed by the
softmax of the confidences in f32. Returns the v1 5-tuple (depth_map_1,
confidence_map_1, depth_map_2, confidence_map_2, pred_depth).

Module names follow the JAX class names (the reference's are not in the
repository); ``axis_name`` is read and ignored.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..registry import GENERATORS
from .esanet import (ENCODER_PLANES, ConvBNActESA, ESANetOneModality,
                     LearnedUpsample, _skip_projection, torso_channels)
from .layers import AdaIN, AdaptiveInstanceNorm, NonBottleneck1D
from .resnet import ResNetStem, make_stages


class VanillaDecoderModule(nn.Module):
    """3x3 ConvBNAct -> ``nr_blocks`` NonBottleneck1D -> 2x upsampling to the
    skip's size (or ``up_size``) -> + skip (model_utils.py DecoderModule:
    289-344)."""

    def __init__(self, cin: int, features: int, nr_blocks: int = 1,
                 upsampling_mode: str = "bilinear"):
        super().__init__()
        self.conv3x3 = ConvBNActESA(cin, features, 3)
        self.decoder_blocks = nn.Sequential(*(
            NonBottleneck1D(features) for _ in range(nr_blocks)))
        self.upsample = LearnedUpsample(features, upsampling_mode)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                up_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        out = self.decoder_blocks(self.conv3x3(x))
        if skip is not None:
            up_size = (skip.shape[2], skip.shape[3])
        out = self.upsample(out, up_size)
        return out if skip is None else out + skip


class DCVGANGeneratorVanilla(nn.Module):
    def __init__(self, guidance_classes: int = 40,
                 encoder_rgb: str = "resnet18",
                 encoder_depth: str = "resnet18",
                 rgb_channels_decoder: Sequence[int] = (128,) * 5,
                 depth_channels_decoder: Sequence[int] = (128,) * 5,
                 nr_decoder_blocks: Sequence[int] = (1, 1, 1, 0, 0),
                 fuse_depth_in_rgb_decoder: str = "AdaIN",
                 upsampling_mode: str = "bilinear",
                 adain_weighting: bool = False, use_guidance: bool = True,
                 axis_name=None):
        super().__init__()
        self.use_guidance = use_guidance
        if use_guidance:
            self.global_guidance_module = ESANetOneModality(
                num_classes=guidance_classes, encoder=encoder_rgb,
                pyramid_supervision=False)
        c_in = guidance_classes if use_guidance else 3
        self.rgb_stem = ResNetStem(c_in)
        self.depth_stem = ResNetStem(1 + c_in)
        for br, enc in (("rgb", encoder_rgb), ("depth", encoder_depth)):
            for i, stage in enumerate(make_stages(enc, 64, ENCODER_PLANES)):
                setattr(self, f"{br}_layer{i + 1}", stage)
        rch, dch = torso_channels(encoder_rgb), torso_channels(encoder_depth)
        rcd, dcd = list(rgb_channels_decoder), list(depth_channels_decoder)
        # RGB skips (1/4, 1/8, 1/16) project to rcd[2], rcd[1], rcd[0]
        for i, (c, d) in enumerate(zip(rch[1:4], rcd[2::-1])):
            setattr(self, f"skip_layer{i + 1}", _skip_projection(c, d))

        def fuse(content, style):
            if fuse_depth_in_rgb_decoder == "WAdaIN":
                return AdaptiveInstanceNorm(content, style, adain_weighting)
            return AdaIN()  # any other name, as in JAX

        rin, din = rch[4], dch[4]
        for i in range(5):
            setattr(self, f"fuse_layer{i + 1}", fuse(rin, din))
            setattr(self, f"rgb_decoder{i + 1}", VanillaDecoderModule(
                rin, rcd[i], nr_decoder_blocks[i], upsampling_mode))
            setattr(self, f"depth_decoder{i + 1}", VanillaDecoderModule(
                din, dcd[i], nr_decoder_blocks[i], upsampling_mode))
            rin, din = rcd[i], dcd[i]
        self.fuse_layer6 = fuse(rin, din)
        self.rgb_depth_head = nn.Conv2d(rin, 1, 3, 1, 1)
        self.rgb_conf_head = nn.Conv2d(rin, 1, 3, 1, 1)
        self.depth_depth_head = nn.Conv2d(din, 1, 3, 1, 1)
        self.depth_conf_head = nn.Conv2d(din, 1, 3, 1, 1)

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        """rgb: (B,3,H,W); depth: (B,1,H,W). Returns the 5-tuple."""
        g = rgb
        if self.use_guidance:
            g = self.global_guidance_module(rgb)
            if isinstance(g, (tuple, list)):
                g = g[0]
        r = self.rgb_stem(g)
        d = self.depth_stem(torch.cat([depth, g], dim=1))
        skips = []
        for i in range(1, 5):
            r = getattr(self, f"rgb_layer{i}")(r)
            d = getattr(self, f"depth_layer{i}")(d)
            if i < 4:
                proj = getattr(self, f"skip_layer{i}")
                skips.append(r if proj is None else proj(r))
        for i in range(5):
            f = getattr(self, f"fuse_layer{i + 1}")(r, d)
            skip = skips[2 - i] if i < 3 else None
            size = None if skip is None else (skip.shape[2], skip.shape[3])
            r = getattr(self, f"rgb_decoder{i + 1}")(f, skip=skip)
            d = getattr(self, f"depth_decoder{i + 1}")(d, up_size=size)
        r = self.fuse_layer6(r, d)
        depth_map_1 = torch.tanh(self.rgb_depth_head(r))
        confidence_map_1 = self.rgb_conf_head(r)
        depth_map_2 = torch.tanh(self.depth_depth_head(d))
        confidence_map_2 = self.depth_conf_head(d)
        score = torch.softmax(torch.cat([confidence_map_1, confidence_map_2],
                                        dim=1).float(), dim=1)
        depths = torch.cat([depth_map_1, depth_map_2], dim=1)
        final = torch.sum(depths.float() * score, dim=1,
                          keepdim=True).to(depth_map_1.dtype)
        return (depth_map_1, confidence_map_1, depth_map_2, confidence_map_2,
                final)


GENERATORS.register("DCVGANGeneratorVanilla")(DCVGANGeneratorVanilla)
