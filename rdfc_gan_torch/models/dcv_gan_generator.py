"""DCVGANGenerator, the v1 (RDF-GAN, CVPR 2022) guided generator (port of
rdfc_gan_tpu/models/dcv_gan_generator.py; reference rdf_gan_generator.py:
12-361).

``global_guidance_module`` is an ``ESANetOneModality`` (pyramid
supervision off) whose class logits feed the semantic branches of ``core``,
an ``RDFGenerator`` with ``semantic_channels_in`` the number of classes;
with ``use_guidance=False`` the RGB feeds them and the core takes 3
channels (the reference's no-guidance variant). The core runs as the JAX
core does: ``nlspn_offset_radius`` 2 and ``nlspn_impl`` ``"auto"``
(rdf_generator.py:52-53). ``forward(rgb, depth)`` returns the core's dict,
or with ``return_tuple`` the v1 5-tuple (depth_map_1, confidence_map_1,
depth_map_2, confidence_map_2, pred_depth).

The constructor takes the JAX module's keys and no others; ``axis_name``
is read and ignored (the BatchNorms sync over the ranks by themselves).
The NLSPN stage belongs to ``core``: ``ops.nlspn_guard.probe_max_offset``
and ``utils.pretrained.load_resnet_torsos`` look there, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..registry import GENERATORS
from .esanet import ESANetOneModality
from .rdf_generator import RDFGenerator

RET_KEYS = ("depth_map_1", "confidence_map_1", "depth_map_2",
            "confidence_map_2", "pred_depth")


class DCVGANGenerator(nn.Module):
    def __init__(self, use_guidance: bool = True, guidance_classes: int = 40,
                 guidance_encoder: str = "resnet18",
                 guidance_channels_decoder: Sequence[int] = (128, 128, 128),
                 guidance_nr_decoder_blocks: Sequence[int] = (1, 1, 1),
                 guidance_encoder_decoder_fusion: str = "add",
                 guidance_context_module: str = "ppm",
                 guidance_weighting_in_encoder: str = "SE-add",
                 guidance_upsampling: str = "learned-3x3-zeropad",
                 encoder_rgb: str = "resnet18",
                 encoder_depth: str = "resnet18",
                 fuse_depth_in_rgb_decoder: str = "WAdaIN",
                 adain_weighting: bool = False,
                 use_nlspn_refine: bool = True,
                 nlspn_configs: Optional[dict] = None,
                 rgb_channels_encoder: Sequence[int] = (64, 64, 128, 256, 512,
                                                        512),
                 depth_channels_encoder: Sequence[int] = (64, 64, 128, 256,
                                                          512, 512),
                 rgb_channels_decoder: Sequence[int] = (256, 128, 64, 64),
                 depth_channels_decoder: Sequence[int] = (256, 128, 64, 64),
                 axis_name=None, return_tuple: bool = False):
        super().__init__()
        self.use_guidance = use_guidance
        self.return_tuple = return_tuple
        if use_guidance:
            self.global_guidance_module = ESANetOneModality(
                num_classes=guidance_classes, encoder=guidance_encoder,
                channels_decoder=tuple(guidance_channels_decoder),
                nr_decoder_blocks=tuple(guidance_nr_decoder_blocks),
                encoder_decoder_fusion=guidance_encoder_decoder_fusion,
                context_module=guidance_context_module,
                weighting_in_encoder=guidance_weighting_in_encoder,
                upsampling=guidance_upsampling, pyramid_supervision=False)
        self.core = RDFGenerator(
            encoder_rgb=encoder_rgb, encoder_depth=encoder_depth,
            semantic_channels_in=guidance_classes if use_guidance else 3,
            fuse_depth_in_rgb_decoder=fuse_depth_in_rgb_decoder,
            adain_weighting=adain_weighting,
            use_nlspn_refine=use_nlspn_refine, nlspn_configs=nlspn_configs,
            rgb_channels_encoder=rgb_channels_encoder,
            depth_channels_encoder=depth_channels_encoder,
            rgb_channels_decoder=rgb_channels_decoder,
            depth_channels_decoder=depth_channels_decoder,
            nlspn_impl="auto", nlspn_offset_radius=2)

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor):
        """rgb: (B,3,H,W); depth: (B,1,H,W)."""
        guidance = rgb
        if self.use_guidance:
            guidance = self.global_guidance_module(rgb)
            if isinstance(guidance, (tuple, list)):
                guidance = guidance[0]
        ret = self.core(rgb, depth, guidance)
        if self.return_tuple:
            return tuple(ret[k] for k in RET_KEYS)
        return ret


GENERATORS.register("DCVGANGenerator")(DCVGANGenerator)
