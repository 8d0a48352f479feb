"""The reference of a net of type ``DCVGANGenerator`` (RDF-GAN's v1
generator, rdf_gan_generator.py, with its guidance on): the plain ESANet
(``esanet.ESANetOneModality``, no pyramid supervision) as
``global_guidance_module``, whose class logits are the semantic input of
both branches of ``core``, a ``models.TorchRDFGenerator`` that takes
``guidance_classes`` channels there. ``forward(rgb, depth)`` returns the
core's five maps.

The guidance the reference has is the configuration RDF-GAN publishes;
any other value of a key below raises, so that no other net is compared
against it."""

from __future__ import annotations

import torch.nn as nn

from .. import esanet, models

KEYS = ("rgb_channels_encoder", "depth_channels_encoder",
        "rgb_channels_decoder", "depth_channels_decoder", "adain_weighting",
        "use_nlspn_refine", "nlspn_configs")
# key: the one value the reference builds
FIXED = {"use_guidance": True, "guidance_encoder": "resnet18",
         "guidance_encoder_decoder_fusion": "add",
         "guidance_context_module": "ppm",
         "guidance_weighting_in_encoder": "SE-add",
         "guidance_upsampling": "learned-3x3-zeropad",
         "encoder_rgb": "resnet18", "encoder_depth": "resnet18",
         "fuse_depth_in_rgb_decoder": "WAdaIN"}


class GuidedGenerator(nn.Module):
    def __init__(self, guidance, core):
        super().__init__()
        self.global_guidance_module = guidance
        self.core = core

    def forward(self, rgb, depth):
        return self.core(rgb, depth, self.global_guidance_module(rgb))


def build(net: dict, cfg: dict):
    for k, want in FIXED.items():
        if net.get(k, want) != want:
            raise NotImplementedError(
                f"DCVGANGenerator reference: {k} {net[k]!r}, not {want!r}")
    classes = net.get("guidance_classes", 40)
    guidance = esanet.ESANetOneModality(
        classes, tuple(net.get("guidance_channels_decoder", (128, 128, 128))),
        tuple(net.get("guidance_nr_decoder_blocks", (1, 1, 1))))
    kw = {k: net[k] for k in KEYS if k in net}
    kw.setdefault("use_nlspn_refine", True)
    core = models.TorchRDFGenerator(semantic_channels_in=classes,
                                    encoder_type="resnet18", **kw)
    return GuidedGenerator(guidance, core)
