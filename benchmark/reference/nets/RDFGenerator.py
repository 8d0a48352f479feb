"""The reference of a net of type ``RDFGenerator`` (rdf_generator.py's
generator): ``models.TorchRDFGenerator``, its NLSPN refinement off unless
the entry turns it on."""

from __future__ import annotations

from .. import models

KEYS = ("semantic_channels_in", "rgb_channels_encoder",
        "depth_channels_encoder", "rgb_channels_decoder",
        "depth_channels_decoder", "adain_weighting", "use_nlspn_refine",
        "nlspn_configs")


def build(net: dict, cfg: dict):
    kw = {k: net[k] for k in KEYS if k in net}
    kw.setdefault("use_nlspn_refine", False)
    return models.TorchRDFGenerator(
        encoder_type=net.get("encoder_rgb", "resnet18"), **kw)
