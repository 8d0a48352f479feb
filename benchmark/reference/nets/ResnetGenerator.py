"""The reference of a net of type ``ResnetGenerator`` (RDFC-GAN's G_B2A):
``models.TorchResnetGenerator``."""

from __future__ import annotations

from .. import models


def build(net: dict, cfg: dict):
    return models.TorchResnetGenerator(
        net.get("input_channels", 1), net.get("output_channels", 3),
        net.get("ngf", 64), net.get("n_blocks", 6))
