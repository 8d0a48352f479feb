"""Per-stage ResNet encoder / transposed-conv decoder torso (port of
rdfc_gan_tpu/models/encoder_decoder.py; reference encoder_decoder.py:5-122):
en2..en5 are resnet layer1..4, en6 a stride-2 conv to 1/16, de5..de2 k3/s2
transposed convs whose inputs carry the skips: ``concat`` adds the skip's
channels to the next decoder's input, ``add`` (identity projections, as
the JAX module builds them) does not."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..parallel import spatial
from .layers import ConvBNAct, ConvTBNAct
from .resnet import make_stages


class EncoderDecoder(nn.Module):
    def __init__(self, encoder_type: str = "resnet18",
                 encoder_channels: Sequence[int] = (64, 128, 256, 512, 512),
                 decoder_channels: Sequence[int] = (256, 128, 64, 64),
                 in_channels: int = 64, skip_type: str = "concat"):
        super().__init__()
        if skip_type not in SKIPS:
            raise ValueError(f"skip_type {skip_type!r} not in {tuple(SKIPS)}")
        ec, dc = list(encoder_channels), list(decoder_channels)
        cat = skip_type == "concat"
        self.en2, self.en3, self.en4, self.en5 = make_stages(
            encoder_type, in_channels, ec[:4])
        self.en6 = ConvBNAct(ec[-2], ec[-1], 3, 2, 1)
        self.de5 = ConvTBNAct(ec[-1], dc[0])
        self.de4 = ConvTBNAct(dc[0] + cat * ec[-2], dc[1])
        self.de3 = ConvTBNAct(dc[1] + cat * ec[-3], dc[2])
        self.de2 = ConvTBNAct(dc[2] + cat * ec[-4], dc[3])

    def encode(self, x: torch.Tensor, layer_idx: int) -> torch.Tensor:
        return getattr(self, f"en{layer_idx}")(x)

    def decode(self, x: torch.Tensor, layer_idx: int) -> torch.Tensor:
        return getattr(self, f"de{layer_idx}")(x)


def concat_skip(fd: torch.Tensor, fe: torch.Tensor) -> torch.Tensor:
    """Trim the decoder's padding overhang to the skip's size, then
    channel-concat (reference _concat, rdf_generator.py:244-262)."""
    return torch.cat([spatial.trim(fd, fe), fe], dim=1)


def add_skip(fd: torch.Tensor, fe: torch.Tensor) -> torch.Tensor:
    """Trim the decoder's overhang, then add the skip
    (encoder_decoder.py:61-63): the decoder's width must equal the
    skip's."""
    return spatial.trim(fd, fe) + fe


SKIPS = {"concat": concat_skip, "add": add_skip}
