"""Models of the port; importing registers the generators and the
discriminators with ``GENERATORS`` and ``DISCRIMINATORS``."""
from .dcv_gan_generator import DCVGANGenerator
from .dcv_gan_generator_vanilla import DCVGANGeneratorVanilla
from .discriminators import (PatchGANDiscriminator, PixelGANDiscriminator,
                             PointNetDiscriminator)
from .esanet import ESANet, ESANetOneModality
from .label_net import PSPNet
from .normal_net import NNET
from .rdf_generator import RDFGenerator
from .resnet_generator import ResnetGenerator

__all__ = ["DCVGANGenerator", "DCVGANGeneratorVanilla", "ESANet",
           "ESANetOneModality", "NNET", "PSPNet", "PatchGANDiscriminator",
           "PixelGANDiscriminator", "PointNetDiscriminator", "RDFGenerator",
           "ResnetGenerator"]
