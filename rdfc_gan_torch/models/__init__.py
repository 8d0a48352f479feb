"""Models of the port; importing registers the generators and the
discriminator with ``GENERATORS`` and ``DISCRIMINATORS``."""
from .discriminators import PatchGANDiscriminator
from .label_net import PSPNet
from .normal_net import NNET
from .rdf_generator import RDFGenerator
from .resnet_generator import ResnetGenerator

__all__ = ["NNET", "PSPNet", "PatchGANDiscriminator", "RDFGenerator",
           "ResnetGenerator"]
