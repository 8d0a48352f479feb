"""Models of the port; importing registers them with ``GENERATORS`` and
``DISCRIMINATORS``."""
from .discriminators import PatchGANDiscriminator
from .rdf_generator import RDFGenerator

__all__ = ["PatchGANDiscriminator", "RDFGenerator"]
