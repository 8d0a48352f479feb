from ..registry import MODELS
from .base import BaseEngine, resolve_device
from .rdf_gan import RDFGAN
from .rdfc_gan import RDFCGAN


def build_engine(cfg, is_train: bool = False, steps_per_epoch: int = 1):
    """Dispatch on ``cfg.model.type`` (reference train.py:84-103)."""
    from .. import models  # noqa: F401  (registers the models)

    return MODELS.get(cfg.model.type)(cfg, is_train=is_train,
                                      steps_per_epoch=steps_per_epoch)


__all__ = ["BaseEngine", "RDFCGAN", "RDFGAN", "build_engine",
           "resolve_device"]
