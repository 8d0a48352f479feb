"""String-keyed component registries (port of rdfc_gan_tpu/registry.py):
YAML ``type:`` strings dispatch to the constructors registered here, under
the reference configs' keys (``RDFGenerator``, ``PatchGANDiscriminator``,
``RDFGAN``, ``RDFCGAN``, ``synthetic``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """A simple name -> constructor registry."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, key: str | None = None) -> Callable:
        def deco(fn: Callable) -> Callable:
            k = key or fn.__name__
            if k in self._entries:
                raise KeyError(f"{k!r} already registered in {self.name}")
            self._entries[k] = fn
            return fn

        return deco

    def get(self, key: str) -> Callable:
        if key not in self._entries:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._entries)}"
            )
        return self._entries[key]

    def build(self, cfg: Dict[str, Any], **extra) -> Any:
        """Build from a config dict with a ``type`` key; remaining keys are kwargs."""
        if "type" not in cfg:
            raise KeyError(f"config for {self.name} registry has no 'type': {cfg}")
        cfg = dict(cfg)
        kind = cfg.pop("type")
        return self.get(kind)(**cfg, **extra)


GENERATORS = Registry("generators")
DISCRIMINATORS = Registry("discriminators")
MODELS = Registry("models")  # GAN engines: RDFCGAN / RDFGAN
DATASETS = Registry("datasets")


def build_generator(cfg: Dict[str, Any], **extra):
    """Mirror of the (missing) reference ``build_generator`` factory."""
    return GENERATORS.build(cfg, **extra)


def build_discriminator(cfg: Dict[str, Any], **extra):
    return DISCRIMINATORS.build(cfg, **extra)


def build_model(cfg: Dict[str, Any], **extra):
    """Mirror of the (missing) reference ``build_model`` (train.py:84-103):
    a GAN engine (``RDFCGAN``, ``RDFGAN``) from a dict with a ``type``,
    the engine's arguments (``cfg``, ``is_train``, ``steps_per_epoch``)
    beside it."""
    from . import engines, models  # noqa: F401  (register the engines)

    return MODELS.build(cfg, **extra)


def build_dataset(cfg: Dict[str, Any], **extra):
    return DATASETS.build(cfg, **extra)
