"""Pretrained torsos for the port's nets (counterparts of the JAX loaders in
rdfc_gan_tpu/utils/torch_convert.py, which the JAX engines call from
``init_state``):

  * ``load_resnet_torsos``: torchvision resnet18/34 ``layer{1-4}`` into
    ``en{2-5}`` of both encoder-decoders of an RDFGenerator (a
    DCVGANGenerator's ``core``)
    (``apply_pretrained_torsos`` / ``apply_torso_dicts`` /
    ``load_resnet_torso``; the reference's ``pretrained_on_imagenet``,
    encoder_decoder/common.py:5-26);
  * ``load_efficientnet_torso``: a timm ``tf_efficientnet_b5_ap`` state
    dict, raw or under the NNET's ``encoder.original_model.`` prefix, into
    ``G_normal.encoder.original_model`` (the torch.hub pull of
    normal_net/submodules/encoder.py:10-13);
  * ``load_pspnet_backbone``: the reference's dilated-R50 backbone file
    (deep stem ``conv1.{0,1,3,4,6}`` + ``bn1``, ``layer1-4``) into PSPNet's
    ``initial`` and ``layer1-4``; the PSP and aux heads stay at their init
    (backbone_resnet50.py:263-278).

The port keeps the reference's state-dict names, so each loader is a key
remap and ``load_state_dict`` on the named sub-modules. A sub-module that
the file covers takes every parameter and running statistic from it (a key
it lacks raises ``KeyError``, a shape that differs ``RuntimeError``); its
BatchNorms' ``num_batches_tracked``, which the JAX trees do not hold and
which nothing reads, keep their values. File keys outside those
sub-modules are left unread, as the JAX loaders leave them (a timm file's
``bn2`` and ``classifier``, a multi-net file's other nets). A layer that
the file does not hold at all keeps its init, as in JAX.

``configured`` is the engines' check of a configured path: a path that is
set but does not exist raises ``FileNotFoundError`` with the JAX message.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch
from torch import nn

TORSO_BRANCHES = ("rgb_branch_encoder_decoder",
                  "depth_branch_encoder_decoder")


def configured(path: Optional[str]) -> Optional[str]:
    """``path`` if it is set; raises when it is set and does not exist (an
    explicitly configured torso must not silently leave the seeded init)."""
    if path and not os.path.exists(path):
        raise FileNotFoundError(
            f"configured pretrained checkpoint not found: {path}")
    return path or None


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth state dict on the CPU: a raw one, or the reference's multi-net
    schema (``{net}_state_dict``, flattened to ``{net}.{key}``; optimizer
    and scheduler states left out). ``weights_only``: a downloaded file is
    never unpickled in full."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and any(k.endswith("_state_dict") for k in obj):
        out = {}
        for k, v in obj.items():
            if k.endswith("_state_dict") and not k.endswith(
                    ("optimizer_state_dict", "lr_scheduler_state_dict")):
                net = k[: -len("_state_dict")]
                out.update({f"{net}.{pk}": pv for pk, pv in v.items()})
        return out
    return dict(obj)


def _load(module: nn.Module, sd: Dict[str, torch.Tensor],
          source: Callable[[str], str], what: str):
    """Every key of ``module`` but ``num_batches_tracked`` from
    ``sd[source(key)]``."""
    mapped = {}
    for k in module.state_dict():
        if k.endswith("num_batches_tracked"):
            continue
        src = source(k)
        if src not in sd:
            raise KeyError(f"{what}: {src!r} (for {k!r}) not in the file")
        mapped[k] = sd[src]
    module.load_state_dict(mapped, strict=False)


def load_resnet_torsos(generator: nn.Module, sd: Dict[str, torch.Tensor]):
    """torchvision resnet18/34 ``layer{1-4}.*`` -> ``en{2-5}.*`` of each
    encoder-decoder branch of ``generator`` (conv1/bn1/conv2/bn2 and the
    downsample conv and BN of every BasicBlock, running statistics
    included), or of its ``core`` where it nests one (a DCVGANGenerator's
    RDFGenerator, torch_convert.py:151-154; its guidance net keeps its
    init). A layer absent from the file keeps its init."""
    generator = getattr(generator, "core", generator)
    for branch in TORSO_BRANCHES:
        ed = getattr(generator, branch, None)
        if ed is None:
            continue
        for layer in range(1, 5):
            if f"layer{layer}.0.conv1.weight" not in sd:
                continue
            _load(getattr(ed, f"en{layer + 1}"), sd,
                  lambda k, L=layer: f"layer{L}.{k}",
                  f"{branch}.en{layer + 1}")


def load_efficientnet_torso(nnet: nn.Module, sd: Dict[str, torch.Tensor]):
    """A timm ``tf_efficientnet_b5_ap`` state dict (raw names, or the
    NNET's ``encoder.original_model.`` prefix) -> the stem, its BN, the
    MBConv blocks and the head conv of ``nnet.encoder.original_model``
    (the names agree at the NNET's own width and depth). ``bn2``, which the
    decoder never reads and the JAX tree does not hold, keeps its init."""
    pre = "encoder.original_model."
    if not any(k.startswith(pre) for k in sd):
        pre = ""
    model = nnet.encoder.original_model
    for name in ("conv_stem", "bn1", "blocks", "conv_head"):
        _load(getattr(model, name), sd, lambda k, n=name: f"{pre}{n}.{k}",
              f"G_normal.encoder.original_model.{name}")


def load_pspnet_backbone(pspnet: nn.Module, sd: Dict[str, torch.Tensor]):
    """The dilated-R50 backbone file -> PSPNet: the deep stem
    ``conv1.{0,1,3,4,6}`` + ``bn1`` onto ``initial.0.*`` + ``initial.1``,
    ``layer1-4`` onto ``layer1-4`` (a layer absent from the file keeps its
    init); the PSP and aux heads keep their init."""
    def stem(k):
        head, rest = k.split(".", 1)
        return f"conv1.{rest}" if head == "0" else f"bn1.{rest}"

    _load(pspnet.initial, sd, stem, "G_label.initial")
    for layer in range(1, 5):
        if any(k.startswith(f"layer{layer}.") for k in sd):
            _load(getattr(pspnet, f"layer{layer}"), sd,
                  lambda k, L=layer: f"layer{L}.{k}", f"G_label.layer{layer}")
