"""RDFCGAN engine, serving (port of rdfc_gan_tpu/engines/rdfc_gan.py;
reference lib/models/rdfc_gan.py:168-182): the flagship's label and normal
nets feed its depth generator.

    forward_test: G_label(rgb) -> pred_label (skipped with ``depth_only``:
                  pred_depth never reads it), G_normal(rgb) -> pred_normal =
                  the unit xyz of its first 3 channels, then
                  G_A2B(rgb, raw_depth, pred_normal) -> pred_depth.

The modules are keyed like the reference checkpoint: G_A2B (RDFGenerator),
G_normal (NNET, ``model.Normal_G.width/depth``, B5 by default) and G_label
(PSPNet, ``model.Label_G.backbone_depth/planes/stem_features``, the dilated
R50 by default) with ``num_classes`` classes; NNET resizes to
(``out_height``, ``out_width``). G_B2A, the two PatchGANs, the four
optimizers and the 16-term train step wait for the flagship train slice.
"""

from __future__ import annotations

import torch

from ..losses import norm_normalize
from ..models.label_net import PSPNet
from ..models.normal_net import NNET
from ..registry import MODELS, build_generator
from .base import BaseEngine


class RDFCGAN(BaseEngine):
    def __init__(self, cfg, is_train: bool = False, steps_per_epoch: int = 1):
        if is_train:
            raise NotImplementedError(
                "RDFCGAN training (G_B2A, disc_A/disc_B, the four optimizers "
                "and the 16-term step) waits for the flagship train slice; "
                "this port serves the RDFCGAN only")
        super().__init__(cfg, is_train, steps_per_epoch)
        ncfg = cfg.model.get("Normal_G") or {}
        lcfg = cfg.model.get("Label_G") or {}
        self.modules = {
            "G_A2B": build_generator(cfg.model.G_A2B.to_dict()),
            "G_normal": NNET(cfg.out_height, cfg.out_width,
                             width=ncfg.get("width", 1.6),
                             depth=ncfg.get("depth", 2.2)),
            "G_label": PSPNet(
                cfg.num_classes,
                backbone_depth=lcfg.get("backbone_depth", 50),
                planes=tuple(lcfg.get("planes", (64, 128, 256, 512))),
                stem_features=lcfg.get("stem_features", 64)),
        }
        for name, mod in self.modules.items():
            self.modules[name] = mod.to(self.device).eval()
        # forward_test calls served, so a caller can relate kernel launch
        # counts to requests
        self.n_forward = 0

    @torch.inference_mode()
    def forward_test(self, rgb: torch.Tensor, raw_depth: torch.Tensor,
                     depth_only: bool = False) -> dict:
        """rgb: (B,3,H,W); raw_depth: (B,1,H,W), on the engine's device.
        Returns pred_depth (B,1,H,W), pred_normal (B,3,H,W) and, unless
        ``depth_only``, pred_label (B,num_classes,H,W) logits."""
        self.n_forward += 1
        mods = {k: m.eval() for k, m in self.modules.items()}
        if not depth_only:
            label = mods["G_label"](rgb)
        pred_normal = norm_normalize(mods["G_normal"](rgb))
        ret = mods["G_A2B"](rgb, raw_depth, pred_normal)
        out = dict(pred_depth=ret["pred_depth"], pred_normal=pred_normal)
        if not depth_only:
            out["pred_label"] = label
        if "nlspn_max_offset" in ret:
            out["nlspn_max_offset"] = ret["nlspn_max_offset"]
        return out

    __call__ = forward_test


MODELS.register("RDFCGAN")(RDFCGAN)
