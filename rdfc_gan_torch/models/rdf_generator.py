"""RDFGenerator — the two-branch RGB/depth fusion generator (port of
rdfc_gan_tpu/models/rdf_generator.py; reference rdf_generator.py:31-414).

Module names are the reference's, so a reference ``.pth`` loads strictly:
rgb_branch_en1, rgb_branch_encoder_decoder, rgb_{pred,conf}_dec{0,1},
depth_branch_en1_{rgb,depth}, depth_branch_encoder_decoder, {id,gd,cf}_dec*,
nlspn_refine_module.prop_layer.*, fuse_layer1..5 (fuse_layer5 is built but,
as in the reference, never used). Layout is NCHW.

``fuse_depth_in_rgb_decoder`` picks the fuse layers as JAX does
(rdf_generator.py:147-162): ``WAdaIN`` (``AdaptiveInstanceNorm``),
``AdaIN`` (no parameters) or ``IN`` (``INFuse``, its 1x1 conv named
``fuse_layer{i}.conv``: the reference's name is not in the repository).
Each branch's skips are ``concat`` or ``add``; ``add`` skips have identity
projections (rdf_generator.py:143-145), so the decoders and heads take no
skip channels and each decoder width must equal its skip's.

``nlspn_impl`` picks the NLSPN propagation as JAX does
(rdf_generator.py:189-206): ``gather`` the reference-exact offset gather;
else the shift-mask stencil, through ``stencil_propagate`` (``stencil``),
``propagate_auto`` (``auto``: the card's chain for a CUDA tensor) or
``nlspn_stencil_propagate`` (``pallas``, JAX's ``use_pallas="always"``:
the kernel chain with the masks in bf16, whose plain version a CPU tensor
takes).

The JAX package's TPU-only devices change neither parameters nor math and
are read from the config and ignored: ``packed_width``, the fused stem and
head convolutions, remat (``nlspn_local_remat``) and ``axis_name``.
``pretrained_on_imagenet`` is read and left to the engines, which load a
configured ``pretrained_resnet_path`` into both torsos
(``utils/pretrained.py``), as in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.kernels.nlspn_kernel import (nlspn_stencil_propagate,
                                         propagate_auto)
from ..ops.nlspn import NLSPNParamsSpec, nlspn_offset_affinity, nlspn_propagate
from ..ops.nlspn_stencil import build_shift_masks, stencil_propagate
from ..parallel import spatial
from ..registry import GENERATORS
from ..utils.profiling import span
from .encoder_decoder import SKIPS, EncoderDecoder, concat_skip
from .layers import AdaIN, AdaptiveInstanceNorm, ConvBNAct, INFuse

NLSPN_IMPLS = ("auto", "stencil", "pallas", "gather")
FUSES = ("WAdaIN", "AdaIN", "IN")


class NLSPN(nn.Module):
    """nlspn_model.py:6-175 parameters: the zero-initialised offset/affinity
    conv, the affinity scale, and the frozen dummies the reference keeps in
    its state dicts (w, b, w_conf)."""

    def __init__(self, spec: NLSPNParamsSpec):
        super().__init__()
        num = spec.num_neighbors
        k = spec.prop_kernel
        self.conv_offset_aff = nn.Conv2d(num, 3 * num, 3, 1, 1)
        nn.init.zeros_(self.conv_offset_aff.weight)
        nn.init.zeros_(self.conv_offset_aff.bias)
        if spec.affinity == "TGASS":
            scale, train = spec.affinity_gamma * num, True
        elif spec.affinity == "TC":
            scale, train = float(num), False
        else:
            scale, train = 1.0, False
        self.aff_scale_const = nn.Parameter(torch.full((1,), float(scale)),
                                            requires_grad=train)
        self.w = nn.Parameter(torch.ones(1, 1, k, k), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(1), requires_grad=False)
        self.w_conf = nn.Parameter(torch.ones(1, 1, 1, 1), requires_grad=False)


class NLSPNRefineModule(nn.Module):
    def __init__(self, spec: NLSPNParamsSpec):
        super().__init__()
        self.prop_layer = NLSPN(spec)


class RDFGenerator(nn.Module):
    def __init__(self, encoder_rgb: str = "resnet18",
                 encoder_depth: str = "resnet18",
                 semantic_channels_in: int = 3,
                 fuse_depth_in_rgb_decoder: str = "WAdaIN",
                 rgb_skip_connection_type: str = "concat",
                 depth_skip_connection_type: str = "concat",
                 adain_weighting: bool = False,
                 rgb_channels_encoder: Sequence[int] = (64, 64, 128, 256, 512,
                                                        512),
                 depth_channels_encoder: Sequence[int] = (64, 64, 128, 256,
                                                          512, 512),
                 rgb_channels_decoder: Sequence[int] = (256, 128, 64, 64),
                 depth_channels_decoder: Sequence[int] = (256, 128, 64, 64),
                 use_nlspn_refine: bool = False,
                 nlspn_configs: Optional[dict] = None,
                 nlspn_impl: str = "auto",
                 nlspn_offset_radius: int = 2,
                 pretrained_on_imagenet: bool = True, bn: bool = True,
                 nlspn_local_remat: bool = True, axis_name=None,
                 packed_width: bool = False):
        super().__init__()
        if fuse_depth_in_rgb_decoder not in FUSES:
            raise NotImplementedError(fuse_depth_in_rgb_decoder)
        if nlspn_impl not in NLSPN_IMPLS:
            raise ValueError(f"nlspn_impl {nlspn_impl!r} not in {NLSPN_IMPLS}")
        rce, dce = list(rgb_channels_encoder), list(depth_channels_encoder)
        rcd, dcd = list(rgb_channels_decoder), list(depth_channels_decoder)
        self.use_nlspn_refine = use_nlspn_refine
        self.nlspn_impl = nlspn_impl
        self.nlspn_offset_radius = int(nlspn_offset_radius)

        self.rgb_branch_en1 = ConvBNAct(semantic_channels_in, rce[0], bn=False)
        self.rgb_branch_encoder_decoder = EncoderDecoder(
            encoder_rgb, rce[1:], rcd, in_channels=rce[0],
            skip_type=rgb_skip_connection_type)
        self.rgb_skip = SKIPS[rgb_skip_connection_type]
        self.depth_skip = SKIPS[depth_skip_connection_type]
        rgb_cat = rgb_skip_connection_type == "concat"
        depth_cat = depth_skip_connection_type == "concat"
        hd = rcd[-1] + rgb_cat * rce[1]
        self.rgb_pred_dec1 = ConvBNAct(hd, 64)
        self.rgb_pred_dec0 = ConvBNAct(64 + rce[0], 1, bn=False, relu=False)
        self.rgb_conf_dec1 = ConvBNAct(hd, 32)
        self.rgb_conf_dec0 = nn.Sequential(nn.Conv2d(32 + rce[0], 1, 3, 1, 1),
                                           nn.Sigmoid())

        self.depth_branch_en1_rgb = ConvBNAct(semantic_channels_in, 48,
                                              bn=False)
        self.depth_branch_en1_depth = ConvBNAct(1, 16, bn=False)
        self.depth_branch_encoder_decoder = EncoderDecoder(
            encoder_depth, dce[1:], dcd, in_channels=64,
            skip_type=depth_skip_connection_type)
        hdd = dcd[-1] + depth_cat * dce[1]
        self.id_dec1 = ConvBNAct(hdd, 64)
        self.id_dec0 = ConvBNAct(64 + 64, 1, bn=False, relu=False)
        if use_nlspn_refine:
            cfgs = dict(nlspn_configs or {})
            self.nlspn_spec = NLSPNParamsSpec(
                prop_kernel=cfgs.get("prop_kernel", 3),
                prop_time=cfgs.get("prop_time", 18),
                affinity=cfgs.get("affinity", "TGASS"),
                affinity_gamma=cfgs.get("affinity_gamma", 0.5),
                conf_prop=cfgs.get("conf_prop", True),
                preserve_input=cfgs.get("preserve_input", False))
            num = self.nlspn_spec.num_neighbors
            self.gd_dec1 = ConvBNAct(hdd, 64)
            self.gd_dec0 = ConvBNAct(64 + 64, num, bn=False, relu=False)
        self.cf_dec1 = ConvBNAct(hdd, 32)
        self.cf_dec0 = nn.Sequential(nn.Conv2d(32 + 64, 1, 3, 1, 1),
                                     nn.Sigmoid())
        if use_nlspn_refine:
            self.nlspn_refine_module = NLSPNRefineModule(self.nlspn_spec)

        def fuse_channels(i, enc, dec, cat):  # entering fuse layer i
            return enc[-1] if i == 1 else dec[i - 2] + cat * enc[-i]

        def fuse_layer(c, cs):  # content and style channels
            if fuse_depth_in_rgb_decoder == "WAdaIN":
                return AdaptiveInstanceNorm(c, cs, adain_weighting)
            if fuse_depth_in_rgb_decoder == "AdaIN":
                return AdaIN()
            return INFuse(c, cs)

        for i in range(1, 6):
            setattr(self, f"fuse_layer{i}", fuse_layer(
                fuse_channels(i, rce, rcd, rgb_cat),
                fuse_channels(i, dce, dcd, depth_cat)))

    def _nlspn_block(self, guide, confidence, pred_init, origin_depth):
        """Offset/affinity conv -> shift-mask fold -> propagation. Returns
        the refined depth and the batch max |offset| (the stencil is exact
        only while it stays within ``nlspn_offset_radius``). All of it runs
        in the span ``rdfc.nlspn_block`` (``utils.profiling.span``)."""
        with span("rdfc.nlspn_block"):
            prop = self.nlspn_refine_module.prop_layer
            spec, R = self.nlspn_spec, self.nlspn_offset_radius
            raw = prop.conv_offset_aff(guide)
            gather = self.nlspn_impl == "gather"
            offsets, aff = nlspn_offset_affinity(
                raw, confidence, prop.aff_scale_const, spec,
                conf_sample_radius=None if gather else R)
            max_offset = offsets.detach().abs().max().float()
            if gather:
                out = nlspn_propagate(pred_init, offsets, aff, spec,
                                      feat_fix=origin_depth)
            else:
                M = build_shift_masks(offsets, aff, spec.prop_kernel, R)
                prop_fn = {"stencil": stencil_propagate,
                           "pallas": nlspn_stencil_propagate,
                           "auto": propagate_auto}[self.nlspn_impl]
                out = prop_fn(pred_init, M, prop_time=spec.prop_time, R=R,
                              feat_fix=origin_depth,
                              preserve_input=spec.preserve_input)
            return out, max_offset

    def forward(self, rgb: torch.Tensor, depth: torch.Tensor,
                normal: Optional[torch.Tensor] = None) -> dict:
        """rgb/normal: (B,3,H,W); depth: (B,1,H,W). Returns depth_map_1/2,
        confidence_map_1/2, pred_depth (each (B,1,H,W)) and, with NLSPN,
        nlspn_max_offset. The RDFGAN engine calls G(rgb, depth): rgb then
        feeds the semantic branches."""
        origin_depth = depth
        if normal is None:
            normal = rgb
        rgb_ed = self.rgb_branch_encoder_decoder
        d_ed = self.depth_branch_encoder_decoder
        rgb_fe1 = self.rgb_branch_en1(normal)
        d_fe1 = torch.cat([self.depth_branch_en1_rgb(normal),
                           self.depth_branch_en1_depth(depth)], dim=1)
        rgb_fe, d_fe = [rgb_fe1], [d_fe1]
        for idx in range(2, 7):
            rgb_fe.append(rgb_ed.encode(rgb_fe[-1], idx))
            d_fe.append(d_ed.encode(d_fe[-1], idx))
        rgb_fd, d_fd = rgb_fe[5], d_fe[5]
        for li, dec_idx in enumerate(range(5, 1, -1)):
            fuse = getattr(self, f"fuse_layer{li + 1}")(rgb_fd, d_fd)
            rgb_fd = self.rgb_skip(rgb_ed.decode(fuse, dec_idx),
                                   rgb_fe[dec_idx - 1])
            d_fd = self.depth_skip(d_ed.decode(d_fd, dec_idx),
                                   d_fe[dec_idx - 1])

        # heads conv the untrimmed decoder output and trim at the concat
        # (rdf_generator.py:374-379)
        depth_map_1 = torch.tanh(self.rgb_pred_dec0(
            concat_skip(self.rgb_pred_dec1(rgb_fd), rgb_fe1)))
        confidence_map_1 = self.rgb_conf_dec0(
            concat_skip(self.rgb_conf_dec1(rgb_fd), rgb_fe1))
        pred_init = torch.tanh(self.id_dec0(
            concat_skip(self.id_dec1(d_fd), d_fe1)))
        confidence = self.cf_dec0(concat_skip(self.cf_dec1(d_fd), d_fe1))

        ret = {}
        if self.use_nlspn_refine:
            guide = self.gd_dec0(concat_skip(self.gd_dec1(d_fd), d_fe1))
            block = self._nlspn_block
            if spatial.active() is not None:
                block = functools.partial(spatial.nlspn_block, block)
            depth_map_2, ret["nlspn_max_offset"] = block(
                guide, confidence, pred_init, origin_depth)
        else:
            depth_map_2 = pred_init
        depth_map_2 = torch.clamp(depth_map_2, -1.0, 1.0)

        conf = torch.cat([confidence_map_1, confidence], dim=1)
        score = torch.softmax(conf.float(), dim=1)
        depths = torch.cat([depth_map_1, depth_map_2], dim=1)
        pred_depth = torch.sum(depths.float() * score, dim=1,
                               keepdim=True).to(depth_map_1.dtype)
        ret.update(depth_map_1=depth_map_1, confidence_map_1=confidence_map_1,
                   depth_map_2=depth_map_2, confidence_map_2=confidence,
                   pred_depth=pred_depth)
        return ret


GENERATORS.register("RDFGenerator")(RDFGenerator)
