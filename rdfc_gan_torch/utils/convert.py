"""JAX (Flax) weights -> the port's state dicts: the RDFGenerator, the
PatchGAN, the ResnetGenerator, NNET (G_normal), PSPNet (G_label) and the
RDFCGAN's six nets. Each takes the Flax ``params`` / ``batch_stats`` trees
as numpy arrays. Also the deformable ops' tensors
(``deform_conv_weight_from_jax``, ``deform_offsets_from_jax``,
``deform_mask_from_jax``).

``nnet_state_dict_from_jax`` and ``pspnet_state_dict_from_jax`` are the
inverses of the JAX package's ``utils/torch_convert.py:convert_nnet`` and
``convert_pspnet``. The JAX NNET has no ``bn2`` after the head conv (the
decoder never reads it), so the returned dict gives it its identity values;
a JAX PSPNet initialised in eval mode has no aux head, and the dict then
leaves ``auxiliary_branch`` out (load with ``strict=False``).

``patchgan_state_dict_from_jax`` is the exact inverse of
``tools/convert_torch_ckpt.py:convert_patchgan``: ``Conv_{i}`` (HWIO) ->
``model.{i}.conv`` (OIHW) and ``BatchNorm_{j}`` -> ``model.{i}.bn`` for the
middle layers.

``rdf_generator_state_dict_from_jax`` is the exact inverse of the JAX
package's ``utils/torch_convert.py:convert_rdf_generator``: it takes the
Flax ``params`` / ``batch_stats`` trees as numpy arrays and returns a state
dict with the reference names, undoing

  * HWIO -> OIHW for every convolution;
  * the ConvTranspose transpose and spatial flip;
  * the fused stem (``stem_fused`` ``kernel_i_j`` / ``bias_i``);
  * the fused dec1 ConvBNAct (output-channel concat of the heads, with their
    BatchNorm parameters and statistics);
  * the fused dec0 convs (input rows split into the head's own feature and
    the shared en1 skip);
  * the NLSPN offset-channel permutation;
  * ``aff_scale_const``'s scalar shape (the reference keeps (1,));
  * EqualLinear's (in, out) ``weight`` -> (out, in) ``weight_orig``; both
    sides store it unscaled and scale by sqrt(2 / fan_in) at call time.

The v1 family (``esanet_state_dict_from_jax``,
``dcv_gan_generator_state_dict_from_jax``,
``dcv_gan_generator_vanilla_state_dict_from_jax``,
``pixelgan_state_dict_from_jax``, ``pointnet_state_dict_from_jax``) walks
the Flax trees by their compact names, which count each class in creation
order: ``ResNetStem_0``, ``ResNetStage_{i}``, ``SqueezeAndExcitation_{i}``,
``ConvBNActESA_{i}`` (a skip projection takes the next one only where the
widths differ), ``ESADecoderModule_{i}``, ``LearnedUpsample_{i}``,
``VanillaDecoderModule_{i}`` (the RGB and the depth stage of each level in
turn) and ``AdaptiveInstanceNorm_{i}``; the port's modules are named after
those classes. The reference's ESANet state-dict names are not in the
repository, so a reference v1 ``.pth`` has no converter here. A
train-mode side conv of an ESANet decoder that the tree lacks (initialised
in eval mode) is left out of the dict.

``fuse_layer5`` exists in the reference but the forward never uses it, and
the JAX tree has no parameters for it: the returned dict leaves it out, so
load with ``strict=False`` and it keeps its init values. The frozen NLSPN
dummies (w, b, w_conf) and BatchNorm's ``num_batches_tracked`` are filled
with their constant values.

``net_state_dict_from_jax`` picks the converter of an engine's net by the
module's class and takes its options from the engine's config, as the JAX
``tools/convert_torch_ckpt.py`` takes them (``use_nlspn_refine``,
``adain_weighting``, ``fuse_depth_in_rgb_decoder``, NNET's ``depth``; an
option the config leaves out is the module's default).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

import numpy as np
import torch

from ..models.normal_net import B0_BLOCKS, round_repeats

# per-head output channels of the fused dec1 / dec0 stacks
# (rdfc_gan_tpu/models/rdf_generator.py:124-141)
_RGB_HEADS = (("rgb_pred_dec", 64), ("rgb_conf_dec", 32))
_DEPTH_HEADS = (("id_dec", 64), ("gd_dec", 64), ("cf_dec", 32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _oihw(k) -> torch.Tensor:
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _bn(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _encoder_decoder(sd, prefix, p, s):
    for en in ("en2", "en3", "en4", "en5"):
        for blk, bp in p[en].items():
            bi = int(blk.split("_")[1])
            bs = s[en][blk]
            base = f"{prefix}.{en}.{bi}"
            for ci in range(2):
                sd[f"{base}.conv{ci + 1}.weight"] = _oihw(
                    bp[f"Conv_{ci}"]["kernel"])
                _bn(sd, f"{base}.bn{ci + 1}", bp[f"BatchNorm_{ci}"],
                    bs[f"BatchNorm_{ci}"])
            if "Conv_2" in bp:
                sd[f"{base}.downsample.0.weight"] = _oihw(
                    bp["Conv_2"]["kernel"])
                _bn(sd, f"{base}.downsample.1", bp["BatchNorm_2"],
                    bs["BatchNorm_2"])
    sd[f"{prefix}.en6.0.weight"] = _oihw(p["en6"]["Conv_0"]["kernel"])
    _bn(sd, f"{prefix}.en6.1", p["en6"]["BatchNorm_0"],
        s["en6"]["BatchNorm_0"])
    for de in ("de5", "de4", "de3", "de2"):
        k = np.asarray(p[de]["TorchConvTranspose_0"]["kernel"])
        sd[f"{prefix}.{de}.0.weight"] = _t(k[::-1, ::-1].transpose(2, 3, 0, 1))
        _bn(sd, f"{prefix}.{de}.1", p[de]["BatchNorm_0"],
            s[de]["BatchNorm_0"])


def _split_dec1(sd, p, s, heads):
    k = np.asarray(p["Conv_0"]["kernel"])
    bnp, bns = p["BatchNorm_0"], s["BatchNorm_0"]
    start = 0
    for name, c in heads:
        sl = slice(start, start + c)
        sd[f"{name}1.0.weight"] = _oihw(k[..., sl])
        _bn(sd, f"{name}1.1",
            {"scale": np.asarray(bnp["scale"])[sl],
             "bias": np.asarray(bnp["bias"])[sl]},
            {"mean": np.asarray(bns["mean"])[sl],
             "var": np.asarray(bns["var"])[sl]})
        start += c


def _join_dec0(sd, p, heads):
    shared = len(heads)
    for i, (name, _) in enumerate(heads):
        k = np.concatenate([np.asarray(p[f"kernel_{i}_{i}"]),
                            np.asarray(p[f"kernel_{i}_{shared}"])], axis=2)
        sd[f"{name}0.0.weight"] = _oihw(k)
        sd[f"{name}0.0.bias"] = _t(p[f"bias_{i}"])


def rdf_generator_state_dict_from_jax(params: Dict[str, Any],
                                      batch_stats: Dict[str, Any],
                                      use_nlspn_refine: bool = True,
                                      adain_weighting: bool = False,
                                      fuse: str = "WAdaIN"
                                      ) -> Dict[str, torch.Tensor]:
    """Flax RDFGenerator (params, batch_stats) numpy trees -> state dict of
    ``rdfc_gan_torch.models.RDFGenerator`` (fuse_layer5 left out), for
    either skip type and the ``fuse`` layers (``fuse_depth_in_rgb_decoder``):
    W-AdaIN's EqualLinear (and weighting convs), INFuse's 1x1 ``Conv_0`` ->
    ``fuse_layer{i}.conv``, AdaIN's nothing."""
    sd: Dict[str, torch.Tensor] = {}
    st = params["stem_fused"]
    for name, i, j in (("rgb_branch_en1", 0, 0),
                       ("depth_branch_en1_rgb", 1, 0),
                       ("depth_branch_en1_depth", 2, 1)):
        sd[f"{name}.0.weight"] = _oihw(st[f"kernel_{i}_{j}"])
        sd[f"{name}.0.bias"] = _t(st[f"bias_{i}"])
    _encoder_decoder(sd, "rgb_branch_encoder_decoder", params["rgb_ed"],
                     batch_stats["rgb_ed"])
    _encoder_decoder(sd, "depth_branch_encoder_decoder", params["depth_ed"],
                     batch_stats["depth_ed"])

    depth_heads = _DEPTH_HEADS if use_nlspn_refine else (
        _DEPTH_HEADS[0], _DEPTH_HEADS[2])
    _split_dec1(sd, params["rgb_dec1"], batch_stats["rgb_dec1"], _RGB_HEADS)
    _split_dec1(sd, params["depth_dec1"], batch_stats["depth_dec1"],
                depth_heads)
    _join_dec0(sd, params["rgb_dec0"], _RGB_HEADS)
    _join_dec0(sd, params["depth_dec0"], depth_heads)

    if use_nlspn_refine:
        pre = "nlspn_refine_module.prop_layer"
        oa = params["conv_offset_aff"]
        k = np.asarray(oa["kernel"])
        num = k.shape[-1] // 3
        # our channel i <- reference channel perm[i]
        # (torch_convert.nlspn_offset_channel_perm), inverted
        perm = np.asarray([2 * i for i in range(num)]
                          + [2 * i + 1 for i in range(num)]
                          + list(range(2 * num, 3 * num)))
        k_ref = np.empty_like(k)
        k_ref[..., perm] = k
        b_ref = np.empty_like(np.asarray(oa["bias"]))
        b_ref[perm] = np.asarray(oa["bias"])
        sd[f"{pre}.conv_offset_aff.weight"] = _oihw(k_ref)
        sd[f"{pre}.conv_offset_aff.bias"] = _t(b_ref)
        sd[f"{pre}.aff_scale_const"] = _t(
            np.asarray(params["aff_scale_const"], np.float32).reshape(1))
        pk = int(round(np.sqrt(num + 1)))
        sd[f"{pre}.w"] = torch.ones(1, 1, pk, pk)
        sd[f"{pre}.b"] = torch.zeros(1)
        sd[f"{pre}.w_conf"] = torch.ones(1, 1, 1, 1)

    for i in range(4 if fuse != "AdaIN" else 0):
        fl = params[f"fuse_layers_{i}"]
        pre = f"fuse_layer{i + 1}"
        if fuse == "IN":
            _conv(sd, f"{pre}.conv", fl["Conv_0"])
            continue
        _wadain(sd, pre, fl, adain_weighting)
    return sd


def _wadain(sd, pre, fl, weighting: bool):
    """An AdaptiveInstanceNorm: EqualLinear's (in, out) ``weight`` ->
    (out, in) ``weight_orig``, and the weighting convs."""
    sd[f"{pre}.style.linear.weight_orig"] = _t(
        np.asarray(fl["EqualLinear_0"]["weight"]).T)
    sd[f"{pre}.style.linear.bias"] = _t(fl["EqualLinear_0"]["bias"])
    if weighting:
        for conv, name in (("Conv_0", "gamma_weight_layer"),
                           ("Conv_1", "beta_weight_layer")):
            _conv(sd, f"{pre}.{name}", fl[conv])


def patchgan_state_dict_from_jax(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """Flax PatchGANDiscriminator (params, batch_stats) numpy trees -> state
    dict of ``rdfc_gan_torch.models.PatchGANDiscriminator``. The JAX tree
    counts no batches, so the BatchNorms' ``num_batches_tracked`` are 0."""
    sd: Dict[str, torch.Tensor] = {}
    n = sum(1 for k in params if k.startswith("Conv_"))
    for i in range(n):
        conv = params[f"Conv_{i}"]
        sd[f"model.{i}.conv.weight"] = _oihw(conv["kernel"])
        sd[f"model.{i}.conv.bias"] = _t(conv["bias"])
        if 0 < i < n - 1:
            j = f"BatchNorm_{i - 1}"
            _bn(sd, f"model.{i}.bn", params[j], batch_stats[j])
    return sd


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _oihw(p["kernel"])
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _identity_bn(sd, prefix, c):
    sd[f"{prefix}.weight"] = torch.ones(c)
    sd[f"{prefix}.bias"] = torch.zeros(c)
    sd[f"{prefix}.running_mean"] = torch.zeros(c)
    sd[f"{prefix}.running_var"] = torch.ones(c)
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


# MBConv layers in order: (JAX conv or BN, reference name), by expand == 1
_MBCONV = {
    True: (("Conv_0", "conv_dw"), ("BatchNorm_0", "bn1"),
           ("Conv_1", "conv_pw"), ("BatchNorm_1", "bn2")),
    False: (("Conv_0", "conv_pw"), ("BatchNorm_0", "bn1"),
            ("Conv_1", "conv_dw"), ("BatchNorm_1", "bn2"),
            ("Conv_2", "conv_pwl"), ("BatchNorm_2", "bn3")),
}


def nnet_state_dict_from_jax(params: Dict[str, Any],
                             batch_stats: Dict[str, Any],
                             depth: float = 2.2
                             ) -> Dict[str, torch.Tensor]:
    """Flax NNET (params, batch_stats) numpy trees -> state dict of
    ``rdfc_gan_torch.models.normal_net.NNET`` at the same ``depth``."""
    sd: Dict[str, torch.Tensor] = {}
    ep = params["EfficientNetEncoder_0"]
    es = batch_stats["EfficientNetEncoder_0"]
    pre = "encoder.original_model"
    _conv(sd, f"{pre}.conv_stem", ep["Conv_0"])
    _bn(sd, f"{pre}.bn1", ep["BatchNorm_0"], es["BatchNorm_0"])
    mb = 0
    for si, (e, _c, r, _s, _k) in enumerate(B0_BLOCKS):
        for bi in range(round_repeats(r, depth)):
            bp, p, st = (f"{pre}.blocks.{si}.{bi}", ep[f"MBConv_{mb}"],
                         es[f"MBConv_{mb}"])
            for src, dst in _MBCONV[e == 1]:
                if src.startswith("Conv"):
                    _conv(sd, f"{bp}.{dst}", p[src])
                else:
                    _bn(sd, f"{bp}.{dst}", p[src], st[src])
            se = p["SqueezeExcite_0"]
            _conv(sd, f"{bp}.se.conv_reduce", se["Conv_0"])
            _conv(sd, f"{bp}.se.conv_expand", se["Conv_1"])
            mb += 1
    _conv(sd, f"{pre}.conv_head", ep["Conv_1"])
    _identity_bn(sd, f"{pre}.bn2",
                 np.asarray(ep["Conv_1"]["kernel"]).shape[-1])

    dp = params["NormalDecoder_0"]
    ds = batch_stats["NormalDecoder_0"]
    _conv(sd, "decoder.conv2", dp["Conv_0"])
    for i in range(4):
        up, ust = dp[f"UpSampleBN_{i}"], ds[f"UpSampleBN_{i}"]
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            _conv(sd, f"decoder.up{i + 1}._net.{ci}", up[f"Conv_{j}"])
            _bn(sd, f"decoder.up{i + 1}._net.{bi}", up[f"BatchNorm_{j}"],
                ust[f"BatchNorm_{j}"])
    _conv(sd, "decoder.conv3", dp["Conv_1"])
    return sd


def pspnet_state_dict_from_jax(params: Dict[str, Any],
                               batch_stats: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Flax PSPNet (params, batch_stats) numpy trees -> state dict of
    ``rdfc_gan_torch.models.label_net.PSPNet``; ``auxiliary_branch`` only
    when the tree has the aux head."""
    sd: Dict[str, torch.Tensor] = {}
    sp, ss = params["DeepStem_0"], batch_stats["DeepStem_0"]
    for i, (ci, bi) in enumerate(((0, 1), (3, 4), (6, None))):
        _conv(sd, f"initial.0.{ci}", sp[f"Conv_{i}"])
        _bn(sd, f"initial.0.{bi}" if bi is not None else "initial.1",
            sp[f"BatchNorm_{i}"], ss[f"BatchNorm_{i}"])
    for li in range(4):
        stage, sst = params[f"ResNetStage_{li}"], batch_stats[
            f"ResNetStage_{li}"]
        for blk in stage:
            bp = f"layer{li + 1}.{int(blk.rsplit('_', 1)[1])}"
            p, st = stage[blk], sst[blk]
            for ci in range(3):
                _conv(sd, f"{bp}.conv{ci + 1}", p[f"Conv_{ci}"])
                _bn(sd, f"{bp}.bn{ci + 1}", p[f"BatchNorm_{ci}"],
                    st[f"BatchNorm_{ci}"])
            if "Conv_3" in p:
                _conv(sd, f"{bp}.downsample.0", p["Conv_3"])
                _bn(sd, f"{bp}.downsample.1", p["BatchNorm_3"],
                    st["BatchNorm_3"])
    pp, ps = params["PSPModule_0"], batch_stats["PSPModule_0"]
    nbins = sum(1 for k in pp if k.startswith("Conv_")) - 1
    for i in range(nbins):
        _conv(sd, f"master_branch.0.stages.{i}.1", pp[f"Conv_{i}"])
        _bn(sd, f"master_branch.0.stages.{i}.2", pp[f"BatchNorm_{i}"],
            ps[f"BatchNorm_{i}"])
    _conv(sd, "master_branch.0.bottleneck.0", pp[f"Conv_{nbins}"])
    _bn(sd, "master_branch.0.bottleneck.1", pp[f"BatchNorm_{nbins}"],
        ps[f"BatchNorm_{nbins}"])
    _conv(sd, "master_branch.1", params["Conv_0"])
    if "Conv_1" in params:
        _conv(sd, "auxiliary_branch.0", params["Conv_1"])
        _bn(sd, "auxiliary_branch.1", params["BatchNorm_0"],
            batch_stats["BatchNorm_0"])
        _conv(sd, "auxiliary_branch.4", params["Conv_2"])
    return sd


def resnet_generator_state_dict_from_jax(params: Dict[str, Any]
                                         ) -> Dict[str, torch.Tensor]:
    """Flax ResnetGenerator params (IN2d: no batch statistics) -> state
    dict of ``rdfc_gan_torch.models.ResnetGenerator``; the inverse of
    ``tools/convert_torch_ckpt.py:convert_resnet_generator``. Flax names in
    call order: ``Conv_0`` the stem, ``Conv_1`` / ``Conv_2`` the downs,
    ``ResnetBlock_{i}``, ``TorchConvTranspose_{0,1}`` the ups (HWIO with
    the spatial flip), ``Conv_3`` the head, ``PReLU_{0..3}`` scalars."""
    sd: Dict[str, torch.Tensor] = {}
    n = sum(1 for k in params if k.startswith("ResnetBlock_"))
    for i, idx in enumerate((1, 4, 7, 17 + n)):
        _conv(sd, f"model.{idx}", params[f"Conv_{i}"])
    for i in range(n):
        blk = params[f"ResnetBlock_{i}"]
        _conv(sd, f"model.{10 + i}.conv_block.1", blk["Conv_0"])
        _conv(sd, f"model.{10 + i}.conv_block.5", blk["Conv_1"])
    for i, idx in enumerate((10 + n, 13 + n)):
        t = params[f"TorchConvTranspose_{i}"]
        sd[f"model.{idx}.weight"] = _t(np.asarray(t["kernel"])[::-1, ::-1]
                                       .transpose(2, 3, 0, 1))
        if "bias" in t:
            sd[f"model.{idx}.bias"] = _t(t["bias"])
    for i, idx in enumerate((6, 9, 12 + n, 15 + n)):
        sd[f"model.{idx}.weight"] = _t(
            np.asarray(params[f"PReLU_{i}"]["alpha"]).reshape(1))
    return sd


def rdfcgan_state_dicts_from_jax(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any],
                                 normal_depth: float = 2.2,
                                 adain_weighting: bool = False
                                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX RDFCGAN's ``params`` / ``batch_stats`` (keyed by net) ->
    {net: state dict} for the nets present of the six: G_A2B (NLSPN off, as
    the flagship), G_B2A, disc_A, disc_B, G_normal and G_label."""
    out = {}
    if "G_A2B" in params:
        out["G_A2B"] = rdf_generator_state_dict_from_jax(
            params["G_A2B"], batch_stats["G_A2B"], use_nlspn_refine=False,
            adain_weighting=adain_weighting)
    if "G_B2A" in params:
        out["G_B2A"] = resnet_generator_state_dict_from_jax(params["G_B2A"])
    for k in ("disc_A", "disc_B"):
        if k in params:
            out[k] = patchgan_state_dict_from_jax(params[k], batch_stats[k])
    if "G_normal" in params:
        out["G_normal"] = nnet_state_dict_from_jax(
            params["G_normal"], batch_stats["G_normal"], normal_depth)
    if "G_label" in params:
        out["G_label"] = pspnet_state_dict_from_jax(params["G_label"],
                                                    batch_stats["G_label"])
    return out


# the config section of an engine net whose name differs from it
# (``cfg.model.<section>``)
_SECTION_OF = {"disc_A": "D_A", "disc_B": "D_B", "G_normal": "Normal_G",
               "G_label": "Label_G"}


def model_options(cfg, name: str) -> dict:
    """``cfg.model``'s section of the engine net ``name`` as a dict."""
    sec = cfg.model.get(_SECTION_OF.get(name, name)) or {}
    return dict(sec.to_dict() if hasattr(sec, "to_dict") else sec)


def generator_options(cfg, name: str, module) -> dict:
    """The converter options of an RDFGenerator-cored net: the module's
    NLSPN switch, and ``adain_weighting`` and ``fuse`` from the config or,
    where it leaves them out, the module class's defaults."""
    opts = model_options(cfg, name)
    sig = inspect.signature(type(module)).parameters
    core = getattr(module, "core", module)

    def opt(key):
        return opts.get(key, sig[key].default)

    out = dict(adain_weighting=bool(opt("adain_weighting")),
               fuse=opt("fuse_depth_in_rgb_decoder"))
    if hasattr(core, "use_nlspn_refine"):
        out["use_nlspn_refine"] = bool(core.use_nlspn_refine)
    return out


def net_state_dict_from_jax(cfg, name: str, module, params: Dict[str, Any],
                            batch_stats: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The state dict of an engine's net ``name`` (``module``) from its
    Flax trees, through the converter of the module's class."""
    from ..models import (NNET, DCVGANGenerator, DCVGANGeneratorVanilla,
                          PatchGANDiscriminator, PixelGANDiscriminator,
                          PointNetDiscriminator, PSPNet, RDFGenerator,
                          ResnetGenerator)

    if isinstance(module, RDFGenerator):
        return rdf_generator_state_dict_from_jax(
            params, batch_stats, **generator_options(cfg, name, module))
    if isinstance(module, DCVGANGenerator):
        return dcv_gan_generator_state_dict_from_jax(
            params, batch_stats, **generator_options(cfg, name, module))
    if isinstance(module, DCVGANGeneratorVanilla):
        return dcv_gan_generator_vanilla_state_dict_from_jax(
            params, batch_stats, adain_weighting=generator_options(
                cfg, name, module)["adain_weighting"])
    if isinstance(module, ResnetGenerator):
        return resnet_generator_state_dict_from_jax(params)
    if isinstance(module, NNET):
        return nnet_state_dict_from_jax(
            params, batch_stats, model_options(cfg, name).get("depth", 2.2))
    if isinstance(module, PSPNet):
        return pspnet_state_dict_from_jax(params, batch_stats)
    for cls, fn in ((PatchGANDiscriminator, patchgan_state_dict_from_jax),
                    (PixelGANDiscriminator, pixelgan_state_dict_from_jax),
                    (PointNetDiscriminator, pointnet_state_dict_from_jax)):
        if isinstance(module, cls):
            return fn(params, batch_stats)
    raise NotImplementedError(f"{name}: no converter from the JAX tree of "
                              f"{type(module).__name__}")


# ------------------------------------------------------------ v1 family --
def _resnet_stage(sd, prefix, p, s):
    """A Flax ``ResNetStage`` (``BasicBlock_{j}`` or ``Bottleneck_{j}``)
    -> ``{prefix}.{j}.conv{k}/bn{k}[/downsample.{0,1}]``: the projection is
    the last conv of a block that has one more than its main path."""
    for blk, bp in p.items():
        j = int(blk.rsplit("_", 1)[1])
        bs = s[blk]
        main = 3 if blk.startswith("Bottleneck") else 2
        for k in range(main):
            _conv(sd, f"{prefix}.{j}.conv{k + 1}", bp[f"Conv_{k}"])
            _bn(sd, f"{prefix}.{j}.bn{k + 1}", bp[f"BatchNorm_{k}"],
                bs[f"BatchNorm_{k}"])
        if f"Conv_{main}" in bp:
            _conv(sd, f"{prefix}.{j}.downsample.0", bp[f"Conv_{main}"])
            _bn(sd, f"{prefix}.{j}.downsample.1", bp[f"BatchNorm_{main}"],
                bs[f"BatchNorm_{main}"])


def _stem(sd, prefix, p, s):
    _conv(sd, f"{prefix}.conv1", p["Conv_0"])
    _bn(sd, f"{prefix}.bn1", p["BatchNorm_0"], s["BatchNorm_0"])


def _conv_bn_act(sd, prefix, p, s):
    """A ``ConvBNActESA``: ``{prefix}.conv`` / ``{prefix}.bn``."""
    _conv(sd, f"{prefix}.conv", p["Conv_0"])
    _bn(sd, f"{prefix}.bn", p["BatchNorm_0"], s["BatchNorm_0"])


def _se(sd, prefix, p):
    _conv(sd, f"{prefix}.fc.0", p["Conv_0"])
    _conv(sd, f"{prefix}.fc.2", p["Conv_1"])


def _non_bottleneck(sd, prefix, p, s):
    """A ``NonBottleneck1D``: ``Conv_0-3`` the 3x1 / 1x3 pairs,
    ``BatchNorm_0-1`` (absent with ``use_in``), ``Conv_4`` the projection."""
    for k, name in enumerate(("conv3x1_1", "conv1x3_1", "conv3x1_2",
                              "conv1x3_2")):
        _conv(sd, f"{prefix}.{name}", p[f"Conv_{k}"])
    for k in range(2):
        if f"BatchNorm_{k}" in p:
            _bn(sd, f"{prefix}.bn{k + 1}", p[f"BatchNorm_{k}"],
                s[f"BatchNorm_{k}"])
    if "Conv_4" in p:
        _conv(sd, f"{prefix}.downsample", p["Conv_4"])


def _learned_upsample(sd, prefix, p):
    if "Conv_0" in p:
        _conv(sd, f"{prefix}.conv", p["Conv_0"])


def _decoder_module(sd, prefix, p, s):
    """An ``ESADecoderModule`` or a ``VanillaDecoderModule``."""
    _conv_bn_act(sd, f"{prefix}.conv3x3", p["ConvBNActESA_0"],
                 s["ConvBNActESA_0"])
    j = 0
    while f"NonBottleneck1D_{j}" in p:
        _non_bottleneck(sd, f"{prefix}.decoder_blocks.{j}",
                        p[f"NonBottleneck1D_{j}"],
                        s.get(f"NonBottleneck1D_{j}", {}))
        j += 1
    if "Conv_0" in p:
        _conv(sd, f"{prefix}.side_output", p["Conv_0"])
    _learned_upsample(sd, f"{prefix}.upsample", p.get("LearnedUpsample_0",
                                                      {}))


def _skip_projections(sd, prefix, p, s, skip_channels, decoder_channels):
    """The skips at 1/16, 1/8, 1/4 (``skip_layer3``, ``2``, ``1``) take
    ``ConvBNActESA_{next}`` in that order where their width differs from
    the decoder's."""
    n = 0
    for i, (c, d) in reversed(list(enumerate(zip(skip_channels,
                                                 decoder_channels[2::-1])))):
        if c != d:
            _conv_bn_act(sd, f"{prefix}skip_layer{i + 1}",
                         p[f"ConvBNActESA_{n}"], s[f"ConvBNActESA_{n}"])
            n += 1
    return n


def _esanet_decoder(sd, pre, p, s, skip_channels, decoder_channels):
    """Skip projections, the three decoders, the class conv and the two
    upsamplings of an ESANet."""
    _skip_projections(sd, pre, p, s, skip_channels, decoder_channels)
    for i in range(3):
        _decoder_module(sd, f"{pre}decoder{i + 1}",
                        p[f"ESADecoderModule_{i}"],
                        s[f"ESADecoderModule_{i}"])
    _conv(sd, f"{pre}conv_out", p["Conv_0"])
    for i in range(2):
        _learned_upsample(sd, f"{pre}upsample{i + 1}",
                          p.get(f"LearnedUpsample_{i}", {}))


def _skip_widths(p) -> tuple:
    """Widths of the torso's 1/4, 1/8 and 1/16 skips (BasicBlock or
    Bottleneck stages behind the stem)."""
    c = np.asarray(p["ResNetStem_0"]["Conv_0"]["kernel"]).shape[-1]
    e = 4 if any(k.startswith("Bottleneck") for k in p["ResNetStage_0"]) \
        else 1
    return (c * e, 2 * c * e, 4 * c * e)


def esanet_state_dict_from_jax(params: Dict[str, Any],
                               batch_stats: Dict[str, Any],
                               prefix: str = "",
                               two_modality: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """Flax ``ESANetOneModality`` (or, with ``two_modality``, ``ESANet``)
    (params, batch_stats) numpy trees -> state dict of
    ``rdfc_gan_torch.models.esanet``'s module, its keys under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    p, s = params, batch_stats
    pre = prefix
    if two_modality:
        _stem(sd, f"{pre}stem_rgb", p["ResNetStem_0"], s["ResNetStem_0"])
        _stem(sd, f"{pre}stem_depth", p["ResNetStem_1"], s["ResNetStem_1"])
        for br, off in (("rgb", 0), ("depth", 4)):
            for i in range(4):
                k = f"ResNetStage_{i + off}"
                _resnet_stage(sd, f"{pre}{br}_layer{i + 1}", p[k], s[k])
        for i in range(5):
            f = p[f"SqueezeAndExciteFusionAdd_{i}"]
            _se(sd, f"{pre}se_layer{i}.se_rgb", f["SqueezeAndExcitation_0"])
            _se(sd, f"{pre}se_layer{i}.se_depth",
                f["SqueezeAndExcitation_1"])
    else:
        _stem(sd, f"{pre}stem", p["ResNetStem_0"], s["ResNetStem_0"])
        for i in range(4):
            k = f"ResNetStage_{i}"
            _resnet_stage(sd, f"{pre}layer{i + 1}", p[k], s[k])
        for i in range(5):
            if f"SqueezeAndExcitation_{i}" in p:
                _se(sd, f"{pre}se_layer{i}", p[f"SqueezeAndExcitation_{i}"])
    n_ppm = 0
    if "PyramidPoolingModule_0" in p:
        pp, ps = p["PyramidPoolingModule_0"], s["PyramidPoolingModule_0"]
        n_ppm = sum(1 for k in pp if k.startswith("ConvBNActESA_"))
        for i in range(n_ppm - 1):
            _conv_bn_act(sd, f"{pre}context_module.features.{i}.1",
                         pp[f"ConvBNActESA_{i}"], ps[f"ConvBNActESA_{i}"])
        _conv_bn_act(sd, f"{pre}context_module.final_conv",
                     pp[f"ConvBNActESA_{n_ppm - 1}"],
                     ps[f"ConvBNActESA_{n_ppm - 1}"])
    decoder_channels = [np.asarray(p[f"ESADecoderModule_{i}"][
        "ConvBNActESA_0"]["Conv_0"]["kernel"]).shape[-1] for i in range(3)]
    _esanet_decoder(sd, pre, p, s, _skip_widths(p), decoder_channels)
    return sd


def dcv_gan_generator_state_dict_from_jax(params: Dict[str, Any],
                                          batch_stats: Dict[str, Any],
                                          use_nlspn_refine: bool = True,
                                          adain_weighting: bool = False,
                                          fuse: str = "WAdaIN"
                                          ) -> Dict[str, torch.Tensor]:
    """Flax ``DCVGANGenerator`` trees -> state dict of
    ``rdfc_gan_torch.models.DCVGANGenerator``: ``global_guidance_module``
    through ``esanet_state_dict_from_jax``, ``core`` through
    ``rdf_generator_state_dict_from_jax`` (its fused stem undone at the
    guidance's channel count)."""
    sd = {}
    if "global_guidance_module" in params:
        sd.update(esanet_state_dict_from_jax(
            params["global_guidance_module"],
            batch_stats["global_guidance_module"],
            prefix="global_guidance_module."))
    core = rdf_generator_state_dict_from_jax(
        params["core"], batch_stats["core"],
        use_nlspn_refine=use_nlspn_refine, adain_weighting=adain_weighting,
        fuse=fuse)
    sd.update({f"core.{k}": v for k, v in core.items()})
    return sd


def dcv_gan_generator_vanilla_state_dict_from_jax(
        params: Dict[str, Any], batch_stats: Dict[str, Any],
        adain_weighting: bool = False) -> Dict[str, torch.Tensor]:
    """Flax ``DCVGANGeneratorVanilla`` trees -> state dict of
    ``rdfc_gan_torch.models.DCVGANGeneratorVanilla``."""
    sd: Dict[str, torch.Tensor] = {}
    p, s = params, batch_stats
    if "ESANetOneModality_0" in p:
        sd.update(esanet_state_dict_from_jax(
            p["ESANetOneModality_0"], s["ESANetOneModality_0"],
            prefix="global_guidance_module."))
    for k, name in (("ResNetStem_0", "rgb_stem"),
                    ("ResNetStem_1", "depth_stem")):
        _stem(sd, name, p[k], s[k])
    for br, off in (("rgb", 0), ("depth", 4)):
        for i in range(4):
            k = f"ResNetStage_{i + off}"
            _resnet_stage(sd, f"{br}_layer{i + 1}", p[k], s[k])
    rcd = [np.asarray(p[f"VanillaDecoderModule_{2 * i}"]["ConvBNActESA_0"][
        "Conv_0"]["kernel"]).shape[-1] for i in range(3)]
    _skip_projections(sd, "", p, s, _skip_widths(p), rcd)
    for i in range(10):
        br = ("rgb", "depth")[i % 2]
        _decoder_module(sd, f"{br}_decoder{i // 2 + 1}",
                        p[f"VanillaDecoderModule_{i}"],
                        s[f"VanillaDecoderModule_{i}"])
    for i in range(6):
        if f"AdaptiveInstanceNorm_{i}" in p:
            _wadain(sd, f"fuse_layer{i + 1}", p[f"AdaptiveInstanceNorm_{i}"],
                    adain_weighting)
    for i, name in enumerate(("rgb_depth_head", "rgb_conf_head",
                              "depth_depth_head", "depth_conf_head")):
        _conv(sd, name, p[f"Conv_{i}"])
    return sd


def pixelgan_state_dict_from_jax(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """Flax ``PixelGANDiscriminator`` trees -> ``net.{0,2,3,5}``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate((0, 2, 5)):
        _conv(sd, f"net.{idx}", params[f"Conv_{i}"])
    _bn(sd, "net.3", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    return sd


def pointnet_state_dict_from_jax(params: Dict[str, Any],
                                 batch_stats: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """Flax ``PointNetDiscriminator`` trees -> ``fc1-7`` (Dense (in, out)
    -> Linear (out, in)) and ``bn1-6`` (BatchNorm2d over (B N, C, 1, 1))."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(7):
        d = params[f"Dense_{i}"]
        sd[f"fc{i + 1}.weight"] = _t(np.asarray(d["kernel"]).T)
        sd[f"fc{i + 1}.bias"] = _t(d["bias"])
        if i < 6:
            _bn(sd, f"bn{i + 1}", params[f"BatchNorm_{i}"],
                batch_stats[f"BatchNorm_{i}"])
    return sd


# --------------------------------------------------- deformable ops --
def deform_conv_weight_from_jax(w, groups: int, kh: int,
                                kw: int) -> torch.Tensor:
    """The JAX ``modulated_deform_conv`` weight (K, Cin/g, Cout) -> the
    port's (Cout, Cin/g, kh, kw), the reference DCNv2 schema.

    The JAX function reads its weight, for groups > 1, as
    ``reshape(K, g, Cin/g, Cout/g)`` (rdfc_gan_tpu/ops/deform.py:160): the
    weight of output j of group gi, input c of that group and tap k is
    ``w.reshape(K, g, Cin/g, Cout/g)[k, gi, c, j]``, not ``w[k, c, gi *
    Cout/g + j]`` as an HWIO layout would have it (the two agree only where
    Cin/g = 1). This takes the JAX function's own reading, so the port
    equals it at every ``groups``."""
    w = np.asarray(w)
    K, cg, cout = w.shape
    if K != kh * kw or cout % groups:
        raise ValueError(f"(K={kh * kw}, Cin/g, Cout) with groups={groups} "
                         f"dividing Cout expected, got {w.shape}")
    og = cout // groups
    return _t(w.reshape(K, groups, cg, og).transpose(1, 3, 2, 0).reshape(
        cout, cg, kh, kw))


def deform_offsets_from_jax(offsets) -> torch.Tensor:
    """JAX offsets (B, H, W, K, 2) -> the port's (B, K, 2, H, W); (dy, dx)
    stay in that order."""
    return _t(np.asarray(offsets).transpose(0, 3, 4, 1, 2))


def deform_mask_from_jax(mask) -> torch.Tensor:
    """A JAX modulation mask (B, H, W, K) -> the port's (B, K, H, W)."""
    return _t(np.asarray(mask).transpose(0, 3, 1, 2))
