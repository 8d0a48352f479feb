"""The port's (the reference's) state dicts -> the JAX package's Flax
``params`` / ``batch_stats`` trees: the inverse of ``utils.convert``.

The port's own copy of what it needs from the JAX package's
``utils/torch_convert.py`` (``convert_rdf_generator`` :270,
``convert_pspnet`` :396, ``convert_nnet`` :532 and their helpers) and of
``tools/convert_torch_ckpt.py``'s ``convert_patchgan`` and
``convert_resnet_generator`` (:34-128): the port imports nothing of the
JAX package. They take the reference's state-dict names, which are the
port's, as numpy arrays, and return ``{"params": tree, "batch_stats":
tree}``. Each only rearranges values (transposes, spatial flips, channel
permutations, slices and concatenations); two entries are reshaped to
shape () (``aff_scale_const``, the PReLU alphas), and the reference's
entries that the JAX trees lack are dropped: ``fuse_layer5`` (never used
by the forward), NNET's ``bn2`` (never read by the decoder), the frozen
NLSPN dummies (w, b, w_conf) and BatchNorm's ``num_batches_tracked``.

``convert_rdf_generator`` also takes the port's ``fuse`` variants
(``fuse_depth_in_rgb_decoder``; the JAX function knows only W-AdaIN):
INFuse's 1x1 conv as ``fuse_layers_{i}.Conv_0``, AdaIN's nothing.
The v1 family (``convert_esanet``, ``convert_dcv_gan_generator``,
``convert_dcv_gan_generator_vanilla``, ``convert_pixelgan``,
``convert_pointnet``) inverts ``utils/convert.py``'s v1 converters: the
same compact Flax names, built from the names the state dict has.
``net_tree_to_jax`` picks the converter of an engine's net.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..models.normal_net import B0_BLOCKS, round_repeats


def walk_state_dict(sd: Dict[str, np.ndarray]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """Group flat names by module prefix: 'a.b.weight' -> {'a.b': {...}}."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in sd.items():
        prefix, leaf = name.rsplit(".", 1)
        groups.setdefault(prefix, {})[leaf] = arr
    return groups


def convert_convtranspose_weight(arr: np.ndarray) -> np.ndarray:
    """ConvTranspose2d (Cin, Cout, kh, kw) -> Flax (kh, kw, Cin, Cout) with
    the spatial flip (Flax's ConvTranspose correlates)."""
    return np.asarray(arr).transpose(2, 3, 0, 1)[::-1, ::-1]


def _bn(g: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {
        "params": {"scale": g["weight"], "bias": g["bias"]},
        "batch_stats": {"mean": g["running_mean"], "var": g["running_var"]},
    }


def _conv_entry(g: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    e = {"kernel": np.ascontiguousarray(g["weight"].transpose(2, 3, 1, 0))}
    if "bias" in g:
        e["bias"] = g["bias"]
    return e


def _tconv_entry(g: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    e = {"kernel": convert_convtranspose_weight(g["weight"]).copy()}
    if "bias" in g:
        e["bias"] = g["bias"]
    return e


def _put_bn(params: Dict, stats: Dict, name: str, g: Dict[str, np.ndarray]):
    b = _bn(g)
    params[name] = b["params"]
    stats[name] = b["batch_stats"]


def _basicblock_blocks(groups, layer_prefix: str):
    """BasicBlocks (conv1/bn1/conv2/bn2/downsample.{0,1}) -> Flax
    ``BasicBlock_{i}`` (Conv_0/1 + BatchNorm_0/1, the projection at
    Conv_2/BatchNorm_2)."""
    params, stats = {}, {}
    bi = 0
    while f"{layer_prefix}.{bi}.conv1" in groups:
        bp = f"{layer_prefix}.{bi}"
        p, st = {}, {}
        for ci in range(2):
            p[f"Conv_{ci}"] = _conv_entry(groups[f"{bp}.conv{ci + 1}"])
            _put_bn(p, st, f"BatchNorm_{ci}", groups[f"{bp}.bn{ci + 1}"])
        if f"{bp}.downsample.0" in groups:
            p["Conv_2"] = _conv_entry(groups[f"{bp}.downsample.0"])
            _put_bn(p, st, "BatchNorm_2", groups[f"{bp}.downsample.1"])
        params[f"BasicBlock_{bi}"] = p
        stats[f"BasicBlock_{bi}"] = st
        bi += 1
    return params, stats


def _convbnact(groups, prefix, bn=True):
    p, st = {"Conv_0": _conv_entry(groups[f"{prefix}.0"])}, {}
    if bn:
        _put_bn(p, st, "BatchNorm_0", groups[f"{prefix}.1"])
    return p, st


def _encoder_decoder(groups, prefix):
    """An EncoderDecoder -> Flax en2..en6 + de5..de2."""
    p, st = {}, {}
    for en in ("en2", "en3", "en4", "en5"):
        p[en], st[en] = _basicblock_blocks(groups, f"{prefix}.{en}")
    p["en6"], st["en6"] = _convbnact(groups, f"{prefix}.en6")
    for de in ("de5", "de4", "de3", "de2"):
        dp = {"TorchConvTranspose_0": _tconv_entry(groups[f"{prefix}.{de}.0"])}
        ds = {}
        _put_bn(dp, ds, "BatchNorm_0", groups[f"{prefix}.{de}.1"])
        p[de] = dp
        st[de] = ds
    return p, st


def nlspn_offset_channel_perm(num: int) -> np.ndarray:
    """The reference's conv_offset_aff output channels (tap i reads (2i,
    2i+1), then the affinities) -> the JAX order [off_y | off_x | aff]."""
    return np.asarray(
        [2 * i for i in range(num)]
        + [2 * i + 1 for i in range(num)]
        + list(range(2 * num, 3 * num)), np.int64)


def convert_rdf_generator(sd: Dict[str, np.ndarray],
                          use_nlspn_refine: bool = True,
                          adain_weighting: bool = False,
                          fuse: str = "WAdaIN"):
    """G_A2B (RDFGenerator) state dict -> Flax trees: the fused stem, the
    two EncoderDecoders, the fused dec1 (heads concatenated on the output
    channels) and dec0 (each head's kernel split at its own channels), the
    NLSPN offset permutation, EqualLinear's ``weight_orig`` transposed
    (both sides scale at call time)."""
    groups = walk_state_dict(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def hwio(prefix):
        return groups[prefix]["weight"].transpose(2, 3, 1, 0)

    params["stem_fused"] = {
        "kernel_0_0": np.ascontiguousarray(hwio("rgb_branch_en1.0")),
        "bias_0": groups["rgb_branch_en1.0"]["bias"],
        "kernel_1_0": np.ascontiguousarray(hwio("depth_branch_en1_rgb.0")),
        "bias_1": groups["depth_branch_en1_rgb.0"]["bias"],
        "kernel_2_1": np.ascontiguousarray(hwio("depth_branch_en1_depth.0")),
        "bias_2": groups["depth_branch_en1_depth.0"]["bias"],
    }
    params["rgb_ed"], stats["rgb_ed"] = _encoder_decoder(
        groups, "rgb_branch_encoder_decoder")
    params["depth_ed"], stats["depth_ed"] = _encoder_decoder(
        groups, "depth_branch_encoder_decoder")

    def fused_dec1(name, prefixes):
        ks = [hwio(f"{p}.0") for p in prefixes]
        bns = [groups[f"{p}.1"] for p in prefixes]
        params[name] = {
            "Conv_0": {"kernel": np.ascontiguousarray(
                np.concatenate(ks, axis=3))},
            "BatchNorm_0": {
                "scale": np.concatenate([b["weight"] for b in bns]),
                "bias": np.concatenate([b["bias"] for b in bns]),
            },
        }
        stats[name] = {"BatchNorm_0": {
            "mean": np.concatenate([b["running_mean"] for b in bns]),
            "var": np.concatenate([b["running_var"] for b in bns]),
        }}

    def fused_dec0(name, prefixes, own_chans, shared_idx):
        sub = {}
        for i, (p, oc) in enumerate(zip(prefixes, own_chans)):
            k = hwio(f"{p}.0")
            sub[f"kernel_{i}_{i}"] = np.ascontiguousarray(k[:, :, :oc])
            sub[f"kernel_{i}_{shared_idx}"] = np.ascontiguousarray(
                k[:, :, oc:])
            sub[f"bias_{i}"] = groups[f"{p}.0"]["bias"]
        params[name] = sub

    fused_dec1("rgb_dec1", ["rgb_pred_dec1", "rgb_conf_dec1"])
    fused_dec0("rgb_dec0", ["rgb_pred_dec0", "rgb_conf_dec0"],
               own_chans=(64, 32), shared_idx=2)
    if use_nlspn_refine:
        fused_dec1("depth_dec1", ["id_dec1", "gd_dec1", "cf_dec1"])
        fused_dec0("depth_dec0", ["id_dec0", "gd_dec0", "cf_dec0"],
                   own_chans=(64, 64, 32), shared_idx=3)
        oa = groups["nlspn_refine_module.prop_layer.conv_offset_aff"]
        perm = nlspn_offset_channel_perm(oa["bias"].shape[0] // 3)
        params["conv_offset_aff"] = {
            "kernel": np.ascontiguousarray(
                oa["weight"].transpose(2, 3, 1, 0)[..., perm]),
            "bias": oa["bias"][perm],
        }
        params["aff_scale_const"] = np.asarray(
            sd["nlspn_refine_module.prop_layer.aff_scale_const"]
        ).reshape(())
    else:
        fused_dec1("depth_dec1", ["id_dec1", "cf_dec1"])
        fused_dec0("depth_dec0", ["id_dec0", "cf_dec0"],
                   own_chans=(64, 32), shared_idx=2)

    for i in range(4 if fuse != "AdaIN" else 0):  # fuse_layer5 is unused
        pre = f"fuse_layer{i + 1}"
        if fuse == "IN":
            params[f"fuse_layers_{i}"] = {
                "Conv_0": _conv_entry(groups[f"{pre}.conv"])}
            continue
        fl = f"{pre}.style.linear"
        sub = {"EqualLinear_0": {
            "weight": np.asarray(groups[fl]["weight_orig"]).T,
            "bias": groups[fl]["bias"],
        }}
        if adain_weighting:
            sub["Conv_0"] = _conv_entry(groups[f"{pre}.gamma_weight_layer"])
            sub["Conv_1"] = _conv_entry(groups[f"{pre}.beta_weight_layer"])
        params[f"fuse_layers_{i}"] = sub
    return {"params": params, "batch_stats": stats}


def _bottleneck_blocks(groups, layer_prefix: str):
    """Bottlenecks (conv1-3/bn1-3 + downsample) -> Flax ``Bottleneck_{i}``
    (Conv_0..2 + BatchNorm_0..2, the projection at Conv_3/BatchNorm_3)."""
    params, stats = {}, {}
    bi = 0
    while f"{layer_prefix}.{bi}.conv1" in groups:
        bp = f"{layer_prefix}.{bi}"
        p, st = {}, {}
        for ci in range(3):
            p[f"Conv_{ci}"] = _conv_entry(groups[f"{bp}.conv{ci + 1}"])
            _put_bn(p, st, f"BatchNorm_{ci}", groups[f"{bp}.bn{ci + 1}"])
        if f"{bp}.downsample.0" in groups:
            p["Conv_3"] = _conv_entry(groups[f"{bp}.downsample.0"])
            _put_bn(p, st, "BatchNorm_3", groups[f"{bp}.downsample.1"])
        params[f"Bottleneck_{bi}"] = p
        stats[f"Bottleneck_{bi}"] = st
        bi += 1
    return params, stats


def convert_pspnet(sd: Dict[str, np.ndarray]):
    """G_label (PSPNet) state dict -> Flax trees: the deep stem, the
    dilated-R50 stages, the PSP head, the class conv and, where the dict
    has it, the aux head."""
    groups = walk_state_dict(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    stem_p, stem_s = {}, {}
    for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
        stem_p[f"Conv_{i}"] = _conv_entry(groups[f"initial.0.{ci}"])
        _put_bn(stem_p, stem_s, f"BatchNorm_{i}", groups[f"initial.0.{bi}"])
    stem_p["Conv_2"] = _conv_entry(groups["initial.0.6"])
    _put_bn(stem_p, stem_s, "BatchNorm_2", groups["initial.1"])
    params["DeepStem_0"] = stem_p
    stats["DeepStem_0"] = stem_s

    for li in range(4):
        p, st = _bottleneck_blocks(groups, f"layer{li + 1}")
        params[f"ResNetStage_{li}"] = p
        stats[f"ResNetStage_{li}"] = st

    psp_p, psp_s = {}, {}
    nbins = 0
    while f"master_branch.0.stages.{nbins}.1" in groups:
        psp_p[f"Conv_{nbins}"] = _conv_entry(
            groups[f"master_branch.0.stages.{nbins}.1"])
        _put_bn(psp_p, psp_s, f"BatchNorm_{nbins}",
                groups[f"master_branch.0.stages.{nbins}.2"])
        nbins += 1
    psp_p[f"Conv_{nbins}"] = _conv_entry(
        groups["master_branch.0.bottleneck.0"])
    _put_bn(psp_p, psp_s, f"BatchNorm_{nbins}",
            groups["master_branch.0.bottleneck.1"])
    params["PSPModule_0"] = psp_p
    stats["PSPModule_0"] = psp_s

    params["Conv_0"] = _conv_entry(groups["master_branch.1"])
    if "auxiliary_branch.0" in groups:
        params["Conv_1"] = _conv_entry(groups["auxiliary_branch.0"])
        _put_bn(params, stats, "BatchNorm_0", groups["auxiliary_branch.1"])
        params["Conv_2"] = _conv_entry(groups["auxiliary_branch.4"])
    return {"params": params, "batch_stats": stats}


def _effnet_encoder_trees(groups, pre: str, depth: float):
    """The timm EfficientNet layout (conv_stem/bn1/blocks.s.b.*/conv_head)
    -> Flax ``EfficientNetEncoder`` trees."""
    dot = pre + "." if pre else ""
    ep, es = {}, {}
    ep["Conv_0"] = _conv_entry(groups[f"{dot}conv_stem"])
    _put_bn(ep, es, "BatchNorm_0", groups[f"{dot}bn1"])
    mb = 0
    for si, (e, _c, r, _s, _k) in enumerate(B0_BLOCKS):
        for bi in range(round_repeats(r, depth)):
            bp = f"{dot}blocks.{si}.{bi}"
            p, st = {}, {}
            se = {"Conv_0": _conv_entry(groups[f"{bp}.se.conv_reduce"]),
                  "Conv_1": _conv_entry(groups[f"{bp}.se.conv_expand"])}
            if e != 1:  # InvertedResidual
                p["Conv_0"] = _conv_entry(groups[f"{bp}.conv_pw"])
                _put_bn(p, st, "BatchNorm_0", groups[f"{bp}.bn1"])
                p["Conv_1"] = _conv_entry(groups[f"{bp}.conv_dw"])
                _put_bn(p, st, "BatchNorm_1", groups[f"{bp}.bn2"])
                p["SqueezeExcite_0"] = se
                p["Conv_2"] = _conv_entry(groups[f"{bp}.conv_pwl"])
                _put_bn(p, st, "BatchNorm_2", groups[f"{bp}.bn3"])
            else:  # DepthwiseSeparable
                p["Conv_0"] = _conv_entry(groups[f"{bp}.conv_dw"])
                _put_bn(p, st, "BatchNorm_0", groups[f"{bp}.bn1"])
                p["SqueezeExcite_0"] = se
                p["Conv_1"] = _conv_entry(groups[f"{bp}.conv_pw"])
                _put_bn(p, st, "BatchNorm_1", groups[f"{bp}.bn2"])
            ep[f"MBConv_{mb}"] = p
            es[f"MBConv_{mb}"] = st
            mb += 1
    ep["Conv_1"] = _conv_entry(groups[f"{dot}conv_head"])
    return ep, es


def convert_nnet(sd: Dict[str, np.ndarray], depth: float = 2.2):
    """G_normal (NNET) state dict -> Flax trees: the EfficientNet encoder
    (its ``bn2`` dropped: the decoder taps the conv_head output) and the
    decoder's conv2 / up{1-4} / conv3."""
    groups = walk_state_dict(sd)
    ep, es = _effnet_encoder_trees(groups, "encoder.original_model", depth)
    dp, ds = {}, {}
    dp["Conv_0"] = _conv_entry(groups["decoder.conv2"])
    for i in range(4):
        up, ust = {}, {}
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            up[f"Conv_{j}"] = _conv_entry(
                groups[f"decoder.up{i + 1}._net.{ci}"])
            _put_bn(up, ust, f"BatchNorm_{j}",
                    groups[f"decoder.up{i + 1}._net.{bi}"])
        dp[f"UpSampleBN_{i}"] = up
        ds[f"UpSampleBN_{i}"] = ust
    dp["Conv_1"] = _conv_entry(groups["decoder.conv3"])
    return {
        "params": {"EfficientNetEncoder_0": ep, "NormalDecoder_0": dp},
        "batch_stats": {"EfficientNetEncoder_0": es, "NormalDecoder_0": ds},
    }


def convert_patchgan(sd: Dict[str, np.ndarray], prefix: str = "model"):
    """PatchGAN (``model.{i}.conv`` / ``model.{i}.bn``) -> Flax ``Conv_{i}``
    + ``BatchNorm_{j}`` (BN on the middle layers only)."""
    groups = walk_state_dict(sd)
    params, stats = {}, {}
    conv_i = bn_i = i = 0
    while True:
        conv_key = next((k for k in (f"{prefix}.{i}.conv", f"{prefix}.{i}")
                         if k in groups), None)
        if conv_key is None:
            break
        g = groups[conv_key]
        entry = {"kernel": g["weight"].transpose(2, 3, 1, 0)}
        if "bias" in g:
            entry["bias"] = g["bias"]
        params[f"Conv_{conv_i}"] = entry
        conv_i += 1
        bn_key = f"{prefix}.{i}.bn"
        if bn_key in groups:
            _put_bn(params, stats, f"BatchNorm_{bn_i}", groups[bn_key])
            bn_i += 1
        i += 1
    return {"params": params, "batch_stats": stats}


def convert_resnet_generator(sd: Dict[str, np.ndarray],
                             prefix: str = "model"):
    """ResnetGenerator (Sequential indices) -> Flax names in call order:
    Conv_0..2 the stem and downs, ``ResnetBlock_{i}.{Conv_0,Conv_1}``,
    ``TorchConvTranspose_{0,1}`` the ups, the head conv, ``PReLU_{i}`` the
    alphas as shape (). Classified by index against the ResnetBlock span;
    the InstanceNorms carry no parameters."""
    groups = walk_state_dict(sd)
    plain, blocks, prelus = [], [], []
    for i in sorted({int(k.split(".")[1]) for k in sd
                     if k.startswith(prefix + ".")}):
        g = groups.get(f"{prefix}.{i}")
        if g is None:
            b1 = groups.get(f"{prefix}.{i}.conv_block.1")
            if b1 is not None:
                blocks.append((i, b1, groups[f"{prefix}.{i}.conv_block.5"]))
            continue
        w = g.get("weight")
        if w is None:
            continue
        if w.ndim == 4:
            plain.append((i, g))
        elif w.ndim <= 1 and w.size == 1:
            prelus.append(g)
    if not blocks:
        raise ValueError("no ResnetBlocks: not a ResnetGenerator state dict")
    first_blk, last_blk = blocks[0][0], blocks[-1][0]
    stem_downs = [g for i, g in plain if i < first_blk]
    after = [g for i, g in plain if i > last_blk]
    ups, final = after[:-1], after[-1]
    params = {}
    for ci, g in enumerate(stem_downs):
        params[f"Conv_{ci}"] = _conv_entry(g)
    for bi, (_, b1, b2) in enumerate(blocks):
        params[f"ResnetBlock_{bi}"] = {
            "Conv_0": _conv_entry(b1), "Conv_1": _conv_entry(b2)}
    for ti, g in enumerate(ups):
        params[f"TorchConvTranspose_{ti}"] = _tconv_entry(g)
    params[f"Conv_{len(stem_downs)}"] = _conv_entry(final)
    for pi, g in enumerate(prelus):
        params[f"PReLU_{pi}"] = {"alpha": g["weight"].reshape(())}
    return {"params": params, "batch_stats": {}}


# ------------------------------------------------------------ v1 family --
# The inverses of ``utils/convert.py``'s v1 converters (``_resnet_stage``,
# ``_esanet_decoder``, ``esanet_state_dict_from_jax`` and the rest): each
# walks the state dict's names and rebuilds the Flax compact names those
# functions read, in their creation order. A module the dict lacks (a
# parameterless ``LearnedUpsample``, an eval-mode tree's side conv, a
# BatchNorm-free ``NonBottleneck1D``) has no entry, as in the Flax tree.
def _sub(params: Dict, stats: Dict, name: str, p: Dict, st: Dict):
    """Put a submodule's trees under ``name``; its batch statistics only
    where it has any, as flax keeps them."""
    params[name] = p
    if st:
        stats[name] = st


def _v1_stem(groups, prefix):
    p, st = {"Conv_0": _conv_entry(groups[f"{prefix}.conv1"])}, {}
    _put_bn(p, st, "BatchNorm_0", groups[f"{prefix}.bn1"])
    return p, st


def _v1_stage(groups, prefix):
    """``{prefix}.{j}.conv{k}/bn{k}[/downsample]`` -> ``BasicBlock_{j}`` or
    ``Bottleneck_{j}`` (a third main conv makes a Bottleneck)."""
    if f"{prefix}.0.conv3" in groups:
        return _bottleneck_blocks(groups, prefix)
    return _basicblock_blocks(groups, prefix)


def _v1_conv_bn_act(groups, prefix):
    p, st = {"Conv_0": _conv_entry(groups[f"{prefix}.conv"])}, {}
    _put_bn(p, st, "BatchNorm_0", groups[f"{prefix}.bn"])
    return p, st


def _v1_se(groups, prefix):
    return {"Conv_0": _conv_entry(groups[f"{prefix}.fc.0"]),
            "Conv_1": _conv_entry(groups[f"{prefix}.fc.2"])}


def _v1_non_bottleneck(groups, prefix):
    p, st = {}, {}
    for k, name in enumerate(("conv3x1_1", "conv1x3_1", "conv3x1_2",
                              "conv1x3_2")):
        p[f"Conv_{k}"] = _conv_entry(groups[f"{prefix}.{name}"])
    for k in range(2):
        if f"{prefix}.bn{k + 1}" in groups:
            _put_bn(p, st, f"BatchNorm_{k}", groups[f"{prefix}.bn{k + 1}"])
    if f"{prefix}.downsample" in groups:
        p["Conv_4"] = _conv_entry(groups[f"{prefix}.downsample"])
    return p, st


def _v1_upsample(groups, params, prefix, name):
    if f"{prefix}.conv" in groups:
        params[name] = {"Conv_0": _conv_entry(groups[f"{prefix}.conv"])}


def _v1_decoder_module(groups, prefix):
    """An ``ESADecoderModule`` or a ``VanillaDecoderModule``."""
    p, st = {}, {}
    _sub(p, st, "ConvBNActESA_0", *_v1_conv_bn_act(groups,
                                                   f"{prefix}.conv3x3"))
    j = 0
    while f"{prefix}.decoder_blocks.{j}.conv3x1_1" in groups:
        _sub(p, st, f"NonBottleneck1D_{j}", *_v1_non_bottleneck(
            groups, f"{prefix}.decoder_blocks.{j}"))
        j += 1
    if f"{prefix}.side_output" in groups:
        p["Conv_0"] = _conv_entry(groups[f"{prefix}.side_output"])
    _v1_upsample(groups, p, f"{prefix}.upsample", "LearnedUpsample_0")
    return p, st


def _v1_skips(groups, params, stats, pre):
    """``skip_layer3``, ``2``, ``1``, those the dict has, as
    ``ConvBNActESA_{n}`` in that order."""
    n = 0
    for i in (2, 1, 0):
        if f"{pre}skip_layer{i + 1}.conv" in groups:
            _sub(params, stats, f"ConvBNActESA_{n}", *_v1_conv_bn_act(
                groups, f"{pre}skip_layer{i + 1}"))
            n += 1


def _esanet_trees(groups, pre: str = "", two_modality: bool = False):
    """The inverse of ``convert.esanet_state_dict_from_jax``: an ESANet's
    entries under ``pre`` -> its Flax (params, batch_stats)."""
    p, st = {}, {}
    if two_modality:
        _sub(p, st, "ResNetStem_0", *_v1_stem(groups, f"{pre}stem_rgb"))
        _sub(p, st, "ResNetStem_1", *_v1_stem(groups, f"{pre}stem_depth"))
        for br, off in (("rgb", 0), ("depth", 4)):
            for i in range(4):
                _sub(p, st, f"ResNetStage_{i + off}", *_v1_stage(
                    groups, f"{pre}{br}_layer{i + 1}"))
        for i in range(5):
            p[f"SqueezeAndExciteFusionAdd_{i}"] = {
                "SqueezeAndExcitation_0": _v1_se(
                    groups, f"{pre}se_layer{i}.se_rgb"),
                "SqueezeAndExcitation_1": _v1_se(
                    groups, f"{pre}se_layer{i}.se_depth")}
    else:
        _sub(p, st, "ResNetStem_0", *_v1_stem(groups, f"{pre}stem"))
        for i in range(4):
            _sub(p, st, f"ResNetStage_{i}", *_v1_stage(
                groups, f"{pre}layer{i + 1}"))
        for i in range(5):
            if f"{pre}se_layer{i}.fc.0" in groups:
                p[f"SqueezeAndExcitation_{i}"] = _v1_se(groups,
                                                        f"{pre}se_layer{i}")
    if f"{pre}context_module.final_conv.conv" in groups:
        pp, ps = {}, {}
        n = 0
        while f"{pre}context_module.features.{n}.1.conv" in groups:
            _sub(pp, ps, f"ConvBNActESA_{n}", *_v1_conv_bn_act(
                groups, f"{pre}context_module.features.{n}.1"))
            n += 1
        _sub(pp, ps, f"ConvBNActESA_{n}", *_v1_conv_bn_act(
            groups, f"{pre}context_module.final_conv"))
        _sub(p, st, "PyramidPoolingModule_0", pp, ps)
    _v1_skips(groups, p, st, pre)
    for i in range(3):
        _sub(p, st, f"ESADecoderModule_{i}", *_v1_decoder_module(
            groups, f"{pre}decoder{i + 1}"))
    p["Conv_0"] = _conv_entry(groups[f"{pre}conv_out"])
    for i in range(2):
        _v1_upsample(groups, p, f"{pre}upsample{i + 1}",
                     f"LearnedUpsample_{i}")
    return p, st


def convert_esanet(sd: Dict[str, np.ndarray], prefix: str = "",
                   two_modality: bool = False):
    """``ESANetOneModality`` (or, with ``two_modality``, ``ESANet``) state
    dict, its keys under ``prefix`` -> Flax trees."""
    p, st = _esanet_trees(walk_state_dict(sd), prefix, two_modality)
    return {"params": p, "batch_stats": st}


def convert_dcv_gan_generator(sd: Dict[str, np.ndarray],
                              use_nlspn_refine: bool = True,
                              adain_weighting: bool = False,
                              fuse: str = "WAdaIN"):
    """``DCVGANGenerator`` state dict -> Flax trees: ``core`` through
    ``convert_rdf_generator``, ``global_guidance_module`` (where the dict
    has it) through ``convert_esanet``."""
    core = convert_rdf_generator({k[5:]: v for k, v in sd.items()
                                  if k.startswith("core.")},
                                 use_nlspn_refine=use_nlspn_refine,
                                 adain_weighting=adain_weighting, fuse=fuse)
    params, stats = {}, {}
    if any(k.startswith("global_guidance_module.") for k in sd):
        g = convert_esanet(sd, prefix="global_guidance_module.")
        _sub(params, stats, "global_guidance_module", g["params"],
             g["batch_stats"])
    _sub(params, stats, "core", core["params"], core["batch_stats"])
    return {"params": params, "batch_stats": stats}


def _v1_wadain(groups, pre):
    fl = f"{pre}.style.linear"
    sub = {"EqualLinear_0": {"weight": np.asarray(
        groups[fl]["weight_orig"]).T, "bias": groups[fl]["bias"]}}
    if f"{pre}.gamma_weight_layer" in groups:
        sub["Conv_0"] = _conv_entry(groups[f"{pre}.gamma_weight_layer"])
        sub["Conv_1"] = _conv_entry(groups[f"{pre}.beta_weight_layer"])
    return sub


def convert_dcv_gan_generator_vanilla(sd: Dict[str, np.ndarray]):
    """``DCVGANGeneratorVanilla`` state dict -> Flax trees: the guidance
    ESANet as ``ESANetOneModality_0``, the two stems and torsos, the RGB
    decoder's skip projections, the ten decoder stages (RGB and depth in
    turn), the W-AdaIN layers the dict has, the four heads."""
    groups = walk_state_dict(sd)
    p, st = {}, {}
    if any(k.startswith("global_guidance_module.") for k in sd):
        _sub(p, st, "ESANetOneModality_0",
             *_esanet_trees(groups, "global_guidance_module."))
    _sub(p, st, "ResNetStem_0", *_v1_stem(groups, "rgb_stem"))
    _sub(p, st, "ResNetStem_1", *_v1_stem(groups, "depth_stem"))
    for br, off in (("rgb", 0), ("depth", 4)):
        for i in range(4):
            _sub(p, st, f"ResNetStage_{i + off}", *_v1_stage(
                groups, f"{br}_layer{i + 1}"))
    _v1_skips(groups, p, st, "")
    for i in range(10):
        _sub(p, st, f"VanillaDecoderModule_{i}", *_v1_decoder_module(
            groups, f"{('rgb', 'depth')[i % 2]}_decoder{i // 2 + 1}"))
    for i in range(6):
        if f"fuse_layer{i + 1}.style.linear" in groups:
            p[f"AdaptiveInstanceNorm_{i}"] = _v1_wadain(groups,
                                                        f"fuse_layer{i + 1}")
    for i, name in enumerate(("rgb_depth_head", "rgb_conf_head",
                              "depth_depth_head", "depth_conf_head")):
        p[f"Conv_{i}"] = _conv_entry(groups[name])
    return {"params": p, "batch_stats": st}


def convert_pixelgan(sd: Dict[str, np.ndarray]):
    """``PixelGANDiscriminator`` (``net.{0,2,3,5}``) -> ``Conv_{0,1,2}`` and
    ``BatchNorm_0``."""
    groups = walk_state_dict(sd)
    params, stats = {}, {}
    for i, idx in enumerate((0, 2, 5)):
        params[f"Conv_{i}"] = _conv_entry(groups[f"net.{idx}"])
    _put_bn(params, stats, "BatchNorm_0", groups["net.3"])
    return {"params": params, "batch_stats": stats}


def convert_pointnet(sd: Dict[str, np.ndarray]):
    """``PointNetDiscriminator`` -> ``Dense_{0-6}`` (Linear (out, in) ->
    Dense (in, out)) and ``BatchNorm_{0-5}``."""
    groups = walk_state_dict(sd)
    params, stats = {}, {}
    for i in range(7):
        g = groups[f"fc{i + 1}"]
        params[f"Dense_{i}"] = {"kernel": np.ascontiguousarray(
            np.asarray(g["weight"]).T), "bias": g["bias"]}
        if i < 6:
            _put_bn(params, stats, f"BatchNorm_{i}", groups[f"bn{i + 1}"])
    return {"params": params, "batch_stats": stats}


def net_tree_to_jax(cfg, name: str, module, sd: Dict[str, np.ndarray]):
    """The Flax trees of an engine's net ``name`` from its state dict
    ``sd`` (numpy), by the module's class and the engine config's options:
    every net the port's engines build."""
    from ..models import (NNET, DCVGANGenerator, DCVGANGeneratorVanilla,
                          PatchGANDiscriminator, PixelGANDiscriminator,
                          PointNetDiscriminator, PSPNet, RDFGenerator,
                          ResnetGenerator)
    from .convert import generator_options, model_options

    if isinstance(module, RDFGenerator):
        return convert_rdf_generator(sd, **generator_options(cfg, name,
                                                             module))
    if isinstance(module, DCVGANGenerator):
        return convert_dcv_gan_generator(sd, **generator_options(
            cfg, name, module))
    if isinstance(module, DCVGANGeneratorVanilla):
        return convert_dcv_gan_generator_vanilla(sd)
    if isinstance(module, ResnetGenerator):
        return convert_resnet_generator(sd)
    if isinstance(module, NNET):
        return convert_nnet(sd, depth=model_options(cfg, name).get(
            "depth", 2.2))
    if isinstance(module, PSPNet):
        return convert_pspnet(sd)
    for cls, fn in ((PatchGANDiscriminator, convert_patchgan),
                    (PixelGANDiscriminator, convert_pixelgan),
                    (PointNetDiscriminator, convert_pointnet)):
        if isinstance(module, cls):
            return fn(sd)
    raise NotImplementedError(f"{name}: no converter to the JAX tree of "
                              f"{type(module).__name__}")
