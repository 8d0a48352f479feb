"""Plain PyTorch networks of RDF-GAN and RDFC-GAN: the benchmark's frozen
copy of ``tools/torch_ref_models.py``, the PyTorch mirrors of the
reference networks in the reference checkpoint schema, which the measured
package loads strictly. Imports ``torch`` and ``math`` only.

Departures from that file, each needed to run it on a card or to hand
both sides the same random draws:
  * ``TorchNLSPN`` makes its index and zero tensors on its input's device,
    and its confidence gather takes the offsets detached, as NLSPN's does.
    With ``mask_dtype`` set, its eval-mode propagation collects each
    step's weights by integer shift and rounds them to that type once, as
    the configuration serves the chain (``_shift_propagate``); the
    arithmetic is otherwise the gather's.
  * ``TorchRDFGenerator.forward`` takes ``normal`` as optional: the RDF-GAN
    engine feeds the RGB image to the semantic branches.
  * The two channel dropouts of ``TorchPSPNet`` are ``KeepDropout2d``, which
    takes its keep mask from the caller (``keep``), so the reference and
    the measured program drop the same channels; eval mode is the identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


# ------------------------------------------------------------------ utils --
def round_channels(c: float, width: float, divisor: int = 8) -> int:
    c *= width
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, depth: float) -> int:
    return int(math.ceil(depth * r))


B0_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


class Conv2dSame(nn.Conv2d):
    """TF-SAME padding (timm Conv2dSame): pad_total = max((ceil(i/s)-1)*s +
    (k-1)*d + 1 - i, 0), split lo = total//2 — identical to JAX 'SAME'."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=True):
        super().__init__(cin, cout, k, stride, 0, 1, groups, bias)

    def forward(self, x):
        ih, iw = x.shape[-2:]
        k, s = self.kernel_size, self.stride
        pads = []
        for i, kk, ss in ((iw, k[1], s[1]), (ih, k[0], s[0])):
            o = -(-i // ss)
            total = max((o - 1) * ss + kk - i, 0)
            pads += [total // 2, total - total // 2]
        x = F.pad(x, pads)
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


# ------------------------------------------------- EfficientNet (G_normal) --
class _SqueezeExcite(nn.Module):
    def __init__(self, chs, reduced):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, chs, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(self.conv_reduce(s))
        return x * torch.sigmoid(self.conv_expand(s))


class _DepthwiseSeparable(nn.Module):
    """gen-efficientnet DepthwiseSeparableConv (stage 0, expand == 1)."""

    def __init__(self, cin, cout, k, stride, se_ratio=0.25, bn_eps=1e-3):
        super().__init__()
        self.conv_dw = Conv2dSame(cin, cin, k, stride, groups=cin, bias=False)
        self.bn1 = nn.BatchNorm2d(cin, eps=bn_eps)
        self.se = _SqueezeExcite(cin, max(1, int(cin * se_ratio)))
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=bn_eps)
        self.has_residual = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_dw(x)))
        h = self.se(h)
        h = self.bn2(self.conv_pw(h))
        return h + x if self.has_residual else h


class _InvertedResidual(nn.Module):
    """gen-efficientnet InvertedResidual (expand > 1); SE reduction is based
    on the block INPUT channels."""

    def __init__(self, cin, cout, expand, k, stride, se_ratio=0.25,
                 bn_eps=1e-3):
        super().__init__()
        mid = cin * expand
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid, eps=bn_eps)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid, bias=False)
        self.bn2 = nn.BatchNorm2d(mid, eps=bn_eps)
        self.se = _SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout, eps=bn_eps)
        self.has_residual = stride == 1 and cin == cout

    def forward(self, x):
        h = F.silu(self.bn1(self.conv_pw(x)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.has_residual else h


class TorchEfficientNet(nn.Module):
    """gen-efficientnet GenEfficientNet layout: _modules order conv_stem,
    bn1, act1, blocks, conv_head, bn2, act2, global_pool, classifier —
    the reference Encoder iterates these and collects every output
    (normal_net/submodules/encoder.py forward)."""

    def __init__(self, width=1.6, depth=2.2, bn_eps=1e-3):
        super().__init__()
        stem = round_channels(32, width)
        self.conv_stem = Conv2dSame(3, stem, 3, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(stem, eps=bn_eps)
        self.act1 = nn.SiLU(inplace=True)
        blocks = []
        cin = stem
        for (e, c, r, s, k) in B0_BLOCKS:
            cout = round_channels(c, width)
            stage = []
            for bi in range(round_repeats(r, depth)):
                cls = _DepthwiseSeparable if e == 1 else _InvertedResidual
                args = (cin, cout, k, s if bi == 0 else 1) if e == 1 else \
                    (cin, cout, e, k, s if bi == 0 else 1)
                stage.append(cls(*args, bn_eps=bn_eps))
                cin = cout
            blocks.append(nn.Sequential(*stage))
        self.blocks = nn.Sequential(*blocks)
        head = round_channels(1280, width)
        self.conv_head = nn.Conv2d(cin, head, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(head, eps=bn_eps)
        self.act2 = nn.SiLU(inplace=True)
        self.global_pool = nn.Identity()
        self.classifier = nn.Identity()


class TorchNNETEncoder(nn.Module):
    """normal_net/submodules/encoder.py Encoder: collect every module
    output; the decoder indexes features[4,5,6,8,11]."""

    def __init__(self, width=1.6, depth=2.2):
        super().__init__()
        self.original_model = TorchEfficientNet(width, depth)

    def forward(self, x):
        features = [x]
        for k, v in self.original_model._modules.items():
            if k == "blocks":
                for vi in v._modules.values():
                    features.append(vi(features[-1]))
            else:
                features.append(v(features[-1]))
        return features


class _UpSampleBN(nn.Module):
    def __init__(self, skip_input, output_features):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, output_features, 3, 1, 1),
            nn.BatchNorm2d(output_features), nn.LeakyReLU(),
            nn.Conv2d(output_features, output_features, 3, 1, 1),
            nn.BatchNorm2d(output_features), nn.LeakyReLU())

    def forward(self, x, concat_with):
        up = F.interpolate(x, size=concat_with.shape[2:], mode="bilinear",
                           align_corners=True)
        return self._net(torch.cat([up, concat_with], dim=1))


class TorchNNETDecoder(nn.Module):
    def __init__(self, num_classes=4, width=1.6):
        super().__init__()
        head = round_channels(1280, width)
        # B0 stage output widths at the decoder taps (stages 0,1,2,4):
        # scale to (24, 40, 64, 176) at B5 width 1.6
        taps = [round_channels(c, width) for c in (16, 24, 40, 112)]
        self.conv2 = nn.Conv2d(head, head, 1)
        self.up1 = _UpSampleBN(head + taps[3], head // 2)
        self.up2 = _UpSampleBN(head // 2 + taps[2], head // 4)
        self.up3 = _UpSampleBN(head // 4 + taps[1], head // 8)
        self.up4 = _UpSampleBN(head // 8 + taps[0], head // 16)
        self.conv3 = nn.Conv2d(head // 16, num_classes, 3, 1, 1)

    def forward(self, features):
        b0, b1, b2, b3, b4 = (features[4], features[5], features[6],
                              features[8], features[11])
        h = self.conv2(b4)
        h = self.up1(h, b3)
        h = self.up2(h, b2)
        h = self.up3(h, b1)
        h = self.up4(h, b0)
        return self.conv3(h)


class TorchNNET(nn.Module):
    """normal_net/NNET.py: encoder + decoder + bilinear resize."""

    def __init__(self, out_height, out_width, width=1.6, depth=2.2):
        super().__init__()
        self.encoder = TorchNNETEncoder(width, depth)
        self.decoder = TorchNNETDecoder(4, width)
        self.out_height, self.out_width = out_height, out_width

    def forward(self, img):
        out = self.decoder(self.encoder(img))
        return F.interpolate(out, size=(self.out_height, self.out_width),
                             mode="bilinear", align_corners=True)


# --------------------------------------------- PatchGAN / ResnetGenerator --
class _ConvModule(nn.Module):
    """mmcv-style ConvModule naming: .conv / .bn (patch_gan_discriminator.py
    builds its stack from these)."""

    def __init__(self, cin, cout, k, s, p, bn, act):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, p)
        self.bn = nn.BatchNorm2d(cout) if bn else None
        self.act = nn.LeakyReLU(0.2) if act else None

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class TorchPatchGAN(nn.Module):
    """patch_gan_discriminator.py:6-40: ConvModule stack under ``model``,
    BN on middle layers only, activation on all but last."""

    def __init__(self, in_channels=1, out_channels=(64, 128, 256, 512, 1),
                 kernel_size=(4, 4, 4, 4, 4), stride=(2, 2, 2, 1, 1),
                 padding=(1, 1, 1, 1, 1)):
        super().__init__()
        n = len(out_channels)
        cin = in_channels
        mods = []
        for i in range(n):
            mods.append(_ConvModule(cin, out_channels[i], kernel_size[i],
                                    stride[i], padding[i],
                                    bn=0 < i < n - 1, act=i < n - 1))
            cin = out_channels[i]
        self.model = nn.Sequential(*mods)

    def forward(self, x):
        return self.model(x)


class _TorchResnetBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            nn.InstanceNorm2d(dim), nn.LeakyReLU(0.01),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            nn.InstanceNorm2d(dim))

    def forward(self, x):
        return x + self.conv_block(x)


class TorchResnetGenerator(nn.Module):
    """resnet_generator.py:6-100 layout: single ``model`` Sequential —
    reflection-pad 7x7 stem, 2 stride-2 downs (PReLU), N ResnetBlocks,
    2 ups (PReLU), reflection-pad 7x7 head + tanh; IN2d norms (no params)."""

    def __init__(self, in_ch=1, out_ch=3, ngf=64, n_blocks=6):
        super().__init__()
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(in_ch, ngf, 7),
                  nn.InstanceNorm2d(ngf), nn.LeakyReLU(0.01)]
        for i in range(2):
            m = 2 ** i
            layers += [nn.Conv2d(ngf * m, ngf * m * 2, 3, 2, 1),
                       nn.InstanceNorm2d(ngf * m * 2), nn.PReLU(init=0.25)]
        for _ in range(n_blocks):
            layers.append(_TorchResnetBlock(ngf * 4))
        for i in range(2):
            m = 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(ngf * m, ngf * m // 2, 3, 2, 1, 1),
                       nn.InstanceNorm2d(ngf * m // 2), nn.PReLU(init=0.25)]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, out_ch, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


# ------------------------------------------------------- PSPNet (G_label) --
class KeepDropout2d(nn.Module):
    """Channel dropout with the keep mask (B, C, 1, 1) bool set by the
    caller for one train-mode forward: where(keep, x / (1 - p), 0)."""

    def __init__(self, p=0.1):
        super().__init__()
        self.p = p
        self.keep = None

    def forward(self, x):
        if not self.training:
            return x
        return torch.where(self.keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        h = self.relu(self.bn1(self.conv1(x)))
        h = self.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return self.relu(h + r)


def _make_dilated_layer(inplanes, planes, blocks, stride=1, dilation=1,
                        multi_grid=False):
    """backbone_resnet50.py _make_layer semantics: dilation-2 stages run
    their first block at dilation 1; multi-grid uses [4, 8, 16]."""
    downsample = None
    if stride != 1 or inplanes != planes * 4:
        downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4))
    mg = [4, 8, 16]
    layers = []
    if multi_grid:
        d0 = mg[0]
    elif dilation in (1, 2):
        d0 = 1
    else:  # dilation == 4 (non-multi-grid layer4)
        d0 = 2
    layers.append(_Bottleneck(inplanes, planes, stride, d0, downsample))
    inplanes = planes * 4
    for i in range(1, blocks):
        d = mg[i] if multi_grid else dilation
        layers.append(_Bottleneck(inplanes, planes, 1, d))
    return nn.Sequential(*layers)


class _PSPModule(nn.Module):
    def __init__(self, in_channels, bin_sizes=(1, 2, 3, 6)):
        super().__init__()
        out_channels = in_channels // len(bin_sizes)
        self.stages = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(b),
                          nn.Conv2d(in_channels, out_channels, 1, bias=False),
                          nn.BatchNorm2d(out_channels),
                          nn.ReLU(inplace=True))
            for b in bin_sizes])
        self.bottleneck = nn.Sequential(
            nn.Conv2d(in_channels + out_channels * len(bin_sizes),
                      out_channels, 1),
            nn.BatchNorm2d(out_channels), nn.ReLU(inplace=True),
            KeepDropout2d(0.1))

    def forward(self, x):
        h, w = x.shape[2:]
        ps = [x] + [F.interpolate(s(x), size=(h, w), mode="bilinear",
                                  align_corners=True) for s in self.stages]
        return self.bottleneck(torch.cat(ps, dim=1))


# --------------------------------------------------- RDFGenerator (G_A2B) --
def conv_bn_relu(cin, cout, kernel, stride=1, padding=0, bn=True, _in=False,
                 relu=True):
    """encoder_decoder/common.py:29-43 layout: Sequential(conv[,bn][,in]
    [,lrelu]) — bias iff no bn."""
    layers = [nn.Conv2d(cin, cout, kernel, stride, padding, bias=not bn)]
    if bn:
        layers.append(nn.BatchNorm2d(cout))
    if _in:
        layers.append(nn.InstanceNorm2d(cout))
    if relu:
        layers.append(nn.LeakyReLU(0.2, inplace=True))
    return nn.Sequential(*layers)


def convt_bn_relu(cin, cout, kernel, stride=1, padding=0, output_padding=0,
                  bn=True, relu=True):
    layers = [nn.ConvTranspose2d(cin, cout, kernel, stride, padding,
                                 output_padding, bias=not bn)]
    if bn:
        layers.append(nn.BatchNorm2d(cout))
    if relu:
        layers.append(nn.LeakyReLU(0.2, inplace=True))
    return nn.Sequential(*layers)


class TorchBasicBlock(nn.Module):
    """torchvision BasicBlock state-dict layout (conv1/bn1/conv2/bn2/
    downsample.{0,1})."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


def _resnet_layer(cin, planes, blocks, stride):
    mods = [TorchBasicBlock(cin, planes, stride)]
    mods += [TorchBasicBlock(planes, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*mods)


class TorchEncoderDecoder(nn.Module):
    """encoder_decoder.py:5-122: en2-5 resnet layers, en6 stride-2 conv,
    de5-2 k3/s2 transposed convs with concat-skip channel arithmetic."""

    def __init__(self, encoder_type="resnet18", skip_type="concat",
                 encoder_channels=(64, 128, 256, 512, 512),
                 decoder_channels=(256, 128, 64, 64), in_channels=64):
        super().__init__()
        blocks = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}[
            encoder_type]
        ec, dc = list(encoder_channels), list(decoder_channels)
        concat = skip_type == "concat"
        self.en2 = _resnet_layer(in_channels, ec[0], blocks[0], 1)
        self.en3 = _resnet_layer(ec[0], ec[1], blocks[1], 2)
        self.en4 = _resnet_layer(ec[1], ec[2], blocks[2], 2)
        self.en5 = _resnet_layer(ec[2], ec[3], blocks[3], 2)
        self.en6 = conv_bn_relu(ec[-2], ec[-1], 3, 2, 1)
        ins = [ec[-1], dc[0] + (ec[-2] if concat else 0),
               dc[1] + (ec[-3] if concat else 0),
               dc[2] + (ec[-4] if concat else 0)]
        self.de5 = convt_bn_relu(ins[0], dc[0], 3, 2, 1, 1)
        self.de4 = convt_bn_relu(ins[1], dc[1], 3, 2, 1, 1)
        self.de3 = convt_bn_relu(ins[2], dc[2], 3, 2, 1, 1)
        self.de2 = convt_bn_relu(ins[3], dc[3], 3, 2, 1, 1)

    def forward_encoder_layer(self, x, layer_idx):
        return getattr(self, f"en{layer_idx}")(x)

    def forward_decoder_layer(self, x, layer_idx):
        return getattr(self, f"de{layer_idx}")(x)


class _EqualLinearInner(nn.Module):
    """nn.Linear with EqualLR applied (model_utils.py:7-36): stores
    ``weight_orig`` and scales by sqrt(2/fan_in) at call."""

    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.randn(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.in_dim = in_dim

    def forward(self, x):
        w = self.weight_orig * math.sqrt(2 / self.in_dim)
        return F.linear(x, w, self.bias)


class TorchEqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.linear = _EqualLinearInner(in_dim, out_dim)

    def forward(self, x):
        return self.linear(x)


class TorchWAdaIN(nn.Module):
    """AdaptiveInstanceNorm (model_utils.py:53-90): per-pixel style (gamma,
    beta) from an EqualLinear over the style feature."""

    def __init__(self, in_channel, style_dim, weighting=False):
        super().__init__()
        self.norm = nn.InstanceNorm2d(in_channel)
        self.style = TorchEqualLinear(style_dim, in_channel * 2)
        with torch.no_grad():
            self.style.linear.bias[:in_channel] = 1
            self.style.linear.bias[in_channel:] = 0
        self.weighting = weighting
        if weighting:
            self.gamma_weight_layer = nn.Conv2d(in_channel, in_channel, 1)
            self.beta_weight_layer = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x, style):
        s = self.style(style.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        gamma, beta = s.chunk(2, 1)
        out = self.norm(x)
        if self.weighting:
            return (self.gamma_weight_layer(x) * gamma * out
                    + self.beta_weight_layer(x) * beta)
        return gamma * out + beta


def _bilinear_gather(feat, y, x):
    """Zero-padded 4-corner bilinear gather. feat (B,1,H,W); y/x (B,K,H,W)
    absolute fractional coordinates. Matches the CUDA sampler
    (modulated_deform_im2col_cuda.cuh:25-54)."""
    B, _, H, W = feat.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    flat = feat.reshape(B, H * W)
    out = 0
    for dy, dx, wgt in ((0, 0, wy0 * wx0), (0, 1, wy0 * wx1),
                        (1, 0, wy1 * wx0), (1, 1, wy1 * wx1)):
        yi, xi = y0.long() + dy, x0.long() + dx
        inb = ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)).to(feat.dtype)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1)
        vals = torch.gather(flat, 1, idx).reshape(y.shape)
        out = out + vals * inb * wgt
    return out


class TorchNLSPN(nn.Module):
    """nlspn_model.py:6-175 with the modulated-deform-conv expressed as a
    pure-torch affinity-weighted bilinear gather (frozen identity kernel,
    nlspn_model.py:52-56) so the mirror runs without CUDA."""

    def __init__(self, prop_kernel=3, prop_time=18, affinity="TGASS",
                 affinity_gamma=0.5, conf_prop=True, preserve_input=False):
        super().__init__()
        self.k_f = prop_kernel
        self.prop_time = prop_time
        self.affinity = affinity
        self.affinity_gamma = affinity_gamma
        self.conf_prop = conf_prop
        self.preserve_input = preserve_input
        self.num = prop_kernel * prop_kernel - 1
        self.idx_ref = self.num // 2
        self.conv_offset_aff = nn.Conv2d(self.num, 3 * self.num, 3, 1, 1)
        self.conv_offset_aff.weight.data.zero_()
        self.conv_offset_aff.bias.data.zero_()
        if affinity == "TC":
            self.aff_scale_const = nn.Parameter(
                self.num * torch.ones(1), requires_grad=False)
        elif affinity == "TGASS":
            self.aff_scale_const = nn.Parameter(
                affinity_gamma * self.num * torch.ones(1))
        else:
            self.aff_scale_const = nn.Parameter(torch.ones(1),
                                                requires_grad=False)
        # frozen dummies present in reference state dicts
        self.w = nn.Parameter(torch.ones(1, 1, prop_kernel, prop_kernel),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(1), requires_grad=False)
        self.w_conf = nn.Parameter(torch.ones(1, 1, 1, 1),
                                   requires_grad=False)
        # None: the gather in f32; a type: served through shift masks
        # rounded to it (``_shift_propagate``)
        self.mask_dtype = None

    def _offset_affinity(self, guidance, confidence):
        B, _, H, W = guidance.shape
        oa = self.conv_offset_aff(guidance)
        o1, o2, aff = torch.chunk(oa, 3, dim=1)
        # the reference's interleave: cat(o1,o2).view(B, num, 2, H, W) —
        # tap i reads channels (2i, 2i+1) of [o1|o2] (nlspn_model.py:76-80)
        offset = torch.cat((o1, o2), dim=1).view(B, self.num, 2, H, W)
        lst = list(torch.chunk(offset, self.num, dim=1))
        lst.insert(self.idx_ref, torch.zeros((B, 1, 2, H, W),
                                             device=guidance.device))
        offset = torch.cat(lst, dim=1)  # (B, K, 2, H, W)

        if self.affinity == "TC":
            aff = torch.tanh(aff) / self.aff_scale_const
        elif self.affinity == "TGASS":
            aff = torch.tanh(aff) / (self.aff_scale_const + 1e-8)

        if self.conf_prop:
            # 1x1 deform gather of confidence at each NEIGHBOR tap's learned
            # offset (no kernel-grid displacement, nlspn_model.py:96-119)
            dev = guidance.device
            yy = torch.arange(H, dtype=torch.float32, device=dev).view(
                1, 1, H, 1)
            xx = torch.arange(W, dtype=torch.float32, device=dev).view(
                1, 1, 1, W)
            confs = []
            for k in range(self.num + 1):
                ww, hh = k % self.k_f, k // self.k_f
                if ww == (self.k_f - 1) // 2 and hh == (self.k_f - 1) // 2:
                    continue
                # the offsets detached, as NLSPN's confidence gather takes
                # them (nlspn_model.py:96-119)
                oy = offset[:, k, 0].unsqueeze(1).detach()
                ox = offset[:, k, 1].unsqueeze(1).detach()
                confs.append(_bilinear_gather(confidence, yy + oy, xx + ox))
            aff = aff * torch.cat(confs, dim=1)

        aff_abs_sum = torch.sum(torch.abs(aff), dim=1, keepdim=True) + 1e-4
        if self.affinity in ("ASS", "TGASS"):
            aff_abs_sum = aff_abs_sum.clamp(min=1.0)
        if self.affinity in ("AS", "ASS", "TGASS"):
            aff = aff / aff_abs_sum
        aff_ref = 1.0 - torch.sum(aff, dim=1, keepdim=True)
        lst = list(torch.chunk(aff, self.num, dim=1))
        lst.insert(self.idx_ref, aff_ref)
        return offset, torch.cat(lst, dim=1)  # (B,K,2,H,W), (B,K,H,W)

    def forward(self, feat_init, guidance, confidence, feat_fix):
        B, _, H, W = feat_init.shape
        offset, aff = self._offset_affinity(guidance, confidence)
        K = self.k_f * self.k_f
        pad = (self.k_f - 1) // 2
        dev = feat_init.device
        grid_y = torch.tensor([k // self.k_f - pad for k in range(K)],
                              dtype=torch.float32, device=dev).view(
                                  1, K, 1, 1)
        grid_x = torch.tensor([k % self.k_f - pad for k in range(K)],
                              dtype=torch.float32, device=dev).view(
                                  1, K, 1, 1)
        yy = torch.arange(H, dtype=torch.float32, device=dev).view(
            1, 1, H, 1)
        xx = torch.arange(W, dtype=torch.float32, device=dev).view(
            1, 1, 1, W)
        if self.mask_dtype is not None and not self.training:
            return self._shift_propagate(feat_init, feat_fix,
                                         grid_y + offset[:, :, 0],
                                         grid_x + offset[:, :, 1], aff)
        ty = yy + grid_y + offset[:, :, 0]
        tx = xx + grid_x + offset[:, :, 1]
        if self.preserve_input:
            mask_fix = (feat_fix > 0.0).to(feat_init.dtype)
        feat = feat_init
        for _ in range(self.prop_time):
            if self.preserve_input:
                feat = (1.0 - mask_fix) * feat + mask_fix * feat_fix
            feat = torch.sum(_bilinear_gather(feat, ty, tx) * aff, dim=1,
                             keepdim=True)
        return feat


    def _shift_propagate(self, feat_init, feat_fix, ry, rx, aff):
        """The propagation with each step's weights collected by integer
        shift: M_s(p), the sum of the bilinear corner weights times the
        affinities of the taps whose corner lies at p + s, rounded once to
        ``mask_dtype``; then each step sum_s M_s(p) feat(p + s) in f32,
        zero outside the image. ry, rx: (B, K, H, W) tap positions
        relative to each pixel."""
        B, _, H, W = feat_init.shape
        y0, x0 = torch.floor(ry), torch.floor(rx)
        wy1, wx1 = ry - y0, rx - x0
        lo = int(min(y0.min(), x0.min()))
        hi = int(max(y0.max(), x0.max())) + 1
        S = hi - lo + 1
        M = torch.zeros((B, S * S, H, W), device=feat_init.device)
        for dy, dx, wgt in ((0, 0, (1 - wy1) * (1 - wx1)),
                            (0, 1, (1 - wy1) * wx1),
                            (1, 0, wy1 * (1 - wx1)), (1, 1, wy1 * wx1)):
            idx = ((y0 + dy - lo) * S + (x0 + dx - lo)).long()
            M.scatter_add_(1, idx, wgt * aff)
        M = M.to(self.mask_dtype).float()
        P = max(-lo, hi)
        if self.preserve_input:
            mask_fix = (feat_fix > 0.0).to(feat_init.dtype)
        feat = feat_init.float()
        for _ in range(self.prop_time):
            if self.preserve_input:
                feat = (1.0 - mask_fix) * feat + mask_fix * feat_fix
            fp = F.pad(feat, (P, P, P, P))
            out = torch.zeros_like(feat)
            for sy in range(lo, hi + 1):
                for sx in range(lo, hi + 1):
                    s = (sy - lo) * S + (sx - lo)
                    out = out + M[:, s:s + 1] * fp[
                        :, :, P + sy:P + sy + H, P + sx:P + sx + W]
            feat = out
        return feat


class TorchNLSPNRefineModule(nn.Module):
    """nlspn_model.py:178-197 naming: ``prop_layer`` child."""

    def __init__(self, **cfg):
        super().__init__()
        self.prop_layer = TorchNLSPN(**cfg)

    def forward(self, init_pred_depth, guide, confidence, origin_depth):
        return self.prop_layer(init_pred_depth, guide, confidence,
                               origin_depth), confidence


class TorchRDFGenerator(nn.Module):
    """rdf_generator.py:31-414 with the reference's exact module names (the
    checkpoint contract): rgb_branch_en1, rgb_branch_encoder_decoder,
    rgb_pred_dec{0,1}, rgb_conf_dec{0,1}, depth_branch_en1_{rgb,depth},
    depth_branch_encoder_decoder, id_dec*, gd_dec*, cf_dec*,
    nlspn_refine_module.prop_layer.*, fuse_layer1..5 (fuse_layer5 is
    constructed but unused — present in checkpoints, rdf_generator.py:371)."""

    def __init__(self, semantic_channels_in=3,
                 rgb_channels_encoder=(64, 64, 128, 256, 512, 512),
                 depth_channels_encoder=(64, 64, 128, 256, 512, 512),
                 rgb_channels_decoder=(256, 128, 64, 64),
                 depth_channels_decoder=(256, 128, 64, 64),
                 adain_weighting=False, use_nlspn_refine=True,
                 nlspn_configs=None, encoder_type="resnet18"):
        super().__init__()
        rce, dce = list(rgb_channels_encoder), list(depth_channels_encoder)
        rcd, dcd = list(rgb_channels_decoder), list(depth_channels_decoder)
        self.use_nlspn_refine = use_nlspn_refine

        self.rgb_branch_en1 = conv_bn_relu(semantic_channels_in, rce[0], 3,
                                           1, 1, bn=False)
        self.rgb_branch_encoder_decoder = TorchEncoderDecoder(
            encoder_type, "concat", rce[1:], rcd, in_channels=rce[0])
        hd = rcd[-1] + rce[1]  # decoder out + en2-skip channels
        self.rgb_pred_dec1 = conv_bn_relu(hd, 64, 3, 1, 1)
        self.rgb_pred_dec0 = conv_bn_relu(64 + rce[0], 1, 3, 1, 1, bn=False,
                                          relu=False)
        self.rgb_conf_dec1 = conv_bn_relu(hd, 32, 3, 1, 1)
        self.rgb_conf_dec0 = nn.Sequential(
            nn.Conv2d(32 + rce[0], 1, 3, 1, 1), nn.Sigmoid())

        self.depth_branch_en1_rgb = conv_bn_relu(semantic_channels_in, 48,
                                                 3, 1, 1, bn=False)
        self.depth_branch_en1_depth = conv_bn_relu(1, 16, 3, 1, 1, bn=False)
        self.depth_branch_encoder_decoder = TorchEncoderDecoder(
            encoder_type, "concat", dce[1:], dcd, in_channels=64)
        hdd = dcd[-1] + dce[1]
        self.id_dec1 = conv_bn_relu(hdd, 64, 3, 1, 1)
        self.id_dec0 = conv_bn_relu(64 + 64, 1, 3, 1, 1, bn=False,
                                    relu=False)
        if use_nlspn_refine:
            cfgs = dict(nlspn_configs or {})
            num = cfgs.get("prop_kernel", 3) ** 2 - 1
            self.gd_dec1 = conv_bn_relu(hdd, 64, 3, 1, 1)
            self.gd_dec0 = conv_bn_relu(64 + 64, num, 3, 1, 1, bn=False,
                                        relu=False)
        self.cf_dec1 = conv_bn_relu(hdd, 32, 3, 1, 1)
        self.cf_dec0 = nn.Sequential(
            nn.Conv2d(32 + 64, 1, 3, 1, 1), nn.Sigmoid())

        if use_nlspn_refine:
            self.nlspn_refine_module = TorchNLSPNRefineModule(
                **dict(nlspn_configs or {}))

        def _fc(i):  # channels entering fuse layer i (1-indexed)
            if i == 1:
                return rce[-1]
            return rcd[i - 2] + rce[-i]

        self.fuse_layer1 = TorchWAdaIN(_fc(1), _fc(1), adain_weighting)
        self.fuse_layer2 = TorchWAdaIN(_fc(2), _fc(2), adain_weighting)
        self.fuse_layer3 = TorchWAdaIN(_fc(3), _fc(3), adain_weighting)
        self.fuse_layer4 = TorchWAdaIN(_fc(4), _fc(4), adain_weighting)
        self.fuse_layer5 = TorchWAdaIN(_fc(5), _fc(5), adain_weighting)

    @staticmethod
    def _concat(fd, fe):
        fd = fd[:, :, :fe.shape[2], :fe.shape[3]]
        return torch.cat((fd, fe), dim=1)

    def forward(self, rgb, depth, normal=None):
        origin_depth = depth
        if normal is None:
            normal = rgb
        rgb_fe1 = self.rgb_branch_en1(normal)
        d_fe1 = torch.cat([self.depth_branch_en1_rgb(normal),
                           self.depth_branch_en1_depth(depth)], dim=1)
        rgb_fe, d_fe = [rgb_fe1], [d_fe1]
        for idx in range(2, 7):
            rgb_fe.append(self.rgb_branch_encoder_decoder
                          .forward_encoder_layer(rgb_fe[-1], idx))
            d_fe.append(self.depth_branch_encoder_decoder
                        .forward_encoder_layer(d_fe[-1], idx))
        rgb_fd, d_fd = rgb_fe[5], d_fe[5]
        for li, dec_idx in enumerate(range(5, 1, -1)):
            fuse = getattr(self, f"fuse_layer{li + 1}")(rgb_fd, d_fd)
            rgb_fd = self._concat(
                self.rgb_branch_encoder_decoder.forward_decoder_layer(
                    fuse, dec_idx), rgb_fe[dec_idx - 1])
            d_fd = self._concat(
                self.depth_branch_encoder_decoder.forward_decoder_layer(
                    d_fd, dec_idx), d_fe[dec_idx - 1])

        depth_map_1 = torch.tanh(self.rgb_pred_dec0(
            self._concat(self.rgb_pred_dec1(rgb_fd), rgb_fe1)))
        confidence_map_1 = self.rgb_conf_dec0(
            self._concat(self.rgb_conf_dec1(rgb_fd), rgb_fe1))

        pred_init = torch.tanh(self.id_dec0(
            self._concat(self.id_dec1(d_fd), d_fe1)))
        confidence = self.cf_dec0(
            self._concat(self.cf_dec1(d_fd), d_fe1))

        if self.use_nlspn_refine:
            guide = self.gd_dec0(self._concat(self.gd_dec1(d_fd), d_fe1))
            depth_map_2, confidence_map_2 = self.nlspn_refine_module(
                pred_init, guide, confidence, origin_depth)
        else:
            depth_map_2, confidence_map_2 = pred_init, confidence
        depth_map_2 = torch.clamp(depth_map_2, -1, 1)

        conf = torch.cat([confidence_map_1, confidence_map_2], dim=1)
        score = F.softmax(conf, 1)
        depths = torch.cat([depth_map_1, depth_map_2], dim=1)
        pred = torch.sum(depths * score, dim=1, keepdim=True)
        return dict(depth_map_1=depth_map_1,
                    confidence_map_1=confidence_map_1,
                    depth_map_2=depth_map_2,
                    confidence_map_2=confidence_map_2,
                    pred_depth=pred)


class TorchPSPNet(nn.Module):
    """labels_model.py PSPNet over the deep-stem dilated R50. ``planes``/
    ``stem`` narrow the net for tests (reference: (64,128,256,512), 64)."""

    def __init__(self, num_classes=14, planes=(64, 128, 256, 512), stem=64):
        super().__init__()
        p = list(planes)
        conv1 = nn.Sequential(
            nn.Conv2d(3, stem, 3, 2, 1, bias=False), nn.BatchNorm2d(stem),
            nn.ReLU(inplace=True),
            nn.Conv2d(stem, stem, 3, 1, 1, bias=False), nn.BatchNorm2d(stem),
            nn.ReLU(inplace=True),
            nn.Conv2d(stem, 2 * stem, 3, 1, 1, bias=False))
        self.initial = nn.Sequential(
            conv1, nn.BatchNorm2d(2 * stem), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2, 1))
        self.layer1 = _make_dilated_layer(2 * stem, p[0], 3)
        self.layer2 = _make_dilated_layer(p[0] * 4, p[1], 4, stride=2)
        self.layer3 = _make_dilated_layer(p[1] * 4, p[2], 6, dilation=2)
        self.layer4 = _make_dilated_layer(p[2] * 4, p[3], 3, dilation=4,
                                          multi_grid=True)
        self.master_branch = nn.Sequential(
            _PSPModule(p[3] * 4), nn.Conv2d(p[3], num_classes, 1))
        self.auxiliary_branch = nn.Sequential(
            nn.Conv2d(p[2] * 4, p[3], 3, padding=1, bias=False),
            nn.BatchNorm2d(p[3]), nn.ReLU(inplace=True), KeepDropout2d(0.1),
            nn.Conv2d(p[3], num_classes, 1))
        self.use_aux = True

    def forward(self, x):
        size = x.shape[2:]
        h = self.initial(x)
        h = self.layer1(h)
        h = self.layer2(h)
        x_aux = self.layer3(h)
        h = self.layer4(x_aux)
        out = F.interpolate(self.master_branch(h), size=size,
                            mode="bilinear", align_corners=True)
        if self.training and self.use_aux:
            aux = F.interpolate(self.auxiliary_branch(x_aux), size=size,
                                mode="bilinear", align_corners=True)
            return [out, aux]
        return out
