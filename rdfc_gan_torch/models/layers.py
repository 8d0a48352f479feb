"""Layers of the RDFGenerator and the PatchGAN (port of
rdfc_gan_tpu/models/layers.py, the subset they use), NCHW, with the
reference PyTorch state-dict names:

  * ``BatchNorm2d`` — the JAX ``BatchNorm`` (layers.py:150-208): in train
    mode f32 batch statistics with the biased variance, for normalising and
    for the running update (torch momentum 0.1 = flax 0.9), and the JAX
    rounding for a bf16 input; eval mode is torch's. The state dict is
    ``nn.BatchNorm2d``'s.
  * ``reflect_pad`` and ``PReLU`` — layers.py:716-751 and
    resnet_generator.py:20-26, for the ResnetGenerator. The pad's backward
    folds the border gradients back in a fixed order, as the JAX VJP does.
  * ``ConvBNAct`` / ``ConvTBNAct`` — encoder_decoder/common.py:29-63:
    Sequential(conv[, BatchNorm2d(eps 1e-5)][, LeakyReLU(0.2)]), conv bias
    iff no BN; the transposed conv has torch ConvTranspose2d(3, 2, 1, 1)
    geometry, which doubles H and W.
  * ``EqualLinear`` — model_utils.py:7-50: stores ``weight_orig`` ~ N(0, 1)
    and scales it by sqrt(2 / fan_in) at every call.
  * ``AdaptiveInstanceNorm`` (W-AdaIN) — model_utils.py:53-99: per-pixel
    (gamma, beta) from the style feature through an EqualLinear, applied to
    the instance-normalized content (eps 1e-5, no affine).
  * ``AdaIN`` and ``INFuse`` — layers.py:607-630, the other two
    ``fuse_depth_in_rgb_decoder`` choices.
  * ``instance_norm`` — layers.py:219-281, the hand-written kernels of
    ``ops/kernels/norm_kernel`` on the card.
  * ``bilinear_resize`` — layers.py:675-714: ``jax.image.resize``'s
    half-pixel bilinear (antialiased when it downsamples) by default, and
    align_corners=True; both as interpolation matmuls, whose matrices
    stay on the device (``device_matrix``).
  * ``NonBottleneck1D`` — layers.py:633-672, the ERFNet block of ESANet's
    decoders.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels.norm_kernel import instance_norm
from ..parallel import all_reduce_sum, spatial, world_size


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the JAX ``BatchNorm``'s train mode
    (layers.py:65-79, 150-208). In train mode it normalises with f32 batch
    statistics and updates the running statistics with the biased variance
    (torch's own uses the unbiased one), momentum 0.1 (flax's 0.9).

    A bf16 input (what autocast hands it) is normalised as the JAX package
    does: mean = E[x], var = max(E[x^2] - mean^2, 0) in f32, a = gamma
    rsqrt(var + eps) and b = beta - mean a in f32, each rounded to x's type,
    then y = x * a + b with the product and the sum rounded separately;
    torch's fused batch norm rounds the normalised value once. gamma and
    beta are first rounded to x's type, as the JAX train step casts every
    parameter to its compute type (engines/base.py:_apply). Its gradient
    is autograd's of that formula. An f32 input runs torch's fused batch
    norm, then moves ``running_var`` from the unbiased to the biased
    variance: with n values per channel, rv_new = (1 - m) rv_old + m u and
    u = b n / (n - 1), so the wanted (1 - m) rv_old + m b is
    rv_new (n - 1) / n + (1 - m) rv_old / n. Eval mode is torch's.

    At a world size above 1 (``parallel``) both types take ``_SyncBN``,
    the JAX ``_bn_train`` with ``axis_name`` (layers.py:65-150): the
    statistics and the backward's sums are those of the global batch. At
    world 1 the two forms above stay, so a one-rank run keeps its numbers
    bit for bit: torch's fused f32 kernel, which the JAX package's f32
    numbers match within the parity tolerance, and the rounded bf16 form."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if world_size() > 1:
            y, mean, var = _SyncBN.apply(x, self.weight, self.bias, self.eps)
            self.update_running(mean, var)
            return y
        if x.dtype != torch.float32:
            return self._forward_rounded(x)
        n = x.numel() // x.shape[1]
        old = self.running_var.clone()
        y = super().forward(x)
        # through .data, as batch norm's own in-place update: autograd may
        # hold running_var (unused by a train-mode backward), and a version
        # bump would fail a backward through an earlier forward
        self.running_var.data.mul_((n - 1) / n).add_(
            old, alpha=(1 - self.momentum) / n)
        return y

    def _forward_rounded(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean,
                              0.0)
        dt = x.dtype
        a = self.weight.to(dt).float() * torch.rsqrt(var + self.eps)
        b = self.bias.to(dt).float() - mean * a
        self.update_running(mean.detach(), var.detach())
        return x * a.to(dt)[None, :, None, None] + b.to(dt)[None, :, None,
                                                            None]

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor):
        """One train-mode running update from the batch mean and biased
        variance (f32)."""
        m = self.momentum
        self.running_mean.data.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.data.mul_(1 - m).add_(var, alpha=m)
        self.num_batches_tracked.data.add_(1)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _SyncBN(torch.autograd.Function):
    """Train-mode batch norm over the global batch (the JAX ``_bn_train``
    with ``axis_name``, layers.py:65-150). Forward: the per-channel sums of
    x and x^2 of this rank's rows, summed over the ranks and divided by the
    global count (``pmean``: every rank holds as many rows); var = max(E[x^2]
    - mean^2, 0), a and b in f32 from gamma and beta rounded to x's type, y
    = x a + b in x's type, the product and the sum rounded apart. Backward
    (``_bn_train_bwd``, from the output): s1 = sum dy and s2 = sum dy x_hat
    summed over the ranks with the global count; the returned gamma and
    beta gradients are this rank's sums, which the gradient all-reduce
    adds. Returns (y, the global mean, the biased variance).

    The sums of a bf16 input are f32, as in JAX. Those of an f32 input are
    f64, as torch's kernel accumulates them at world 1 on the CPU and as
    the fused block's moments are."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dt = x.dtype
        acc = torch.float64 if dt == torch.float32 else torch.float32
        xa = x.to(acc)
        n = x.numel() // x.shape[1] * world_size()
        mom = all_reduce_sum(torch.stack([xa.sum((0, 2, 3)),
                                          (xa * xa).sum((0, 2, 3))])) / n
        mean = mom[0]
        var = torch.clamp_min(mom[1] - mean * mean, 0.0)
        mean, var = mean.float(), var.float()
        rstd = torch.rsqrt(var + eps)
        a = weight.detach().to(dt).float() * rstd
        b = bias.detach().to(dt).float() - mean * a
        y = x * _col(a.to(dt)) + _col(b.to(dt))
        ctx.save_for_backward(y, rstd, weight, bias)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, *_):
        y, rstd, weight, bias = ctx.saved_tensors
        dt = y.dtype
        acc = torch.float64 if dt == torch.float32 else torch.float32
        dy = dy.to(dt)
        sf = weight.detach().to(dt).to(acc)
        bf = bias.detach().to(dt).to(acc)
        # x_hat = (y - beta) / gamma; where gamma is 0, y is beta and the
        # gradient is 0 as well
        ginv = torch.where(sf.abs() > 1e-30, 1.0 / sf,
                           torch.zeros_like(sf))
        dya = dy.to(acc)
        s1 = dya.sum((0, 2, 3))
        dyy = dya * y.to(acc) if acc == torch.float64 else (dy * y).to(acc)
        s2 = (dyy.sum((0, 2, 3)) - bf * s1) * ginv
        dgamma = s2.to(dt).to(weight.dtype)
        dbeta = s1.to(dt).to(bias.dtype)
        n = y.numel() // y.shape[1] * world_size()
        s = all_reduce_sum(torch.stack([s1, s2])) / n
        A = sf * rstd.to(acc)
        cy = -A * ginv * s[1]
        c0 = A * (ginv * s[1] * bf - s[0])
        dx = (_col(A.to(dt)) * dy + _col(cy.to(dt)) * y + _col(c0.to(dt)))
        return dx, dgamma, dbeta, None


def _reflect_fold(g: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Transpose of reflect padding along ``dim`` (layers.py:716-730): the
    core of ``g`` with the mirrored border strips added back, the low
    strip first, then the high one, each a slice add (no atomics)."""
    n = g.shape[dim] - 2 * pad
    core = g.narrow(dim, pad, n).clone(memory_format=torch.contiguous_format)
    core.narrow(dim, 1, pad).add_(g.narrow(dim, 0, pad).flip(dim))
    core.narrow(dim, n - pad - 1, pad).add_(
        g.narrow(dim, pad + n, pad).flip(dim))
    return core


class _ReflectPad(torch.autograd.Function):
    """Reflect padding of H and W whose backward is the JAX custom VJP's
    fold (layers.py:733-751): H first, then W, in a fixed order, so a
    step repeats bit for bit on the card (the CUDA backward of
    ``F.pad(mode="reflect")`` adds the mirrored gradients with atomics)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, pad: int) -> torch.Tensor:
        ctx.pad = pad
        B, C, H, W = x.shape
        # a fresh tensor in the standard layout: F.pad may hand 1-channel
        # planes channels-last strides, which a convolution passes on to
        # the instance-norm kernels, which refuse them
        out = x.new_empty((B, C, H + 2 * pad, W + 2 * pad))
        mid = out[:, :, pad:pad + H]
        mid[..., pad:pad + W] = x
        mid[..., :pad] = x[..., 1:pad + 1].flip(3)
        mid[..., pad + W:] = x[..., W - pad - 1:W - 1].flip(3)
        out[:, :, :pad] = out[:, :, pad + 1:2 * pad + 1].flip(2)
        out[:, :, pad + H:] = out[:, :, H - 1:H + pad - 1].flip(2)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        pad = ctx.pad
        return _reflect_fold(_reflect_fold(g, pad, 2), pad, 3), None


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W by ``pad`` (layers.py:734-750): the values of
    ``F.pad(x, (pad,) * 4, mode="reflect")`` in a contiguous tensor, and
    the JAX VJP's fixed-order backward."""
    return _ReflectPad.apply(x, pad)


class PReLU(nn.Module):
    """One learned slope, init 0.25: where(x >= 0, x, a x) with a in x's
    type (resnet_generator.py:20-26). The state dict is ``nn.PReLU``'s
    ``weight`` of shape (1,)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


@functools.lru_cache(maxsize=None)
def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) align-corners bilinear interpolation matrix
    (layers.py:_interp_matrix)."""
    m = np.zeros((dst, src), np.float32)
    if dst == 1 or src == 1:
        m[:, 0] = 1.0
        return m
    pos = np.linspace(0.0, src - 1, dst)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = (pos - lo).astype(np.float32)
    m[np.arange(dst), lo] += 1.0 - frac
    m[np.arange(dst), hi] += frac
    return m


@functools.lru_cache(maxsize=None)
def _half_pixel_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of ``jax.image.resize(method="bilinear")`` along
    one axis (jax/_src/image/scale.py:compute_weight_mat), in f32 as JAX
    computes them: the triangle kernel at the half-pixel sample points
    (d + 0.5) src / dst - 0.5, widened by src / dst when downsampling (the
    antialias), each row renormalised to sum to 1 over the taps inside the
    input, rows whose sample point lies outside it zero."""
    f32 = np.float32
    inv = f32(1.0 / (dst / src))
    kscale = max(inv, f32(1.0))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))  # (src, dst)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T.astype(f32)


def device_matrix(build: Callable[[int, int], np.ndarray], src: int,
                  dst: int, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``torch.from_numpy(build(src, dst)).to(device, dtype).float()``:
    a numpy builder's matrix (``_interp_matrix``, ``_half_pixel_matrix``,
    ``label_net._pool_matrix``) in f32 on ``device``, its values rounded
    through ``dtype``. Built once a (builder, sizes, device, dtype) and
    kept (``_resident_matrix``), so that a later call copies nothing to the
    device and waits for nothing, as a served call captured as a CUDA graph
    must. A ``torch.export`` or compile trace builds its own, as before,
    and keeps none: its tensors are fake."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(build(src, dst)).to(device, dtype).float()
    return _resident_matrix(build, src, dst, device, dtype)


@functools.lru_cache(maxsize=None)
def _resident_matrix(build, src: int, dst: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """``device_matrix``'s kept matrix. Made outside inference mode, so
    that a train step can save it for its backward; copied to a card from
    pinned memory, so the host does not wait for the copy."""
    with torch.inference_mode(False):
        host = torch.from_numpy(build(src, dst))
        if device.type == "cuda":
            host = host.pin_memory()
        return host.to(device, non_blocking=True).to(dtype).float()


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False,
                    replicated: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to ``size`` (layers.py:693-714), as
    interpolation matmuls (rows, then columns) summed in f32, each rounded
    to x's type with the weights in x's type, as the JAX package computes
    it; an axis whose size stays is left alone, and x comes back as it is
    when neither changes.

    ``align_corners=False`` (the default, as in JAX) is
    ``jax.image.resize(method="bilinear")``: half-pixel centres, and an
    antialiasing triangle when it downsamples (``_half_pixel_matrix``), so
    it is not ``F.interpolate`` below the input size. ``align_corners=True``
    is the JAX matmul form (``_interp_matrix``); ``F.interpolate(...,
    align_corners=True)`` agrees to rounding. Both directions run the one
    code path, and the backward is two matrix products, free of the
    atomics of ``F.interpolate``'s CUDA backward, so a step repeats bit for
    bit on the card.

    Under a width-sharded forward (``parallel.spatial``) ``size`` is the
    global size, and x a width shard, or with ``replicated`` the whole
    width on every rank; the width step computes this rank's columns
    (``spatial.resize_width``)."""
    B, C, H, W = x.shape
    h, w = size
    grid = spatial.active()
    if grid is None and (H, W) == (h, w):
        return x
    mat = _interp_matrix if align_corners else _half_pixel_matrix
    out = x.reshape(B * C, H, W)
    if h != H:
        wy = device_matrix(mat, H, h, x.device, x.dtype)
        out = torch.matmul(wy, out.float()).to(x.dtype)
    if grid is not None:
        out = spatial.resize_width(out, mat, w, replicated)
    elif w != W:
        wx = device_matrix(mat, W, w, x.device, x.dtype)
        out = torch.matmul(out.float(), wx.t()).to(x.dtype)
    return out.reshape(B, C, h, out.shape[-1])


class ConvBNAct(nn.Sequential):
    """conv(+BN)(+LeakyReLU 0.2) — common.py:conv_bn_relu."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = None, bn: bool = True, relu: bool = True):
        pad = (kernel - 1) // 2 if padding is None else padding
        layers = [nn.Conv2d(cin, cout, kernel, stride, pad, bias=not bn)]
        if bn:
            layers.append(BatchNorm2d(cout, eps=1e-5))
        if relu:
            layers.append(nn.LeakyReLU(0.2))
        super().__init__(*layers)


class ConvTBNAct(nn.Sequential):
    """convT(+BN)(+LeakyReLU 0.2) with ConvTranspose2d(3, 2, 1, 1) geometry —
    common.py:convt_bn_relu."""

    def __init__(self, cin: int, cout: int, bn: bool = True,
                 relu: bool = True):
        layers = [nn.ConvTranspose2d(cin, cout, 3, 2, 1, 1, bias=not bn)]
        if bn:
            layers.append(BatchNorm2d(cout, eps=1e-5))
        if relu:
            layers.append(nn.LeakyReLU(0.2))
        super().__init__(*layers)


class _EqualLinearInner(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.randn(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.in_dim = in_dim


class EqualLinear(nn.Module):
    """Equalized-LR linear applied per pixel over the channel axis."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear = _EqualLinearInner(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lin = self.linear
        w = lin.weight_orig * math.sqrt(2.0 / lin.in_dim)
        return F.conv2d(x, w[:, :, None, None], lin.bias)


class AdaptiveInstanceNorm(nn.Module):
    """W-AdaIN; ``weighting`` adds the 1x1-conv spatial weights."""

    def __init__(self, in_channel: int, style_dim: int,
                 weighting: bool = False):
        super().__init__()
        self.style = EqualLinear(style_dim, 2 * in_channel)
        with torch.no_grad():
            self.style.linear.bias[:in_channel] = 1.0
            self.style.linear.bias[in_channel:] = 0.0
        self.weighting = weighting
        if weighting:
            self.gamma_weight_layer = nn.Conv2d(in_channel, in_channel, 1)
            self.beta_weight_layer = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, content: torch.Tensor,
                style: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.style(style).chunk(2, dim=1)
        out = instance_norm(content)
        if self.weighting:
            return (self.gamma_weight_layer(content) * gamma * out
                    + self.beta_weight_layer(content) * beta)
        return gamma * out + beta


class AdaIN(nn.Module):
    """Parameter-free AdaIN (layers.py:607-618; model_utils.py:102-116):
    the content's per-channel mean and std replaced by the style's, each
    std the square root of the unbiased (ddof=1) variance plus eps. Plain
    torch: the JAX package has no kernel for it. Under a width-sharded
    forward the statistics are the global plane's
    (``spatial.plane_mean_var``)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, content: torch.Tensor,
                style: torch.Tensor) -> torch.Tensor:
        if spatial.active() is not None:
            (sm, sv), (cm, cv) = (spatial.plane_mean_var(t)
                                  for t in (style, content))
            ss, cs = torch.sqrt(sv + self.eps), torch.sqrt(cv + self.eps)
            return (content - cm) / cs * ss + sm
        dims = (2, 3)
        sm = style.mean(dim=dims, keepdim=True)
        ss = torch.sqrt(style.var(dim=dims, keepdim=True, correction=1)
                        + self.eps)
        cm = content.mean(dim=dims, keepdim=True)
        cs = torch.sqrt(content.var(dim=dims, keepdim=True, correction=1)
                        + self.eps)
        return (content - cm) / cs * ss + sm


class INFuse(nn.Module):
    """concat -> instance norm over the content's and the style's channels
    -> 1x1 conv back to the content's C (layers.py:621-630;
    model_utils.py:119-129). The norm is ``instance_norm``: the IN kernels
    on the card. ``style_channel`` defaults to ``in_channel``."""

    def __init__(self, in_channel: int, style_channel: int = None):
        super().__init__()
        cin = in_channel + (style_channel or in_channel)
        self.conv = nn.Conv2d(cin, in_channel, 1)

    def forward(self, content: torch.Tensor,
                style: torch.Tensor) -> torch.Tensor:
        return self.conv(instance_norm(torch.cat([content, style], dim=1)))


class NonBottleneck1D(nn.Module):
    """ERFNet's factorised residual block (layers.py:633-672; reference
    model_utils.py:131-199): 3x1 (stride s, 1) -> ReLU -> 1x3 (1, s) ->
    norm -> ReLU -> 3x1 (dilation d) -> ReLU -> 1x3 (dilation d) -> norm,
    every conv with a bias; then ReLU(out + identity), the identity a 1x1
    conv with a bias where the stride or the width changes, or the
    residual alone with ``residual_only``. The norm is ``BatchNorm2d``
    (eps 1e-3), or with ``use_in`` the instance norm (eps 1e-3, the IN
    kernels on the card). ``in_channels`` defaults to ``planes``."""

    def __init__(self, planes: int, stride: int = 1, dilation: int = 1,
                 use_in: bool = False, residual_only: bool = False,
                 in_channels: int = None):
        super().__init__()
        cin = planes if in_channels is None else in_channels
        d = dilation
        self.use_in = use_in
        self.residual_only = residual_only
        self.conv3x1_1 = nn.Conv2d(cin, planes, (3, 1), (stride, 1), (1, 0))
        self.conv1x3_1 = nn.Conv2d(planes, planes, (1, 3), (1, stride),
                                   (0, 1))
        self.conv3x1_2 = nn.Conv2d(planes, planes, (3, 1), 1, (d, 0), (d, 1))
        self.conv1x3_2 = nn.Conv2d(planes, planes, (1, 3), 1, (0, d), (1, d))
        if not use_in:
            self.bn1 = BatchNorm2d(planes, eps=1e-3)
            self.bn2 = BatchNorm2d(planes, eps=1e-3)
        self.downsample = None
        if not residual_only and (stride != 1 or cin != planes):
            self.downsample = nn.Conv2d(cin, planes, 1, stride)

    def _norm(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if self.use_in:
            return instance_norm(x, 1e-3)
        return getattr(self, f"bn{i}")(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv3x1_1(x))
        out = F.relu(self._norm(self.conv1x3_1(out), 1))
        out = F.relu(self.conv3x1_2(out))
        out = self._norm(self.conv1x3_2(out), 2)
        if self.residual_only:
            return out
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)
