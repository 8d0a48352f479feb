"""Deformable sampling ops (port of rdfc_gan_tpu/ops/deform.py): the
replacement of the reference's only native code, the DCNv2 CUDA extension.

  * ``bilinear_sample``: the 4-corner zero-padded bilinear gather;
  * ``deform_gather``: K taps a pixel, feat sampled at p + grid_k +
    offset_k and modulated by mask_k (the im2col half of DCNv2);
  * ``modulated_deform_conv``: deform_gather, then one matmul a group.

Layout is channel-first: feat (B, C, H, W); offsets (B, K, 2, H, W) with
[:, :, 0] the y offset, as ``ops/nlspn`` keeps them; mask (B, K, H, W); the
weight (Cout, Cin / groups, kh, kw), the reference DCNv2 schema
(``utils/convert.deform_conv_weight_from_jax`` carries a JAX weight over).
Boundary semantics are the reference CUDA sampler's (modulated_deform_
im2col_cuda.cuh:25-54): every bilinear corner outside the image contributes
zero.

The gradient of the sampled feature adds each pixel's contributions in a
fixed order (``_FixedOrderGather``), as the JAX transpose does: the
backward of ``torch.gather`` on a CUDA tensor adds them with atomics, in an
order that changes from run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def kernel_grid_offsets(kh: int, kw: int, dilation: int = 1) -> np.ndarray:
    """Static (K, 2) integer (dy, dx) tap displacements of a centered kernel,
    row-major (the CUDA im2col loop order i * kernel_w + j)."""
    ys = (np.arange(kh) - (kh - 1) // 2) * dilation
    xs = (np.arange(kw) - (kw - 1) // 2) * dilation
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    return grid.astype(np.float32)


def _fixed_order_scatter_add(g: torch.Tensor, idx: torch.Tensor,
                             L: int) -> torch.Tensor:
    """out[b, :, l] = sum of g[b, :, n] over the n with idx[b, n] == l,
    added in an order that does not change from run to run. g: (B, C, N);
    idx: (B, N) int64 in [0, L). On the CPU ``index_add_`` adds one n at a
    time in increasing n (the order of ``scatter_add_``; a CPU
    ``index_put_`` with ``accumulate`` adds with atomics on several
    threads). On the card ``index_put_`` with ``accumulate`` sorts the
    targets and sums each target's contributions in one thread or warp,
    with no atomics."""
    B, C, N = g.shape
    base = torch.arange(B, device=idx.device)[:, None] * L
    target = (idx + base).reshape(-1)
    rows = g.permute(0, 2, 1).reshape(B * N, C)
    out = torch.zeros((B * L, C), dtype=g.dtype, device=g.device)
    if g.device.type == "cpu":
        out.index_add_(0, target, rows)
    else:
        out.index_put_((target,), rows, accumulate=True)
    return out.reshape(B, L, C).permute(0, 2, 1)


class _FixedOrderGather(torch.autograd.Function):
    """``torch.gather(src, 2, idx.expand(B, C, N))`` for src (B, C, L) and
    idx (B, 1, N), whose backward adds in a fixed order
    (``_fixed_order_scatter_add``) where PyTorch's CUDA ``scatter_add_``
    uses atomics. idx gets no gradient."""

    @staticmethod
    def forward(ctx, src, idx):
        B, C, L = src.shape
        ctx.save_for_backward(idx)
        ctx.L = L
        return torch.gather(src, 2, idx.expand(B, C, idx.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _fixed_order_scatter_add(g.contiguous(), idx[:, 0],
                                        ctx.L), None


def bilinear_sample(feat: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling.

    feat: (B, C, H, W); y, x: (B, ...) fractional pixel coordinates of the
    same shape. Returns (B, C, ...); positions fully outside the image
    give 0. Differentiable in feat (fixed-order backward), y and x."""
    B, C, H, W = feat.shape
    out_shape = y.shape[1:]
    y = y.reshape(B, 1, -1)
    x = x.reshape(B, 1, -1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = y - y0
    wx1 = x - x0
    wy0 = 1.0 - wy1
    wx0 = 1.0 - wx1
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    flat = feat.reshape(B, C, H * W)

    def tap(yi, xi, w):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = _FixedOrderGather.apply(flat, idx)
        return vals * (w * inb.to(feat.dtype))

    out = (tap(y0i, x0i, wy0 * wx0)
           + tap(y0i, x0i + 1, wy0 * wx1)
           + tap(y0i + 1, x0i, wy1 * wx0)
           + tap(y0i + 1, x0i + 1, wy1 * wx1))
    return out.reshape((B, C) + tuple(out_shape))


def deform_gather(feat: torch.Tensor, offsets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  kernel_size: Tuple[int, int] = (3, 3),
                  dilation: int = 1) -> torch.Tensor:
    """K-tap deformable gather (the im2col half of a modulated deform conv).

    feat: (B, C, H, W); offsets: (B, K, 2, H, W) learned fractional
    (dy, dx) a tap, K = kh * kw; mask: optional (B, K, H, W) modulation
    (the DCNv2 mask, or NLSPN's affinity). Returns (B, C, K, H, W), the
    samples at p + grid_k * dilation + offset_k times mask_k."""
    B, C, H, W = feat.shape
    K = offsets.shape[1]
    kh, kw = kernel_size
    if K != kh * kw or tuple(offsets.shape) != (B, K, 2, H, W):
        raise ValueError(f"offsets (B, {kh * kw}, 2, H, W) expected for a "
                         f"{kh}x{kw} kernel, got {tuple(offsets.shape)}")
    dev = feat.device
    grid = torch.from_numpy(kernel_grid_offsets(kh, kw, dilation)).to(
        dev).view(1, K, 2, 1, 1)
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(1, 1, H, 1)
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, 1, W)
    y = (yy + grid[:, :, 0]) + offsets[:, :, 0]
    x = (xx + grid[:, :, 1]) + offsets[:, :, 1]
    samples = bilinear_sample(feat, y, x)  # (B, C, K, H, W)
    if mask is not None:
        samples = samples * mask[:, None].to(samples.dtype)
    return samples


def modulated_deform_conv(feat: torch.Tensor, offsets: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          dilation: int = 1,
                          groups: int = 1) -> torch.Tensor:
    """Modulated deformable convolution (the DCNv2 forward), stride 1,
    'same' padding.

    feat: (B, Cin, H, W); offsets: (B, K, 2, H, W); mask: (B, K, H, W), or
    None for a plain deformable conv; weight: (Cout, Cin / groups, kh, kw),
    K = kh * kw; bias: (Cout,) or None. Returns (B, Cout, H, W).

    The contraction is one (Cout/g, Cin/g * K) @ (Cin/g * K, H*W) matmul a
    group and image, the reference's column order (channel-major, then
    tap); JAX's ``jnp.dot`` / ``einsum`` of the same products."""
    B, Cin, H, W = feat.shape
    Cout, cg, kh, kw = weight.shape
    if Cin % groups or Cout % groups or cg != Cin // groups:
        raise ValueError(f"weight (Cout, Cin/groups, kh, kw) with groups "
                         f"dividing Cin={Cin} and Cout expected, got "
                         f"{tuple(weight.shape)}, groups={groups}")
    K = kh * kw
    samples = deform_gather(feat, offsets, mask, (kh, kw), dilation)
    cols = samples.reshape(B, groups, cg * K, H * W)
    w = weight.reshape(groups, Cout // groups, cg * K).to(cols.dtype)
    out = torch.matmul(w, cols).reshape(B, Cout, H, W)
    if bias is not None:
        out = out + bias.view(1, Cout, 1, 1).to(out.dtype)
    return out
