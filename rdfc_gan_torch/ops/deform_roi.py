"""Deformable position-sensitive ROI pooling (port of
rdfc_gan_tpu/ops/deform_roi.py; the reference's
deformconv/src/deform_psroi_pooling_cuda.cu, exported by its DCN module and
used by no shipped model).

For ROI (batch_idx, x1, y1, x2, y2) scaled by ``spatial_scale`` (with the
-0.5 pixel shift), a grid of ``pooled_size`` x ``pooled_size`` bins; each
bin averages ``sample_per_part``^2 bilinear taps, moved by the optional
per-part offsets times gamma and the ROI's size. With ``output_dim`` given
and C a multiple of pooled_size^2, bin (i, j) reads channel group
i * pooled_size + j (position-sensitive).
"""

from __future__ import annotations

from typing import Optional

import torch

from .deform import bilinear_sample


def deform_psroi_pooling(feat: torch.Tensor, rois: torch.Tensor,
                         offsets: Optional[torch.Tensor],
                         pooled_size: int = 7,
                         output_dim: Optional[int] = None,
                         spatial_scale: float = 1.0 / 16.0,
                         sample_per_part: int = 4, gamma: float = 0.1,
                         no_trans: bool = False) -> torch.Tensor:
    """feat: (B, C, H, W); rois: (N, 5) [batch_idx, x1, y1, x2, y2];
    offsets: (N, 2, P, P) normalised part offsets ([:, 0] dy) or None.
    Returns (N, C', P, P), P = ``pooled_size``: C' = C / P^2 where the
    input is position-sensitive, else C."""
    B, C, H, W = feat.shape
    N = rois.shape[0]
    P, s = pooled_size, sample_per_part
    ps = C % (P * P) == 0 and C // (P * P) > 0 and output_dim is not None
    dev = feat.device

    batch_idx = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - 0.5
    y1 = rois[:, 2] * spatial_scale - 0.5
    x2 = rois[:, 3] * spatial_scale - 0.5
    y2 = rois[:, 4] * spatial_scale - 0.5
    roi_w = torch.clamp_min(x2 - x1, 0.1)
    roi_h = torch.clamp_min(y2 - y1, 0.1)
    # divisions by tensors: ATen's CUDA division by a Python number
    # multiplies by its reciprocal, which moves the taps by an ulp against
    # the CPU's (and JAX's) IEEE division
    bin_w = roi_w / torch.full_like(roi_w, P)
    bin_h = roi_h / torch.full_like(roi_h, P)
    sub_w = bin_w / torch.full_like(bin_w, s)
    sub_h = bin_h / torch.full_like(bin_h, s)

    def col(v):  # an (N,) vector against the (N, P, P, s, s) grid
        return v.view(N, 1, 1, 1, 1)

    ar = torch.arange(P, dtype=torch.float32, device=dev)
    sr = torch.arange(s, dtype=torch.float32, device=dev)
    py, px = ar.view(1, P, 1, 1, 1), ar.view(1, 1, P, 1, 1)
    sy, sx = sr.view(1, 1, 1, s, 1), sr.view(1, 1, 1, 1, s)
    ys = col(y1) + py * col(bin_h) + (sy + 0.5) * col(sub_h)
    xs = col(x1) + px * col(bin_w) + (sx + 0.5) * col(sub_w)
    if offsets is not None and not no_trans:
        ys = ys + offsets[:, 0, :, :, None, None] * gamma * (col(bin_h) * P)
        xs = xs + offsets[:, 1, :, :, None, None] * gamma * (col(bin_w) * P)
    ys, xs = torch.broadcast_tensors(ys, xs)  # (N, P, P, s, s)

    # each ROI samples its own batch item: one sampling call per item
    pooled = feat.new_zeros((N, C, P, P))
    for b in range(B):
        sel = (batch_idx == b).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        n = sel.numel()
        samples = bilinear_sample(feat[b:b + 1], ys[sel].reshape(1, -1),
                                  xs[sel].reshape(1, -1))
        samples = samples.reshape(C, n, P, P, s * s).sum(dim=-1)
        samples = samples / torch.full_like(samples, s * s)  # IEEE mean
        pooled = pooled.index_copy(0, sel, samples.permute(1, 0, 2, 3))

    if ps:
        # bin (i, j) reads channel group i * P + j
        cp = C // (P * P)
        pooled = pooled.reshape(N, P * P, cp, P, P)
        bins = torch.arange(P * P, device=dev)
        pooled = pooled[:, bins, :, bins // P, bins % P]  # (P*P, N, cp)
        pooled = pooled.permute(1, 2, 0).reshape(N, cp, P, P)
    return pooled
