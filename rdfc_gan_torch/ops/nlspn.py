"""Non-Local Spatial Propagation (NLSPN): offsets, affinities and the
reference-exact gather propagation (port of rdfc_gan_tpu/ops/nlspn.py).

Layout is channel-first. The offset/affinity conv output keeps the reference
channel layout (nlspn_model.py:73-80): it is chunked into (o1, o2, aff) and
``cat(o1, o2)`` is viewed as (num, 2), so tap i reads channels (2i, 2i+1).
Offsets are returned as (B, K, 2, H, W) with [..., 0, :, :] the y offset, and
affinities as (B, K, H, W), K = prop_kernel^2 with the center tap inserted.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .deform import bilinear_sample, kernel_grid_offsets


class NLSPNParamsSpec(NamedTuple):
    """Static configuration of an NLSPN refine stage (nlspn_model.py:180-189)."""

    prop_kernel: int = 3
    prop_time: int = 18
    affinity: str = "TGASS"
    affinity_gamma: float = 0.5
    conf_prop: bool = True
    preserve_input: bool = False

    @property
    def num_neighbors(self) -> int:
        return self.prop_kernel * self.prop_kernel - 1


def _conf_sample_shifts(confidence: torch.Tensor, nb_offsets: torch.Tensor,
                        R: int) -> torch.Tensor:
    """Sample the confidence map at per-tap fractional offsets clamped to
    [-R, R] as shifted-image multiply-adds (no gather). Exact against the
    gather whenever |offset| <= R.

    confidence: (B, 1, H, W); nb_offsets: (B, num, 2, H, W).
    Returns (B, num, H, W). The per-(pixel, tap) weight of shift (sy, sx)
    factorises as ay(sy) * ax(sx) with ay(sy) = (1-fy)[q0y = sy] +
    fy[q0y = sy-1]."""
    H, W = confidence.shape[2:]
    q = torch.clamp(nb_offsets.detach(), -R, R)
    q0 = torch.floor(q)
    fy = (q[:, :, 0] - q0[:, :, 0]).to(confidence.dtype)
    fx = (q[:, :, 1] - q0[:, :, 1]).to(confidence.dtype)
    q0y = q0[:, :, 0].to(torch.int32)
    q0x = q0[:, :, 1].to(torch.int32)
    pad = R + 1
    cp = F.pad(confidence[:, 0], (pad, pad, pad, pad))
    shifts = range(-R, R + 2)
    ax = [(1 - fx) * (q0x == sx) + fx * (q0x == sx - 1) for sx in shifts]
    out = torch.zeros_like(fy)
    for sy in shifts:
        ay = (1 - fy) * (q0y == sy) + fy * (q0y == sy - 1)
        row = torch.zeros_like(fy)
        for ix, sx in enumerate(shifts):
            sl = cp[:, pad + sy: pad + sy + H, pad + sx: pad + sx + W]
            row = row + ax[ix] * sl[:, None]
        out = out + ay * row
    return out


def nlspn_offset_affinity(
    offset_aff_raw: torch.Tensor,
    confidence: Optional[torch.Tensor],
    aff_scale_const: torch.Tensor,
    spec: NLSPNParamsSpec,
    conf_sample_radius: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full K-tap offsets and normalized affinities.

    offset_aff_raw: (B, 3*num, H, W) guidance-conv output (reference layout);
    confidence: (B, 1, H, W) or None. ``conf_sample_radius`` set (the
    stencil dispatch) samples confidence with offsets clamped to that
    radius; None is the reference-exact gather.
    Returns offsets (B, K, 2, H, W), zero at the center tap, and affinities
    (B, K, H, W) with 1 - sum(neighbours) at the center."""
    num = spec.num_neighbors
    idx_ref = num // 2
    B, _, H, W = offset_aff_raw.shape
    o1, o2, aff = torch.chunk(offset_aff_raw, 3, dim=1)
    nb_offsets = torch.cat((o1, o2), dim=1).reshape(B, num, 2, H, W)

    if spec.affinity in ("AS", "ASS"):
        pass
    elif spec.affinity == "TC":
        aff = torch.tanh(aff) / aff_scale_const
    elif spec.affinity == "TGASS":
        aff = torch.tanh(aff) / (aff_scale_const + 1e-8)
    else:
        raise NotImplementedError(spec.affinity)

    if spec.conf_prop:
        if confidence is None:
            raise ValueError("conf_prop needs a confidence map")
        if conf_sample_radius is not None:
            conf = _conf_sample_shifts(confidence, nb_offsets,
                                       conf_sample_radius)
        else:
            # 1x1 deformable gather of the confidence at each neighbour's
            # learned offset, no kernel-grid displacement (nlspn_model.py:
            # 96-119)
            dev = offset_aff_raw.device
            yy = torch.arange(H, dtype=torch.float32, device=dev).view(
                1, 1, H, 1)
            xx = torch.arange(W, dtype=torch.float32, device=dev).view(
                1, 1, 1, W)
            off = nb_offsets.detach()
            conf = bilinear_sample(confidence, yy + off[:, :, 0],
                                   xx + off[:, :, 1])[:, 0]
        aff = aff * conf

    # abs-sum normalization with the >= 1 clamp (nlspn_model.py:121-131)
    aff_abs_sum = torch.sum(torch.abs(aff), dim=1, keepdim=True) + 1e-4
    if spec.affinity in ("ASS", "TGASS"):
        aff_abs_sum = torch.clamp(aff_abs_sum, min=1.0)
    if spec.affinity in ("AS", "ASS", "TGASS"):
        aff = aff / aff_abs_sum
    aff_ref = 1.0 - torch.sum(aff, dim=1, keepdim=True)

    zeros = torch.zeros_like(nb_offsets[:, :1])
    offsets = torch.cat([nb_offsets[:, :idx_ref], zeros,
                         nb_offsets[:, idx_ref:]], dim=1)
    aff_full = torch.cat([aff[:, :idx_ref], aff_ref, aff[:, idx_ref:]], dim=1)
    return offsets, aff_full


def precompute_taps(offsets: torch.Tensor, aff: torch.Tensor,
                    prop_kernel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold affinity and bilinear weights into flat gather pairs.

    Returns idx (B, 4K, H*W) int64 into the flattened H*W axis and
    w (B, 4K, H*W), ordered (tap, corner); out-of-image corners get weight 0.
    """
    B, K, _, H, W = offsets.shape
    dev = offsets.device
    grid = torch.from_numpy(kernel_grid_offsets(prop_kernel, prop_kernel)).to(
        dev).view(1, K, 2, 1, 1)
    yy = torch.arange(H, dtype=torch.float32, device=dev).view(1, 1, H, 1)
    xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, 1, W)
    y = (yy + grid[:, :, 0]) + offsets[:, :, 0]
    x = (xx + grid[:, :, 1]) + offsets[:, :, 1]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
    idxs, ws = [], []
    for dy, dx, wgt in ((0, 0, wy0 * wx0), (0, 1, wy0 * wx1),
                        (1, 0, wy1 * wx0), (1, 1, wy1 * wx1)):
        yi, xi = y0i + dy, x0i + dx
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idxs.append(yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        ws.append(wgt * inb.to(wgt.dtype) * aff)
    idx = torch.stack(idxs, dim=2).reshape(B, 4 * K, H * W)
    w = torch.stack(ws, dim=2).reshape(B, 4 * K, H * W)
    return idx, w


def nlspn_propagate(feat_init: torch.Tensor, offsets: torch.Tensor,
                    aff: torch.Tensor, spec: NLSPNParamsSpec,
                    feat_fix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``prop_time`` gather propagation steps in f32. feat_init: (B,1,H,W)."""
    B, C, H, W = feat_init.shape
    if C != 1:
        raise ValueError("NLSPN propagates a single-channel feature")
    idx, w = precompute_taps(offsets, aff, spec.prop_kernel)
    K4 = idx.shape[1]
    idx_flat = idx.reshape(B, K4 * H * W)
    w = w.float()
    fix = fix_mask = None
    if spec.preserve_input:
        if feat_fix is None:
            raise ValueError("preserve_input needs feat_fix")
        fix = feat_fix.reshape(B, H * W).float()
        fix_mask = fix > 0.0
    feat = feat_init.reshape(B, H * W).float()
    for _ in range(spec.prop_time):
        if fix is not None:
            feat = torch.where(fix_mask, fix, feat)
        g = torch.gather(feat, 1, idx_flat).reshape(B, K4, H * W)
        feat = torch.sum(g * w, dim=1)
    return feat.reshape(B, 1, H, W).to(feat_init.dtype)


def nlspn_refine(pred_init: torch.Tensor, offset_aff_raw: torch.Tensor,
                 confidence: Optional[torch.Tensor],
                 aff_scale_const: torch.Tensor, spec: NLSPNParamsSpec,
                 origin_depth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole NLSPN refine stage (NLSPNRefineModule.forward,
    nlspn_model.py:191-197): offsets and affinities once, then the gather
    propagation. pred_init, origin_depth: (B, 1, H, W). Returns the refined
    depth; the caller keeps its own confidence."""
    offsets, aff = nlspn_offset_affinity(offset_aff_raw, confidence,
                                         aff_scale_const, spec)
    return nlspn_propagate(pred_init, offsets, aff, spec,
                           feat_fix=origin_depth)
