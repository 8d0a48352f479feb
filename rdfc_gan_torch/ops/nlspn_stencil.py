"""NLSPN propagation as a gather-free static-shift stencil, with its O(T)
two-phase backward (port of rdfc_gan_tpu/ops/nlspn_stencil.py).

With learned offsets clamped to radius R, every bilinear corner of every
tap lands on an integer shift in the window [-(R+1), R+2]^2. Folding
bilinear weight x affinity into per-shift mask planes M_s, computed once,
turns each propagation step into feat <- sum_s M_s * shift_s(feat). Exact
against the gather propagation whenever |offset| <= R.

The plain versions of the propagation kernels live here: the forward chain
that also stacks each step's input X (``propagate_x_plain``), and the
reverse gradient chain (``reverse_chain_plain``); the mask-gradient
contraction is ``mask_kernel.shift_correlation_plain``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .deform import kernel_grid_offsets
from .kernels import mask_kernel


def shift_window(R: int) -> Tuple[int, int]:
    """Integer shift range [lo, hi] covered by clamp radius R and a 3x3
    kernel grid."""
    return -(R + 1), R + 2


def build_shift_masks(offsets: torch.Tensor, aff: torch.Tensor,
                      prop_kernel: int, R: int = 2) -> torch.Tensor:
    """Fold (offsets, affinities) into per-shift mask planes.

    offsets: (B, K, 2, H, W); aff: (B, K, H, W). Returns M (B, S, S, H, W)
    in ``offsets.dtype``, S = 2R+4, M[b, iy, ix] the mask of shift
    (lo+iy, lo+ix). Out-of-image contributions are not masked here: the
    propagation zero-pads the shifted feature. The scatter of the 4K
    (tap, corner) weights runs through ``mask_kernel.scatter_shift_masks``
    (the CUDA kernel on the card), whose backward is the gather."""
    B, K, _, H, W = offsets.shape
    lo, hi = shift_window(R)
    S = hi - lo + 1
    dev = offsets.device
    grid = torch.from_numpy(kernel_grid_offsets(prop_kernel, prop_kernel)).to(
        dev).view(1, K, 2, 1, 1)
    q = torch.clamp(offsets, -R, R) + grid
    q0 = torch.floor(q)
    frac = q - q0
    q0 = q0.to(torch.int32)
    wy1 = frac[:, :, 0]
    wx1 = frac[:, :, 1]
    wgt = torch.stack([(1 - wy1) * (1 - wx1), (1 - wy1) * wx1,
                       wy1 * (1 - wx1), wy1 * wx1], dim=2)  # (B,K,4,H,W)
    dy = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev).view(
        1, 1, 4, 1, 1)
    dx = torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev).view(
        1, 1, 4, 1, 1)
    sy = (q0[:, :, 0:1] + dy - lo).reshape(B, 4 * K, H, W)
    sx = (q0[:, :, 1:2] + dx - lo).reshape(B, 4 * K, H, W)
    cdt = offsets.dtype if offsets.dtype == torch.bfloat16 else torch.float32
    w = (wgt * aff[:, :, None]).reshape(B, 4 * K, H, W).to(cdt)
    M = mask_kernel.scatter_shift_masks(w.contiguous(), sy, sx, S)
    return M.reshape(B, S, S, H, W).to(offsets.dtype)


def _pad(lo: int, S: int) -> int:
    return max(-lo, lo + S - 1)


def apply_stencil(x: torch.Tensor, M: torch.Tensor, lo: int) -> torch.Tensor:
    """One propagation step: sum_s M_s * shift_s(x), x (B, H, W) f32, zero
    outside the image. A bf16 M promotes to f32 in the multiply."""
    B, H, W = x.shape
    S = M.shape[1]
    pad = _pad(lo, S)
    xp = F.pad(x, (pad, pad, pad, pad))
    acc = torch.zeros_like(x)
    for iy in range(S):
        for ix in range(S):
            dy, dx = lo + iy, lo + ix
            acc = acc + M[:, iy, ix] * xp[:, pad + dy: pad + dy + H,
                                          pad + dx: pad + dx + W]
    return acc


def apply_stencil_T(g: torch.Tensor, M: torch.Tensor, lo: int) -> torch.Tensor:
    """Transpose of ``apply_stencil`` in x: sum_s shift_{-s}(M_s * g), the
    shifted product zero outside the image."""
    B, H, W = g.shape
    S = M.shape[1]
    pad = _pad(lo, S)
    acc = torch.zeros_like(g)
    for iy in range(S):
        for ix in range(S):
            dy, dx = lo + iy, lo + ix
            mg = F.pad(M[:, iy, ix] * g, (pad, pad, pad, pad))
            acc = acc + mg[:, pad - dy: pad - dy + H, pad - dx: pad - dx + W]
    return acc


def propagate_x_plain(feat0: torch.Tensor, M: torch.Tensor,
                      fix: Optional[torch.Tensor], prop_time: int, R: int,
                      x_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward chain on (B, H, W) f32 planes, also stacking each step's
    input after the preserve substitution (``fix`` given: the map is fix
    where fix > 0). Returns (out f32, X (T, B, H, W) in ``x_dtype``)."""
    lo, _ = shift_window(R)
    fixm = None if fix is None else fix > 0.0
    X = torch.empty((prop_time,) + tuple(feat0.shape), dtype=x_dtype,
                    device=feat0.device)
    feat = feat0
    for t in range(prop_time):
        x = feat if fixm is None else torch.where(fixm, fix, feat)
        X[t] = x
        feat = apply_stencil(x, M, lo)
    return feat, X


def reverse_chain_plain(g0: torch.Tensor, M: torch.Tensor,
                        fix: Optional[torch.Tensor], prop_time: int, R: int,
                        g_dtype: torch.dtype
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1 of the backward (nlspn_stencil.py:_prop_bwd's reverse scan):
    from the output gradient g0 (B, H, W) f32, for t = T-1..0 stack
    G[t] = gg and chain gg <- stencil^T(gg), splitting off dfix where
    fix > 0. Returns (G (T, B, H, W) in ``g_dtype``, dfeat, dfix), f32."""
    lo, _ = shift_window(R)
    fixm = None if fix is None else fix > 0.0
    G = torch.empty((prop_time,) + tuple(g0.shape), dtype=g_dtype,
                    device=g0.device)
    gg = g0
    dfix = torch.zeros_like(g0)
    for t in reversed(range(prop_time)):
        G[t] = gg
        dx = apply_stencil_T(gg, M, lo)
        if fixm is not None:
            dfix = dfix + torch.where(fixm, dx, 0.0)
            dx = torch.where(fixm, 0.0, dx)
        gg = dx
    return G, gg, dfix


class _StencilPropagate(torch.autograd.Function):
    """Plain stencil propagation with the hand-written O(T) backward of
    nlspn_stencil.py:_prop_fwd/_prop_bwd: the forward keeps only the f32
    input stack X; the backward runs the reverse chain, then one shift
    correlation for dM. Autograd through the T * S^2 slices would keep
    about 1.25 GB of intermediates at 224x304, T=18."""

    @staticmethod
    def forward(ctx, feat_init, M, feat_fix, prop_time, R, preserve_input):
        fix = None
        if preserve_input:
            if feat_fix is None:
                raise ValueError("preserve_input needs feat_fix")
            fix = feat_fix[:, 0].float()
        out, X = propagate_x_plain(feat_init[:, 0].float(), M, fix,
                                   prop_time, R, torch.float32)
        ctx.save_for_backward(X, M, fix)
        ctx.prop_time, ctx.R = prop_time, R
        ctx.fix_dtype = None if feat_fix is None else feat_fix.dtype
        return out[:, None].to(feat_init.dtype)

    @staticmethod
    def backward(ctx, g):
        X, M, fix = ctx.saved_tensors
        lo, _ = shift_window(ctx.R)
        S = M.shape[1]
        G, dfeat, dfix = reverse_chain_plain(g[:, 0].float(), M, fix,
                                             ctx.prop_time, ctx.R,
                                             torch.float32)
        dM = None
        if ctx.needs_input_grad[1]:
            dM = mask_kernel.shift_correlation_plain(G, X, S, lo).reshape(
                M.shape).to(M.dtype)
        dfix_out = None
        if fix is not None and ctx.needs_input_grad[2]:
            dfix_out = dfix[:, None].to(ctx.fix_dtype)
        return dfeat[:, None].to(g.dtype), dM, dfix_out, None, None, None


def stencil_propagate(feat_init: torch.Tensor, M: torch.Tensor,
                      prop_time: int, R: int = 2,
                      feat_fix: Optional[torch.Tensor] = None,
                      preserve_input: bool = False) -> torch.Tensor:
    """Plain stencil propagation in f32, differentiable in feat_init, M and
    feat_fix. feat_init: (B, 1, H, W); M: (B, S, S, H, W). With
    ``preserve_input`` the map is set to feat_fix where feat_fix > 0 at the
    start of every step; the result is the last step's sum."""
    if prop_time < 1:
        return feat_init.clone()
    return _StencilPropagate.apply(feat_init, M, feat_fix, prop_time, R,
                                   preserve_input)


def nlspn_refine_stencil(pred_init: torch.Tensor,
                         offset_aff_raw: torch.Tensor,
                         confidence: Optional[torch.Tensor],
                         aff_scale_const: torch.Tensor, spec,
                         origin_depth: Optional[torch.Tensor] = None,
                         R: int = 2) -> torch.Tensor:
    """``ops.nlspn.nlspn_refine`` on the stencil path: offsets and
    affinities (confidence sampled by the gather), the shift masks of clamp
    radius R, then ``propagate_auto`` (the scatter kernel and the card's
    chain for a CUDA tensor). ``spec`` is an ``NLSPNParamsSpec``."""
    from .kernels.nlspn_kernel import propagate_auto
    from .nlspn import nlspn_offset_affinity

    offsets, aff = nlspn_offset_affinity(offset_aff_raw, confidence,
                                         aff_scale_const, spec)
    M = build_shift_masks(offsets, aff, spec.prop_kernel, R)
    return propagate_auto(pred_init, M, spec.prop_time, R,
                          feat_fix=origin_depth,
                          preserve_input=spec.preserve_input)
