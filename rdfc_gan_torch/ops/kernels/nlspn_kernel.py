"""NLSPN propagation chain on the card: wrappers of
``csrc/nlspn_propagate.cu`` (the served chain, and the chain that also
stores each step's input X) and ``csrc/nlspn_reverse_chain.cu``, the
differentiable ``nlspn_stencil_propagate`` built from them, and the
dispatcher ``propagate_auto`` (port of rdfc_gan_tpu/ops/pallas/
nlspn_kernel.py). The plain versions are ``stencil_propagate``,
``propagate_x_plain`` and ``reverse_chain_plain`` of ``ops/nlspn_stencil``.

As on the TPU, the kernel path rounds the mask stack to bf16 and sums in
f32 (nlspn_kernel.py:303), so its output differs from the unrounded plain
stencil that CPU runs take by the bf16 rounding of M. Its backward treats
the rounding as the identity (straight-through, nlspn_kernel.py:404-413).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..nlspn_stencil import (propagate_x_plain, reverse_chain_plain,
                             shift_window, stencil_propagate)
from . import build, mask_kernel

NAME = "nlspn_propagate"
NAME_X = "nlspn_propagate_x"
CHAIN = "nlspn_reverse_chain"


def _stack_dtype(M: torch.Tensor) -> torch.dtype:
    """Type of the X and G stacks (nlspn_kernel.py:_stack_dtype): bf16 for
    a bf16 mask stack, else f32."""
    return torch.bfloat16 if M.dtype == torch.bfloat16 else torch.float32


def _check_planes(name, planes, M16, fix, R):
    lo, hi = shift_window(R)
    S = hi - lo + 1
    B, H, W = planes.shape
    if tuple(M16.shape) != (B, S, S, H, W) or M16.dtype != torch.bfloat16:
        raise ValueError(f"{name}: plane (B,H,W) f32 and M (B,{S},{S},H,W) "
                         f"bf16 expected, got {tuple(planes.shape)} and "
                         f"{tuple(M16.shape)} {M16.dtype}")
    tensors = (planes, M16) + (() if fix is None else (fix,))
    build.require_cuda(name, *tensors)
    if planes.dtype != torch.float32 or (fix is not None and (
            fix.shape != planes.shape or fix.dtype != torch.float32)):
        raise ValueError(f"{name}: planes and fix must be (B,H,W) f32")
    return lo, S


def _launch_chain(lib, feat0, M16, fix, X, R, prop_time):
    """Runs kernels 3 (X None) or 4 (X the (T,B,H,W) stack) for
    ``prop_time`` >= 1 steps; returns the (B, H, W) f32 output."""
    lo, S = _check_planes(NAME, feat0, M16, fix, R)
    B, H, W = feat0.shape
    out = torch.empty_like(feat0)
    tmp = torch.empty_like(feat0) if prop_time > 1 else out
    rc = lib.nlspn_propagate(feat0.data_ptr(), M16.data_ptr(),
                             None if fix is None else fix.data_ptr(),
                             out.data_ptr(), tmp.data_ptr(),
                             None if X is None else X.data_ptr(),
                             int(X is not None and X.dtype == torch.bfloat16),
                             B, H, W, S, lo, prop_time, build.stream_handle())
    build.check(lib, NAME, rc)
    return out


def propagate_x(feat0: torch.Tensor, M16: torch.Tensor,
                fix: Optional[torch.Tensor], prop_time: int, R: int,
                x_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward chain that also stores X (TPU ``_pallas_forward_x``).
    feat0, fix: (B, H, W) f32 (fix None: no preserve substitution); M16:
    (B, S, S, H, W) bf16. Returns (out f32, X (T, B, H, W) in ``x_dtype``).
    A CPU tensor takes the plain version; any other launches the CUDA
    kernel (``prop_time`` launches) or raises."""
    if feat0.device.type == "cpu":
        return propagate_x_plain(feat0, M16, fix, prop_time, R, x_dtype)
    lib = build.library(NAME)
    if x_dtype not in (torch.float32, torch.bfloat16) or prop_time < 1:
        raise ValueError(f"{NAME_X}: x_dtype f32/bf16 and prop_time >= 1")
    X = torch.empty((prop_time,) + tuple(feat0.shape), dtype=x_dtype,
                    device=feat0.device)
    out = _launch_chain(lib, feat0, M16, fix, X, R, prop_time)
    build.LAUNCHES[NAME_X] += prop_time
    return out, X


def reverse_chain(g0: torch.Tensor, M16: torch.Tensor,
                  fix: Optional[torch.Tensor], prop_time: int, R: int,
                  g_dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse gradient chain (TPU ``_pallas_reverse_chain``). g0, fix:
    (B, H, W) f32; M16: (B, S, S, H, W) bf16. Returns (G (T, B, H, W) in
    ``g_dtype``, dfeat, dfix), the last two (B, H, W) f32 (dfix zero
    without preserve). A CPU tensor takes the plain version; any other
    launches the CUDA kernel (``prop_time`` launches) or raises."""
    if g0.device.type == "cpu":
        return reverse_chain_plain(g0, M16, fix, prop_time, R, g_dtype)
    lib = build.library(CHAIN)
    lo, S = _check_planes(CHAIN, g0, M16, fix, R)
    if g_dtype not in (torch.float32, torch.bfloat16) or prop_time < 1:
        raise ValueError(f"{CHAIN}: g_dtype f32/bf16 and prop_time >= 1")
    B, H, W = g0.shape
    G = torch.empty((prop_time, B, H, W), dtype=g_dtype, device=g0.device)
    dfeat = torch.empty_like(g0)
    dfix = torch.zeros_like(g0)
    tmp = torch.empty_like(g0) if prop_time > 1 else dfeat
    rc = lib.nlspn_reverse_chain(
        g0.data_ptr(), M16.data_ptr(), None if fix is None else fix.data_ptr(),
        G.data_ptr(), dfeat.data_ptr(),
        None if fix is None else dfix.data_ptr(), tmp.data_ptr(),
        int(g_dtype == torch.bfloat16), B, H, W, S, lo, prop_time,
        build.stream_handle())
    build.check(lib, CHAIN, rc)
    build.LAUNCHES[CHAIN] += prop_time
    return G, dfeat, dfix


class _CardPropagate(torch.autograd.Function):
    """The chain as the card runs it (nlspn_kernel.py:_fwd/_bwd): forward
    with X emitted, backward = reverse chain, then the shift correlation.
    The stacks are in ``_stack_dtype(M)``; dM is returned in M's dtype. On
    the CPU the same Function runs the plain versions (its plain twin)."""

    @staticmethod
    def forward(ctx, feat_init, M, feat_fix, prop_time, R, preserve_input):
        feat0 = feat_init[:, 0].float().contiguous()
        M16 = M.to(torch.bfloat16).contiguous()
        fix = feat_fix[:, 0].float().contiguous() if preserve_input else None
        out, X = propagate_x(feat0, M16, fix, prop_time, R, _stack_dtype(M))
        ctx.save_for_backward(X, M16, fix)
        ctx.prop_time, ctx.R = prop_time, R
        ctx.M_dtype = M.dtype
        ctx.fix_dtype = None if feat_fix is None else feat_fix.dtype
        return out[:, None].to(feat_init.dtype)

    @staticmethod
    def backward(ctx, g):
        X, M16, fix = ctx.saved_tensors
        lo, _ = shift_window(ctx.R)
        B, S, _, H, W = M16.shape
        G, dfeat, dfix = reverse_chain(g[:, 0].float().contiguous(), M16, fix,
                                       ctx.prop_time, ctx.R, X.dtype)
        dM = None
        if ctx.needs_input_grad[1]:
            dM = mask_kernel.shift_correlation(G, X, S, lo).reshape(
                B, S, S, H, W).to(ctx.M_dtype)
        dfix_out = None
        if fix is not None and ctx.needs_input_grad[2]:
            dfix_out = dfix[:, None].to(ctx.fix_dtype)
        return dfeat[:, None].to(g.dtype), dM, dfix_out, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def nlspn_stencil_propagate(feat_init: torch.Tensor, M: torch.Tensor,
                            feat_fix: Optional[torch.Tensor], prop_time: int,
                            R: int = 2,
                            preserve_input: bool = False) -> torch.Tensor:
    """feat_init, feat_fix: (B, 1, H, W) (feat_fix read only with
    ``preserve_input``); M: (B, S, S, H, W). Rounds M to bf16, then runs
    ``prop_time`` steps. When a gradient is wanted it is the card Function
    (kernels 4, 5 and the shift correlation on the card, their plain
    versions on the CPU); otherwise the served chain: the plain stencil for
    a CPU tensor, else the CUDA kernel (``prop_time`` launches) or raise."""
    if feat_init.device.type == "cpu":
        if _needs_grad(feat_init, M, feat_fix):
            return _CardPropagate.apply(feat_init, M, feat_fix, prop_time, R,
                                        preserve_input)
        return stencil_propagate(feat_init, M.to(torch.bfloat16), prop_time,
                                 R, feat_fix, preserve_input)
    lib = build.library(NAME)
    B, C, H, W = feat_init.shape
    if C != 1:
        raise ValueError(f"{NAME}: feat (B,1,H,W) expected, got "
                         f"{tuple(feat_init.shape)}")
    if preserve_input and (feat_fix is None
                           or feat_fix.shape != feat_init.shape):
        raise ValueError(f"{NAME}: preserve_input needs a (B,1,H,W) feat_fix")
    if prop_time < 1:
        return feat_init.clone()
    if _needs_grad(feat_init, M, feat_fix):
        return _CardPropagate.apply(feat_init, M, feat_fix, prop_time, R,
                                    preserve_input)
    feat0 = feat_init[:, 0].float().contiguous()
    fix = feat_fix[:, 0].float().contiguous() if preserve_input else None
    out = _launch_chain(lib, feat0, M.to(torch.bfloat16).contiguous(), fix,
                        None, R, prop_time)
    build.LAUNCHES[NAME] += prop_time
    return out[:, None].to(feat_init.dtype)


def propagate_auto(feat_init: torch.Tensor, M: torch.Tensor, prop_time: int,
                   R: int = 2, feat_fix: Optional[torch.Tensor] = None,
                   preserve_input: bool = False) -> torch.Tensor:
    """The card's chain (differentiable) for a CUDA tensor; on the CPU the
    plain f32 stencil with M as given, as the JAX package runs off the
    TPU."""
    if feat_init.device.type == "cpu":
        return stencil_propagate(feat_init, M, prop_time, R, feat_fix,
                                 preserve_input)
    return nlspn_stencil_propagate(feat_init, M, feat_fix, prop_time, R,
                                   preserve_input)
