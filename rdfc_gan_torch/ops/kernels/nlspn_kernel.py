"""NLSPN propagation chain on the card: wrappers of
``csrc/nlspn_propagate.cu`` (the served chain, and the chain that also
stores each step's input X) and ``csrc/nlspn_reverse_chain.cu``, the
differentiable ``nlspn_stencil_propagate`` built from them, and the
dispatcher ``propagate_auto`` (port of rdfc_gan_tpu/ops/pallas/
nlspn_kernel.py). The plain versions are ``stencil_propagate``,
``propagate_x_plain`` and ``reverse_chain_plain`` of ``ops/nlspn_stencil``.
Each kernel runs a whole chain in one cooperative launch; ``chain_plan``
mirrors how both cut it (the plan of ``csrc/nlspn_chain.cuh``).

As on the TPU, the kernel path rounds the mask stack to bf16 and sums in
f32 (nlspn_kernel.py:303), so its output differs from the unrounded plain
stencil that CPU runs take by the bf16 rounding of M. Its backward treats
the rounding as the identity (straight-through, nlspn_kernel.py:404-413).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nlspn_stencil import (propagate_x_plain, reverse_chain_plain,
                             shift_window, stencil_propagate)
from . import build, mask_kernel

NAME = "nlspn_propagate"
NAME_X = "nlspn_propagate_x"
CHAIN = "nlspn_reverse_chain"
# the shift windows S the chain kernels are built for (R = 0..4)
CHAIN_WINDOWS = (4, 6, 8, 10, 12)
# the chains' plan (nlspn_chain.cuh:chain_plan and its constants): runs of
# RUN pixels, tile margins, runs and threads a block
RUN, LEFT, RIGHT, MIN_RUNS, MAX_THREADS = 8, 8, 8, 32, 384


class ChainPlan(NamedTuple):
    """How a chain kernel (forward or reverse) cuts a (B, H, W) chain:
    ``blocks`` blocks of ``threads`` threads, ``rpb`` runs of 8 pixels a
    block (block i owns runs i * rpb on), the first ``nres`` of a block's
    runs with their masks resident in shared memory, its runs taken in
    bands of ``band_rows`` rows of ``band_runs`` runs (fewer runs than a
    row has only with one row a band), ``smem`` bytes of shared memory a
    block."""
    blocks: int
    threads: int
    rpb: int
    nres: int
    band_rows: int
    band_runs: int
    smem: int


def chain_plan(B: int, H: int, W: int, S: int, sms: int,
               smem_optin: int) -> ChainPlan:
    """The chains' plan on a card of ``sms`` SMs whose blocks may have
    ``smem_optin`` bytes of shared memory (the mirror of
    nlspn_chain.cuh:chain_plan, which both chains take and export:
    ``nlspn_chain_plan`` and ``nlspn_reverse_chain_plan``). A block's tile
    holds its band's rows of the plane and S - 1 halo rows (below a row in
    the forward chains, above it in the reverse chain), each LEFT +
    band_runs * RUN + RIGHT floats; a resident run's masks take S * S
    16-byte vectors in both. Whole rows where they fit, else bands of rows,
    else one row in chunks of runs. Raises ValueError for an empty plane,
    or where not even a band of one run fits."""
    Rr = -(-W // RUN)
    runs = B * H * Rr
    if runs < 1 or sms < 1:
        raise ValueError(f"{NAME}: no plan for an empty plane or card")
    blocks = min(-(-runs // MIN_RUNS), sms)
    rpb = -(-runs // blocks)
    threads = min(-(-rpb // 32) * 32, MAX_THREADS)
    rows = min((rpb + Rr - 2) // Rr + 1, B * H)
    fit = smem_optin // ((LEFT + Rr * RUN + RIGHT) * 4)
    if fit >= rows + S - 1:
        band_rows, band_runs = rows, Rr
    elif fit >= S:
        band_rows, band_runs = fit - (S - 1), Rr
    else:
        band_rows = 1
        band_runs = (smem_optin // (S * 4) - LEFT - RIGHT) // RUN
        if band_runs < 1:
            raise ValueError(f"{NAME}: no band of the chain fits in "
                             f"{smem_optin} bytes of shared memory")
    tile = (band_rows + S - 1) * (LEFT + band_runs * RUN + RIGHT) * 4
    nres = min(rpb, (smem_optin - tile) // (S * S * 16))
    return ChainPlan(-(-runs // rpb), threads, rpb, nres, band_rows,
                     band_runs, tile + nres * S * S * 16)


def _stack_dtype(M: torch.Tensor) -> torch.dtype:
    """Type of the X and G stacks (nlspn_kernel.py:_stack_dtype): bf16 for
    a bf16 mask stack, else f32."""
    return torch.bfloat16 if M.dtype == torch.bfloat16 else torch.float32


def _check_planes(name, planes, M16, fix, R):
    lo, hi = shift_window(R)
    S = hi - lo + 1
    if S not in CHAIN_WINDOWS:
        raise ValueError(f"{name}: a shift window of {S} (R={R}) is not "
                         f"one of {CHAIN_WINDOWS}")
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
    ``prop_time`` >= 1 steps in one cooperative launch; returns the
    (B, H, W) f32 output."""
    lo, S = _check_planes(NAME, feat0, M16, fix, R)
    B, H, W = feat0.shape
    # the kernel reads the planes' rows and each run's masks as 16-byte
    # vectors: M's rows are padded with zeros to a multiple of 8 values
    if W % RUN:
        M16 = F.pad(M16, (0, -W % RUN))
    feat0, M16, fix = (t.clone() if t is not None and t.data_ptr() % 16
                       else t for t in (feat0, M16, fix))
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
    kernel (one cooperative launch for the chain) or raises."""
    if feat0.device.type == "cpu":
        return propagate_x_plain(feat0, M16, fix, prop_time, R, x_dtype)
    lib = build.library(NAME)
    if x_dtype not in (torch.float32, torch.bfloat16) or prop_time < 1:
        raise ValueError(f"{NAME_X}: x_dtype f32/bf16 and prop_time >= 1")
    X = torch.empty((prop_time,) + tuple(feat0.shape), dtype=x_dtype,
                    device=feat0.device)
    out = _launch_chain(lib, feat0, M16, fix, X, R, prop_time)
    build.LAUNCHES[NAME_X] += 1
    return out, X


def reverse_chain(g0: torch.Tensor, M16: torch.Tensor,
                  fix: Optional[torch.Tensor], prop_time: int, R: int,
                  g_dtype: torch.dtype
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse gradient chain (TPU ``_pallas_reverse_chain``). g0, fix:
    (B, H, W) f32; M16: (B, S, S, H, W) bf16, S = 4, 6, 8, 10 or 12.
    Returns (G (T, B, H, W) in ``g_dtype``, dfeat, dfix), the last two
    (B, H, W) f32 (dfix zero without preserve). A CPU tensor takes the
    plain version; any other launches the CUDA kernel (one cooperative
    launch for the chain) or raises. Where a block's rows of the gradient
    and their halo pass its shared memory it takes them in bands
    (``chain_plan``): 16x352x1216 in two bands of 40 rows on an H100."""
    if g0.device.type == "cpu":
        return reverse_chain_plain(g0, M16, fix, prop_time, R, g_dtype)
    lib = build.library(CHAIN)
    lo, S = _check_planes(CHAIN, g0, M16, fix, R)
    if g_dtype not in (torch.float32, torch.bfloat16) or prop_time < 1:
        raise ValueError(f"{CHAIN}: g_dtype f32/bf16 and prop_time >= 1")
    B, H, W = g0.shape
    # the kernel reads g0's rows and M's planes as 16-byte vectors
    g0, M16 = (t.clone() if t.data_ptr() % 16 else t for t in (g0, M16))
    G = torch.empty((prop_time, B, H, W), dtype=g_dtype, device=g0.device)
    dfeat = torch.empty_like(g0)
    dfix = torch.zeros_like(g0)
    tmp = torch.empty_like(g0) if prop_time > 1 else dfeat
    # the pre-shifted stack of the runs that stay out of shared memory:
    # S * S 16-byte vectors (8 bf16) a run of 8 pixels
    scratch = torch.empty((S * S * B * H * -(-W // 8) * 8,),
                          dtype=torch.bfloat16, device=g0.device)
    rc = lib.nlspn_reverse_chain(
        g0.data_ptr(), M16.data_ptr(), None if fix is None else fix.data_ptr(),
        G.data_ptr(), dfeat.data_ptr(),
        None if fix is None else dfix.data_ptr(), tmp.data_ptr(),
        scratch.data_ptr(), int(g_dtype == torch.bfloat16), B, H, W, S, lo,
        prop_time, build.stream_handle())
    build.check(lib, CHAIN, rc)
    build.LAUNCHES[CHAIN] += 1
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
            # the kernel writes dM in the stacks' type, which is M's where
            # M is f32 or bf16 (_stack_dtype): no cast pass then
            dM = mask_kernel.shift_correlation(G, X, S, lo, X.dtype).reshape(
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
    a CPU tensor, else the CUDA kernel (one cooperative launch) or raise.
    The kernels take the shift windows of ``CHAIN_WINDOWS`` (R = 0..4);
    another raises ValueError."""
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
    build.LAUNCHES[NAME] += 1
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
