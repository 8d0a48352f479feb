"""Shift-mask kernels of the NLSPN stencil: wrappers of
``csrc/shift_mask_scatter.cu``, ``csrc/shift_mask_gather.cu`` and
``csrc/shift_correlation.cu`` with their plain PyTorch versions (port of
rdfc_gan_tpu/ops/pallas/mask_kernel.py).

    scatter:      M[b, s, h, w] = sum_k w[b, k, h, w] * [sy * S + sx == s]
    gather:       dw[b, k, h, w] = dM[b, sy * S + sx, h, w]  (its transpose)
    correlation:  dM[b, iy*S+ix, h, w] = sum_t G[t,b,h,w] * X[t,b,h+lo+iy,
                                                              w+lo+ix]

``scatter_shift_masks`` is differentiable in ``w``: its backward is the
gather. Each wrapper takes its plain version for a tensor on the CPU and
launches its kernel, or raises, for any other. The scatter, a kernel of
the served path, is the dispatcher op ``rdfc_gan_torch::shift_mask_scatter``
(``scatter_op``), which ``torch.export`` keeps in an exported program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

NAME = "shift_mask_scatter"
GATHER = "shift_mask_gather"
CORR = "shift_correlation"
_FLOATS = (torch.float32, torch.bfloat16)
# the correlation kernel's cut (shift_correlation.cu): tiles of 8 x 32
# pixels, runs of 4 pixels and 2 window rows a thread, the windows it is
# built for
CORR_TILE, CORR_RUN, CORR_ROWS = (8, 32), 4, 2
CORR_WINDOWS = (4, 6, 8, 10, 12)


def scatter_shift_masks_plain(w: torch.Tensor, sy: torch.Tensor,
                              sx: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version: one ``scatter_add_`` per k, so the K contributions are
    summed in f32 in the kernel's order. An out-of-range sy/sx adds a zero
    weight at a clamped index, so it still contributes nothing."""
    B, K, H, W = w.shape
    valid = (sy >= 0) & (sy < S) & (sx >= 0) & (sx < S)
    idx = torch.where(valid, sy * S + sx, 0).to(torch.int64).reshape(
        B, K, H * W)
    wv = torch.where(valid, w.float(), 0.0).reshape(B, K, H * W)
    M = torch.zeros((B, S * S, H * W), dtype=torch.float32, device=w.device)
    for k in range(K):
        M.scatter_add_(1, idx[:, k:k + 1], wv[:, k:k + 1])
    return M.reshape(B, S * S, H, W).to(w.dtype)


def _scatter_launch(w: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                    S: int) -> torch.Tensor:
    """The CUDA implementation of ``scatter_op``: one launch of
    ``shift_mask_scatter``, counted."""
    lib = build.library(NAME)
    B, K, H, W = w.shape
    M = torch.empty((B, S * S, H, W), dtype=w.dtype, device=w.device)
    rc = lib.shift_mask_scatter(w.data_ptr(), sy.data_ptr(), sx.data_ptr(),
                                M.data_ptr(), B, K, H * W, S,
                                int(w.dtype == torch.bfloat16),
                                build.stream_handle())
    build.check(lib, NAME, rc)
    build.LAUNCHES[NAME] += 1
    return M


def _scatter_fake(w, sy, sx, S):
    B, K, H, W = w.shape
    return w.new_empty((B, S * S, H, W))


# the scatter as a dispatcher op, so that ``torch.export`` keeps it as one
# node: the CUDA kernel on the card, the plain version on the CPU
scatter_op = build.define_op(
    f"{NAME}(Tensor w, Tensor sy, Tensor sx, int S) -> Tensor",
    _scatter_launch, scatter_shift_masks_plain, _scatter_fake)


def _scatter(w: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
             S: int) -> torch.Tensor:
    if w.device.type != "cpu":
        build.library(NAME)
        build.require_cuda(NAME, w, sy, sx)
        if w.dim() != 4 or sy.shape != w.shape or sx.shape != w.shape:
            raise ValueError(f"{NAME}: w, sy, sx must share one (B,K,H,W) "
                             f"shape")
        if w.dtype not in _FLOATS:
            raise ValueError(f"{NAME}: w must be f32 or bf16, got {w.dtype}")
        if sy.dtype != torch.int32 or sx.dtype != torch.int32:
            raise ValueError(f"{NAME}: sy and sx must be int32")
        if not 1 <= S <= 12:
            raise ValueError(f"{NAME}: S={S} outside [1, 12]")
    return scatter_op(w, sy, sx, S)


class _ScatterShiftMasks(torch.autograd.Function):
    """Scatter forward, gather backward (mask_kernel.py:_scatter_fwd /
    _scatter_bwd); sy and sx are indices and get no gradient."""

    @staticmethod
    def forward(ctx, w, sy, sx, S):
        M = _scatter(w, sy, sx, S)
        ctx.save_for_backward(sy, sx)
        ctx.S, ctx.w_dtype = S, w.dtype
        return M

    @staticmethod
    def backward(ctx, dM):
        sy, sx = ctx.saved_tensors
        dw = shift_mask_gather(dM.contiguous(), sy, sx, ctx.S, ctx.w_dtype)
        return dw, None, None, None


def scatter_shift_masks(w: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                        S: int) -> torch.Tensor:
    """w: (B, K, H, W) f32 or bf16; sy, sx: (B, K, H, W) int32. Returns
    (B, S*S, H, W) in w.dtype, differentiable in w."""
    return _ScatterShiftMasks.apply(w, sy, sx, S)


def shift_mask_gather_plain(dM: torch.Tensor, sy: torch.Tensor,
                            sx: torch.Tensor, S: int,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the gather: out-of-range sy/sx give 0, as the
    Pallas kernel (the JAX fallback clips instead; callers clamp the
    offsets, so in-range indices are all they send)."""
    B, K, H, W = sy.shape
    valid = (sy >= 0) & (sy < S) & (sx >= 0) & (sx < S)
    idx = torch.where(valid, sy * S + sx, 0).to(torch.int64).reshape(
        B, K, H * W)
    dw = torch.gather(dM.reshape(B, S * S, H * W).float(), 1, idx)
    return torch.where(valid.reshape(B, K, H * W), dw, 0.0).reshape(
        B, K, H, W).to(out_dtype)


def shift_mask_gather(dM: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                      S: int, out_dtype: torch.dtype) -> torch.Tensor:
    """dM: (B, S*S, H, W) f32 or bf16; sy, sx: (B, K, H, W) int32. Returns
    dw (B, K, H, W) in ``out_dtype`` (f32 or bf16)."""
    if dM.device.type == "cpu":
        return shift_mask_gather_plain(dM, sy, sx, S, out_dtype)
    lib = build.library(GATHER)
    build.require_cuda(GATHER, dM, sy, sx)
    B, K, H, W = sy.shape
    if tuple(dM.shape) != (B, S * S, H, W) or sx.shape != sy.shape:
        raise ValueError(f"{GATHER}: dM (B,{S * S},H,W) and sy, sx (B,K,H,W) "
                         f"expected, got {tuple(dM.shape)}, "
                         f"{tuple(sy.shape)}, {tuple(sx.shape)}")
    if dM.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"{GATHER}: dM and dw must be f32 or bf16")
    if sy.dtype != torch.int32 or sx.dtype != torch.int32:
        raise ValueError(f"{GATHER}: sy and sx must be int32")
    dw = torch.empty((B, K, H, W), dtype=out_dtype, device=dM.device)
    rc = lib.shift_mask_gather(dM.data_ptr(), sy.data_ptr(), sx.data_ptr(),
                               dw.data_ptr(), B, K, H * W, S,
                               int(dM.dtype == torch.bfloat16),
                               int(out_dtype == torch.bfloat16),
                               build.stream_handle())
    build.check(lib, GATHER, rc)
    build.LAUNCHES[GATHER] += 1
    return dw


def shift_correlation_plain(G: torch.Tensor, X: torch.Tensor, S: int,
                            lo: int,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain version: for t in order, every shifted window of X[t] at once
    (``unfold``) times G[t], added to an f32 accumulator; the kernel's
    separately rounded products and sums in the kernel's order, the f32 sum
    rounded once to ``out_dtype``."""
    T, B, H, W = G.shape
    pad = max(-lo, lo + S - 1)
    off = pad + lo
    Xp = F.pad(X.float(), (pad, pad, pad, pad))
    acc = torch.zeros((B, S * S, H * W), dtype=torch.float32,
                      device=G.device)
    for t in range(T):
        win = Xp[t, :, off:off + H + S - 1, off:off + W + S - 1]
        acc = acc + G[t].float().reshape(B, 1, H * W) * F.unfold(
            win[:, None], S)
    return acc.reshape(B, S * S, H, W).to(out_dtype)


class CorrPlan(NamedTuple):
    """How the correlation kernel cuts a (B, H, W) plane: a grid of
    ``grid_w`` x ``grid_h`` x ``grid_b`` blocks of ``threads`` threads, a
    block a tile of ``tile_h`` x ``tile_w`` pixels of one image and all S^2
    shifts, a thread a run of ``run`` pixels of a row and ``rows`` window
    rows iy (thread i: run i % (tile_w / run), tile row i // (tile_w / run)
    % tile_h, window rows from i // (tile_w / run * tile_h) * rows)."""
    grid_w: int
    grid_h: int
    grid_b: int
    threads: int
    tile_h: int
    tile_w: int
    run: int
    rows: int


def corr_plan(B: int, H: int, W: int, S: int) -> CorrPlan:
    """The mirror of shift_correlation.cu's cut (its export
    ``shift_correlation_plan``). Raises ValueError for a plane or window
    the kernel does not take."""
    th, tw = CORR_TILE
    if not (1 <= B <= 65535 and H >= 1 and W >= 1
            and -(-H // th) <= 65535 and S in CORR_WINDOWS):
        raise ValueError(f"{CORR}: no plan for a {B}x{H}x{W} plane with "
                         f"S={S} (S one of {CORR_WINDOWS})")
    return CorrPlan(-(-W // tw), -(-H // th), B,
                    tw // CORR_RUN * th * (S // CORR_ROWS), th, tw, CORR_RUN,
                    CORR_ROWS)


def shift_correlation(G: torch.Tensor, X: torch.Tensor, S: int, lo: int,
                      out_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """G, X: (T, B, H, W), one type, f32 or bf16. Returns dM (B, S*S, H, W)
    in ``out_dtype``, f32 or bf16 (mask_kernel.py:shift_correlation). The
    kernel takes S = 4, 6, 8, 10 or 12 with lo = 1 - S / 2 (the windows of
    the chain kernels) and T >= 1; it raises for another."""
    if G.device.type == "cpu":
        return shift_correlation_plain(G, X, S, lo, out_dtype)
    lib = build.library(CORR)
    build.require_cuda(CORR, G, X)
    if G.dim() != 4 or X.shape != G.shape or X.dtype != G.dtype:
        raise ValueError(f"{CORR}: G and X must share one (T,B,H,W) shape "
                         f"and type")
    if G.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise ValueError(f"{CORR}: G, X and dM must be f32 or bf16")
    T, B, H, W = G.shape
    corr_plan(B, H, W, S)
    if lo != 1 - S // 2 or T < 1:
        raise ValueError(f"{CORR}: lo = 1 - S/2 and T >= 1 expected, got "
                         f"lo={lo}, T={T}")
    # the kernel copies 16 bytes at a time from G and X
    G, X = (t.clone() if t.data_ptr() % 16 else t for t in (G, X))
    dM = torch.empty((B, S * S, H, W), dtype=out_dtype, device=G.device)
    rc = lib.shift_correlation(G.data_ptr(), X.data_ptr(), dM.data_ptr(), T,
                               B, H, W, S, lo,
                               int(G.dtype == torch.bfloat16),
                               int(out_dtype == torch.bfloat16),
                               build.stream_handle())
    build.check(lib, CORR, rc)
    build.LAUNCHES[CORR] += 1
    return dM
