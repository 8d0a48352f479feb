"""The fused 3x3 conv op of the train-mode BasicBlock on the card: wrappers
of ``csrc/conv3x3_bf16.cu`` (bf16) and ``csrc/conv_block.cu`` (f32) with
their plain PyTorch versions (the TPU kernels were
attic/conv_block_kernel.py:_fwd_kernel and _bwd_kernel). NCHW, stride 1,
zero padding after the prologue; T is the input's type, f32 or bf16.

    conv3x3_fwd(u, w, a, b, act) -> (y, mom)
        z = act(T(T(u * T(a)) + T(b)))      (z = u without a, b)
        y = T(conv3x3(z, T(w)))             (B, Co, H, W) in T
        mom[b] = (sum y, sum y * y) over each (b, c) plane    (B, 2, Co) f64
    conv3x3_bwd(g, u, w, a, b, act, y, fin, xh, carry) -> (gout, dW, sums)
        dy = T((A * g - C1) - ((y - MU) * IS) * C2)   fin = (A, C1, C2, MU, IS)
        gm = act'(T(T(u * T(a)) + T(b))) * convT(dy, T(w))          (f32)
        gout = T(gm + carry)                          (B, C, H, W) in T
        dW = sum over (b, h, w) of z * dy             (Co, C, 3, 3) f32
        sums[b] = (sum gm, sum gm * ((u - mu) * is)), xh = (mu, is)  f64

The plain versions take every sum in f64 in a fixed order and round once
(a product of two f32 or bf16 values is exact in f64): each conv output
over (ci, kh, kw) in turn; each weight-gradient entry along every image
row, then the rows in turn in groups of ``ROW_GROUP``, then the groups in
turn; the moments and sums in the instance-norm kernels' block order
(``norm_kernel._block_sum``). The moments and sums stay f64 for the caller
to form the BN statistics.

The wrappers dispatch on the input's type. A CUDA **f32** tensor launches
``conv_block.cu``, which sums in f64 in the plain versions' order and so
agrees with them bit for bit (the f32 step comparisons rely on it); its
launches count as ``conv3x3_fwd_f32`` / ``conv3x3_bwd_f32``. A CUDA
**bf16** tensor launches ``conv3x3_bf16.cu``, implicit GEMMs on the tensor
cores with f32 sums, as the TPU kernel ran nine bf16 MXU matmuls with f32
accumulation; its launches count as ``conv3x3_fwd`` / ``conv3x3_bwd``. Its
results differ from the plain versions only by the order of the f32 sums,
held to the tolerances below (``check_fwd_bf16``, ``check_bwd_bf16``).
Each wrapper takes its plain version for a tensor on the CPU and launches
its kernels, or raises, for any other; a wrapper call counts one launch
however many ``__global__`` functions it starts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .norm_kernel import _block_sum

SOURCE = "conv_block"          # f32: f64 sums, bit-equal to plain
SOURCE_BF16 = "conv3x3_bf16"   # bf16: tensor cores, f32 sums
FWD = "conv3x3_fwd"            # launch counts of the bf16 kernels
BWD = "conv3x3_bwd"
FWD_F32 = "conv3x3_fwd_f32"    # and of the f32 ones
BWD_F32 = "conv3x3_bwd_f32"
# image rows the weight gradient sums in turn (conv_block.cu:kRowGroup)
ROW_GROUP = 8
_FLOATS = (torch.float32, torch.bfloat16)
_MODES = {None: 0, "none": 1, "relu": 2}
# conv3x3_bf16.cu: the conv inputs go channels-last with their channels
# zero-padded to a multiple of CHUNK (and so do the packed weights); the
# convolutions take a 16 x 16 output pixel tile of 64 output channels a
# block; the weight gradient 8 x 16 pixel tiles, 64 output and 32 input
# channels a block
TILE_H, TILE_W = 16, 16
CHUNK = 64
BLOCK_N = 64
WGRAD_TILE_H, WGRAD_TILE_W = 8, 16
WGRAD_CI = 32
# blocks the weight gradient aims for: two for each of the H100's 132 SMs
WGRAD_BLOCKS = 264

# Tolerances of the bf16 kernels against the plain versions. The kernels
# sum in f32 in another order than the plain f64 sums; the products are
# exact in both.
# y and gout: where the sum does not cancel, the f32 sum lies far closer
# to the f64 sum than a bf16 ulp, so the rounding to bf16 moves only near
# a tie, by 1 ulp of the plain value. Where it cancels (an output near 0
# from terms far larger), the f32 sum's own rounding, a small multiple of
# 2^-24 of the sum over |terms|, can exceed that ulp: on top of the ulp,
# Y_SUM_RTOL times the same conv over absolute values is allowed.
Y_ULPS = 1.0
Y_SUM_RTOL = 2.0 ** -18
# mom: the f64 moments of the kernel's own stored y, summed per tile and
# then over the tiles; against _moments(y) in the block order, |diff| <=
# MOM_RTOL times the same sum over |y| (resp. y * y). f64 rounding over at
# most a few thousand adds stays below 2^-40 of it.
MOM_RTOL = 2.0 ** -40
# dW and the BN sums: f32 sums over up to a few thousand pixels a split;
# |diff| <= SUM_RTOL times the same sum taken over absolute values.
SUM_RTOL = 2.0 ** -12


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _pre_act(u, a, b):
    """T(T(u * T(a)) + T(b)), or u without an affine."""
    if a is None:
        return u
    return u * _col(a.to(u.dtype)) + _col(b.to(u.dtype))


def _prologue(u, a, b, act):
    z = _pre_act(u, a, b)
    return torch.relu(z) if act == "relu" else z


def _mode(a, act) -> int:
    if a is None:
        if act != "none":
            raise ValueError("an activation needs the prologue's affine")
        return 0
    return _MODES[act]


def _seq_conv(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f64 sums of conv3x3(z, w), zero padded, each output added over
    (ci, kh, kw) in turn: z (B, C, H, W), w (Co, C, 3, 3), both holding
    values of one type; returns (B, Co, H, W) f64."""
    B, C, H, W = z.shape
    zp = F.pad(z, (1, 1, 1, 1)).double()
    wd = w.double()
    acc = torch.zeros((B, w.shape[0], H, W), dtype=torch.float64,
                      device=z.device)
    # the product of two f32 values is exact in f64, so the fused
    # multiply-add rounds once, as the kernel's fma does
    for ci in range(C):
        for kh in range(3):
            for kw in range(3):
                acc.addcmul_(zp[:, ci:ci + 1, kh:kh + H, kw:kw + W],
                             _col(wd[:, ci, kh, kw]))
    return acc


def _moments(v: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 2, C) f64: (sum v, sum v * v) per plane in the
    kernels' block order."""
    vd = v.double()
    return torch.stack([_block_sum(vd), _block_sum(vd * vd)], dim=1)


def _seq_wgrad(z: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW[co, ci, kh, kw] = sum over (b, h, w) of z[b, ci, h+kh-1, w+kw-1]
    * dy[b, co, h, w], in the kernels' order: along each row r = b H + h
    over w, rows in turn within groups of ROW_GROUP, the groups in turn.
    Returns (Co, C, 3, 3) f32."""
    B, C, H, W = z.shape
    Co = dy.shape[1]
    R = B * H
    G = -(-R // ROW_GROUP)
    zp = F.pad(z, (1, 1, 1, 1))
    # taps[w, ci, k, r] = z at (b, ci, h + kh - 1, w + kw - 1)
    taps = torch.stack([zp[:, :, kh:kh + H, kw:kw + W]
                        for kh in range(3) for kw in range(3)], dim=2)
    taps = taps.permute(4, 1, 2, 0, 3).reshape(W, C, 9, R).double()
    dyw = dy.permute(3, 1, 0, 2).reshape(W, Co, R).double()
    out = torch.empty((Co, C, 9), dtype=torch.float64, device=z.device)
    # output channels a pass, so that one row-sum tensor stays near 256 MB
    step = max(1, (1 << 28) // (C * 9 * G * ROW_GROUP * 8))
    for c0 in range(0, Co, step):
        c1 = min(Co, c0 + step)
        rows = torch.zeros((c1 - c0, C, 9, G * ROW_GROUP),
                           dtype=torch.float64, device=z.device)
        for w in range(W):  # exact products, one rounding an add
            rows[..., :R].addcmul_(dyw[w, c0:c1, None, None, :],
                                   taps[w, None])
        rows = rows.reshape(c1 - c0, C, 9, G, ROW_GROUP)
        grp = rows[..., 0]
        for j in range(1, ROW_GROUP):
            grp = grp + rows[..., j]
        tot = grp[..., 0]
        for g in range(1, G):
            tot = tot + grp[..., g]
        out[c0:c1] = tot
    return out.float().reshape(Co, C, 3, 3)


def _flip(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) -> the transposed conv's kernel (C, Co, 3, 3):
    wf[ci, co, kh, kw] = w[co, ci, 2 - kh, 2 - kw]."""
    return w.flip(2, 3).transpose(0, 1)


def _round(acc: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """f64 -> f32 -> dt, as the kernels store."""
    return acc.float().to(dt)


def conv3x3_fwd_plain(u, w, a=None, b=None, act="none"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    _mode(a, act)
    y = _round(_seq_conv(_prologue(u, a, b, act), w.to(u.dtype)), u.dtype)
    return y, _moments(y)


def _bwd_parts(g, u, w, a=None, b=None, act="none", y=None, fin=None,
               xh=None, carry=None):
    """The plain backward's pieces: dy, gm (f32), gout, dW, sums."""
    _mode(a, act)
    dt = g.dtype
    dy = g
    if fin is not None:
        A, C1, C2, MU, IS = (_col(r) for r in fin)
        xhat = (y.float() - MU) * IS
        dy = ((A * g.float() - C1) - xhat * C2).to(dt)
    gm = _seq_conv(dy, _flip(w.to(dt))).float()
    if act == "relu":
        gm = torch.where(_pre_act(u, a, b) > 0, gm, torch.zeros_like(gm))
    gout = (gm + carry.float() if carry is not None else gm).to(dt)
    sums = xhat_u = None
    if xh is not None:
        mu, is_ = xh
        xhat_u = (u.float() - _col(mu)) * _col(is_)
        gd = gm.double()
        sums = torch.stack([_block_sum(gd), _block_sum(gd * xhat_u.double())],
                           dim=1)
    dw = _seq_wgrad(_prologue(u, a, b, act), dy)
    return dict(dy=dy, gm=gm, xhat_u=xhat_u, gout=gout, dw=dw, sums=sums)


def conv3x3_bwd_plain(g, u, w, a=None, b=None, act="none", y=None, fin=None,
                      xh=None, carry=None):
    p = _bwd_parts(g, u, w, a, b, act, y, fin, xh, carry)
    return p["gout"], p["dw"], p["sums"]


# ------------------------------------------------ the bf16 tolerances --
def ulp_error(got: torch.Tensor, want: torch.Tensor,
              allow: Optional[torch.Tensor] = None
              ) -> Tuple[float, float, float]:
    """(max of (|got - want| - allow) in bf16 ulps of ``want``, the share
    of elements that differ, max |got - want| in ulps). ``allow``: an
    absolute allowance per element (0 without it). Non-finite values
    count as infinitely far."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(w.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    d = (g - w).abs()
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    beyond = d if allow is None else (d - allow.float()).clamp_min(0.0)
    return (float((beyond / ulp).max()), float((g != w).float().mean()),
            float((d / ulp).max()))


def abs_conv(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3x3 of |z| with |w| (zero padded) in f32 without TF32: for each
    output, the sum over |terms| of its conv."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        return F.conv2d(z.float().abs(), w.float().abs(), padding=1)


def sum_error(got: torch.Tensor, want: torch.Tensor,
              abs_sum: torch.Tensor) -> float:
    """max |got - want| / abs_sum, where abs_sum is the same sum taken over
    the absolute values of its terms (0 where got equals want)."""
    d = (got.double() - want.double()).abs()
    r = d / abs_sum.double()
    r = torch.where(d == 0, torch.zeros_like(r), r)
    r = torch.where(torch.isnan(r), torch.full_like(r, float("inf")), r)
    return float(r.max())


def abs_wgrad(z: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """sum over (b, h, w) of |z| |dy| for each weight-gradient entry
    (Co, C, 3, 3), in f32 without TF32: the scale of dW's tolerance."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        return torch.nn.grad.conv2d_weight(
            z.float().abs(), (dy.shape[1], z.shape[1], 3, 3),
            dy.float().abs(), padding=1)


def within(rows) -> bool:
    """Whether every (name, error, bound, note) row is inside its bound."""
    return all(err <= bound for _, err, bound, _ in rows)


def _bf16_row(name, got, want, abs_sum):
    beyond, share, raw = ulp_error(got, want, Y_SUM_RTOL * abs_sum)
    # the allowance the elements more than 1 ulp off needed
    _, e = torch.frexp(want.float().abs().clamp_min(2.0 ** -126))
    over = ((got.float() - want.float()).abs()
            - torch.ldexp(torch.ones_like(abs_sum), e - 8)).clamp_min(0.0)
    need = float((over / abs_sum.clamp_min(1e-30)).max())
    return (name, beyond, Y_ULPS,
            f"{share * 100:.4f}% of elements differ, max {raw:g} ulp, "
            f"past 1 ulp by at most {need:.3g} of the absolute sum "
            f"(allowed {Y_SUM_RTOL:.3g})")


def check_fwd_bf16(got, u, w, a=None, b=None, act="none", want=None):
    """Rows (name, error, bound, note or None) of a bf16 ``conv3x3_fwd``
    result ``got`` = (y, mom) against the plain version on the same
    inputs (``want``, computed when None): y in bf16 ulps beyond the
    cancellation allowance, mom relative to the same sums over |y|."""
    y, mom = got
    want_y = (want or conv3x3_fwd_plain(u, w, a, b, act))[0]
    yd = y.double()
    mom_abs = torch.stack([yd.abs().sum((2, 3)), (yd * yd).sum((2, 3))],
                          dim=1)
    return [_bf16_row("y", y, want_y, abs_conv(_prologue(u, a, b, act),
                                                w.to(u.dtype))),
            ("mom", sum_error(mom, _moments(y), mom_abs), MOM_RTOL, None)]


def check_bwd_bf16(got, g, u, w, a=None, b=None, act="none", y=None,
                   fin=None, xh=None, carry=None, parts=None):
    """Rows as ``check_fwd_bf16`` of a bf16 ``conv3x3_bwd`` result ``got``
    = (gout, dW, sums): gout in bf16 ulps beyond the cancellation
    allowance, dW and the sums relative to the same sums over absolute
    values. ``parts``: the plain ``_bwd_parts`` of the same inputs
    (computed when None)."""
    gout, dw, sums = got
    p = parts or _bwd_parts(g, u, w, a, b, act, y, fin, xh, carry)
    rows = [_bf16_row("gout", gout, p["gout"],
                      abs_conv(p["dy"], _flip(w.to(u.dtype)))),
            ("dW", sum_error(dw, p["dw"], abs_wgrad(
                _prologue(u, a, b, act), p["dy"])), SUM_RTOL, None)]
    if (sums is None) != (p["sums"] is None):
        rows.append(("sums", float("inf"), SUM_RTOL, None))
    elif sums is not None:
        gd = p["gm"].double().abs()
        s_abs = torch.stack([gd.sum((2, 3)), (gd * p["xhat_u"].double().abs())
                             .sum((2, 3))], dim=1)
        rows.append(("sums", sum_error(sums, p["sums"], s_abs), SUM_RTOL,
                     None))
    return rows


# ----------------------------------------------------------- wrappers --
def _check(name, u, *same_type):
    build.require_cuda(name, u, *same_type)
    if u.dim() != 4 or u.dtype not in _FLOATS:
        raise ValueError(f"{name}: (B,C,H,W) f32 or bf16 expected, got "
                         f"{tuple(u.shape)} {u.dtype}")
    for t in same_type:
        if t.dtype != u.dtype or t.shape[0] != u.shape[0] or \
                t.shape[2:] != u.shape[2:]:
            raise ValueError(f"{name}: inputs must share one type and size")


def _layout(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) -> (C, 9, Co) f64, conv_block.cu's weight layout."""
    return w.permute(1, 2, 3, 0).reshape(w.shape[1], 9,
                                         w.shape[0]).double().contiguous()


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_bf16(w: torch.Tensor) -> torch.Tensor:
    """(Co, C, 3, 3) -> (9, Co, Cp) bf16, conv3x3_bf16.cu's K-major weight
    layout: wk[kh * 3 + kw, co, ci] = bf16(w[co, ci, kh, kw]), zero for ci
    from C up to Cp, C rounded up to ``CHUNK``."""
    Co, C = w.shape[:2]
    Cp = _ceil(C, CHUNK)
    wk = torch.empty((3, 3, Co, Cp), dtype=torch.bfloat16, device=w.device)
    wk[..., :C].copy_(w.permute(2, 3, 0, 1))  # one cast-and-permute copy
    if Cp > C:
        wk[..., C:].zero_()
    return wk.view(9, Co, Cp)


def pack_bf16_card(lib, w: torch.Tensor, flip: bool = False
                   ) -> torch.Tensor:
    """``pack_bf16(w)`` (or of ``_flip(w)``) by conv3x3_bf16.cu's pack
    kernel, in one pass from the f32 weights."""
    wf = w.detach().float().contiguous()
    Co, C = w.shape[:2]
    N, K = (C, Co) if flip else (Co, C)
    wk = torch.empty((9, N, _ceil(K, CHUNK)), dtype=torch.bfloat16,
                     device=w.device)
    rc = lib.conv3x3_bf16_pack(wf.data_ptr(), wk.data_ptr(), N, K,
                               wk.shape[2], int(flip), build.stream_handle())
    build.check(lib, "conv3x3_bf16_pack", rc)
    return wk


def tiles(H: int, W: int, th: int = TILE_H, tw: int = TILE_W) -> int:
    """Pixel tiles of th x tw of one image (the convolutions' by
    default)."""
    return -(-H // th) * -(-W // tw)


def wgrad_splits(B: int, C: int, Co: int, H: int, W: int
                 ) -> Tuple[int, int]:
    """(splits, pixel tiles a split) of the bf16 weight gradient: the
    B * tiles pixel tiles cut into equal ranges so that the blocks (output
    tiles of 64 co x 32 ci, times the splits) come near ``WGRAD_BLOCKS``;
    every split holds at least one pixel tile."""
    out = -(-Co // BLOCK_N) * -(-C // WGRAD_CI)
    pt = B * tiles(H, W, WGRAD_TILE_H, WGRAD_TILE_W)
    want = max(1, min(pt, -(-WGRAD_BLOCKS // out)))
    per = -(-pt // want)
    return -(-pt // per), per


def _rows(v: Optional[torch.Tensor], dt) -> Optional[torch.Tensor]:
    """A (C,) f32 row as the kernels read it: rounded to dt here for the
    f32 kernels; conv3x3_bf16.cu rounds it to bf16 itself."""
    if v is None:
        return None
    v = v.detach().float()
    return (v if dt == torch.bfloat16 else v.to(dt).float()).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def conv3x3_fwd(u: torch.Tensor, w: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None, act: str = "none"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, C, H, W) f32 or bf16; w: (Co, C, 3, 3); a, b: (C,) f32 or
    None. Returns (y (B, Co, H, W) in u's type, mom (B, 2, Co) f64)."""
    if u.device.type == "cpu":
        return conv3x3_fwd_plain(u, w, a, b, act)
    build.require_card(FWD)
    _check(FWD, u)
    mode = _mode(a, act)
    dt = u.dtype
    B, C, H, W = u.shape
    Co = w.shape[0]
    if tuple(w.shape) != (Co, C, 3, 3):
        raise ValueError(f"{FWD}: w must be (Co, {C}, 3, 3)")
    pa, pb = _rows(a, dt), _rows(b, dt)
    y = torch.empty((B, Co, H, W), dtype=dt, device=u.device)
    mom = torch.empty((B, 2, Co), dtype=torch.float64, device=u.device)
    if dt == torch.bfloat16:
        lib = build.library(SOURCE_BF16)
        wk = pack_bf16_card(lib, w)
        CP = wk.shape[2]
        zn = torch.empty((B, H, W, CP), dtype=dt, device=u.device)
        part = torch.empty((B * tiles(H, W), 2, Co), dtype=torch.float64,
                           device=u.device)
        rc = lib.conv3x3_bf16_fwd(
            u.data_ptr(), wk.data_ptr(), _ptr(pa), _ptr(pb), mode,
            zn.data_ptr(), y.data_ptr(), part.data_ptr(), mom.data_ptr(), B,
            C, CP, Co, H, W, build.stream_handle())
        build.check(lib, FWD, rc)
        build.LAUNCHES[FWD] += 1
        return y, mom
    lib = build.library(SOURCE)
    wt = _layout(w.detach().to(dt))
    rc = lib.conv3x3_fwd(u.data_ptr(), wt.data_ptr(), _ptr(pa), _ptr(pb),
                         mode, y.data_ptr(), mom.data_ptr(), B, C, Co, H, W,
                         build.stream_handle())
    build.check(lib, FWD_F32, rc)
    build.LAUNCHES[FWD_F32] += 1
    return y, mom


def conv3x3_bwd(g: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
                a: Optional[torch.Tensor] = None,
                b: Optional[torch.Tensor] = None, act: str = "none",
                y: Optional[torch.Tensor] = None,
                fin: Optional[torch.Tensor] = None,
                xh: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                carry: Optional[torch.Tensor] = None):
    """The backward of one ``conv3x3_fwd(u, w, a, b, act)`` op. g, y:
    (B, Co, H, W) in u's type (y and fin (5, Co) f32 together or neither);
    xh: the (C,) f32 mean and inverse std of u's batch norm, for the sums;
    carry: (B, C, H, W) in u's type. Returns (gout (B, C, H, W) in u's
    type, dW (Co, C, 3, 3) f32, sums (B, 2, C) f64 or None)."""
    if g.device.type == "cpu":
        return conv3x3_bwd_plain(g, u, w, a, b, act, y, fin, xh, carry)
    build.require_card(BWD)
    if (y is None) != (fin is None):
        raise ValueError(f"{BWD}: y and fin go together")
    _check(BWD, u, g, *(t for t in (y, carry) if t is not None))
    mode = _mode(a, act)
    dt = u.dtype
    B, C, H, W = u.shape
    Co = g.shape[1]
    if tuple(w.shape) != (Co, C, 3, 3):
        raise ValueError(f"{BWD}: w must be ({Co}, {C}, 3, 3)")
    dev = u.device
    pa, pb = _rows(a, dt), _rows(b, dt)
    fin = None if fin is None else fin.detach().float().contiguous()
    mu = is_ = sums = None
    if xh is not None:
        mu, is_ = (v.detach().float().contiguous() for v in xh)
        sums = torch.empty((B, 2, C), dtype=torch.float64, device=dev)
    gout = torch.empty_like(u)
    dw = torch.empty((Co, C, 3, 3), dtype=torch.float32, device=dev)
    if dt == torch.bfloat16:
        lib = build.library(SOURCE_BF16)
        wkf = pack_bf16_card(lib, w, flip=True)
        CP, CoP = _ceil(C, CHUNK), wkf.shape[2]
        dyn = torch.empty((B, H, W, CoP), dtype=dt, device=dev)
        zn = torch.empty((B, H, W, CP), dtype=dt, device=dev)
        splits, per = wgrad_splits(B, C, Co, H, W)
        wpart = torch.empty((splits, 9, Co, C), dtype=torch.float32,
                            device=dev)
        tpart = None if xh is None else torch.empty(
            (B * tiles(H, W), 2, C), dtype=torch.float64, device=dev)
        rc = lib.conv3x3_bf16_bwd(
            g.data_ptr(), _ptr(y), _ptr(fin), dyn.data_ptr(), u.data_ptr(),
            _ptr(pa), _ptr(pb), mode, zn.data_ptr(), wkf.data_ptr(),
            _ptr(mu), _ptr(is_), _ptr(sums), _ptr(tpart), _ptr(carry),
            gout.data_ptr(), wpart.data_ptr(), dw.data_ptr(), B, C, CP, Co,
            CoP, H, W, splits, per, build.stream_handle())
        build.check(lib, BWD, rc)
        build.LAUNCHES[BWD] += 1
        return gout, dw, sums
    lib = build.library(SOURCE)
    wtf = _layout(_flip(w.detach().to(dt)))
    dy = None if fin is None else torch.empty_like(g)
    gm = torch.empty((B, C, H, W), dtype=torch.float32, device=dev)
    part = torch.empty((-(-B * H // ROW_GROUP), Co * C * 9),
                       dtype=torch.float64, device=dev)
    rc = lib.conv3x3_bwd(g.data_ptr(), _ptr(y), _ptr(fin), _ptr(dy),
                         u.data_ptr(), _ptr(pa), _ptr(pb), mode,
                         wtf.data_ptr(), gm.data_ptr(), _ptr(mu), _ptr(is_),
                         _ptr(sums), _ptr(carry), gout.data_ptr(),
                         part.data_ptr(), dw.data_ptr(), B, C, Co, H, W,
                         build.stream_handle())
    build.check(lib, BWD_F32, rc)
    build.LAUNCHES[BWD_F32] += 1
    return gout, dw, sums
