"""The fused 3x3 conv op of the train-mode BasicBlock on the card: wrappers
of ``csrc/conv_block.cu`` with their plain PyTorch versions (the TPU kernels
were attic/conv_block_kernel.py:_fwd_kernel and _bwd_kernel). NCHW, stride
1, zero padding after the prologue; T is the input's type, f32 or bf16.

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

Every sum is f64 in a fixed order, rounded once (a product of two f32 or
bf16 values is exact in f64), so the plain versions, which add in the
kernels' order, agree with them bit for bit: each conv output over
(ci, kh, kw) in turn; each weight-gradient entry along every image row,
then the rows in turn in groups of ``ROW_GROUP``, then the groups in turn;
the moments and sums in the instance-norm kernels' block order
(``norm_kernel._block_sum``). The moments and sums stay f64 for the caller
to form the BN statistics. Each wrapper takes its plain version for a
tensor on the CPU and launches its kernels, or raises, for any other; a
wrapper call counts one launch (``conv3x3_fwd``, ``conv3x3_bwd``) however
many ``__global__`` functions it starts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .norm_kernel import _block_sum

SOURCE = "conv_block"
FWD = "conv3x3_fwd"
BWD = "conv3x3_bwd"
# image rows the weight gradient sums in turn (conv_block.cu:kRowGroup)
ROW_GROUP = 8
_FLOATS = (torch.float32, torch.bfloat16)
_MODES = {None: 0, "none": 1, "relu": 2}


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


def conv3x3_bwd_plain(g, u, w, a=None, b=None, act="none", y=None, fin=None,
                      xh=None, carry=None):
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
    sums = None
    if xh is not None:
        mu, is_ = xh
        xhat_u = (u.float() - _col(mu)) * _col(is_)
        gd = gm.double()
        sums = torch.stack([_block_sum(gd), _block_sum(gd * xhat_u.double())],
                           dim=1)
    dw = _seq_wgrad(_prologue(u, a, b, act), dy)
    return gout, dw, sums


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
    """(Co, C, 3, 3) -> (C, 9, Co) f64, the conv kernel's weight layout."""
    return w.permute(1, 2, 3, 0).reshape(w.shape[1], 9,
                                         w.shape[0]).double().contiguous()


def _rows(v: Optional[torch.Tensor], dt) -> Optional[torch.Tensor]:
    """A (C,) f32 row rounded to dt, as the kernels read it."""
    return None if v is None else v.detach().to(dt).float().contiguous()


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
    lib = build.library(SOURCE)
    _check(FWD, u)
    mode = _mode(a, act)
    dt = u.dtype
    B, C, H, W = u.shape
    Co = w.shape[0]
    if tuple(w.shape) != (Co, C, 3, 3):
        raise ValueError(f"{FWD}: w must be (Co, {C}, 3, 3)")
    wt = _layout(w.detach().to(dt))
    pa, pb = _rows(a, dt), _rows(b, dt)
    y = torch.empty((B, Co, H, W), dtype=dt, device=u.device)
    mom = torch.empty((B, 2, Co), dtype=torch.float64, device=u.device)
    rc = lib.conv3x3_fwd(u.data_ptr(), wt.data_ptr(), _ptr(pa), _ptr(pb),
                         mode, y.data_ptr(), mom.data_ptr(), B, C, Co, H, W,
                         int(dt == torch.bfloat16), build.stream_handle())
    build.check(lib, FWD, rc)
    build.LAUNCHES[FWD] += 1
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
    lib = build.library(SOURCE)
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
    wtf = _layout(_flip(w.detach().to(dt)))
    pa, pb = _rows(a, dt), _rows(b, dt)
    fin = None if fin is None else fin.detach().float().contiguous()
    dy = None if fin is None else torch.empty_like(g)
    mu = is_ = sums = None
    if xh is not None:
        mu, is_ = (v.detach().float().contiguous() for v in xh)
        sums = torch.empty((B, 2, C), dtype=torch.float64, device=dev)
    gm = torch.empty((B, C, H, W), dtype=torch.float32, device=dev)
    gout = torch.empty_like(u)
    part = torch.empty((-(-B * H // ROW_GROUP), Co * C * 9),
                       dtype=torch.float64, device=dev)
    dw = torch.empty((Co, C, 3, 3), dtype=torch.float32, device=dev)
    rc = lib.conv3x3_bwd(g.data_ptr(), _ptr(y), _ptr(fin), _ptr(dy),
                         u.data_ptr(), _ptr(pa), _ptr(pb), mode,
                         wtf.data_ptr(), gm.data_ptr(), _ptr(mu), _ptr(is_),
                         _ptr(sums), _ptr(carry), gout.data_ptr(),
                         part.data_ptr(), dw.data_ptr(), B, C, Co, H, W,
                         int(dt == torch.bfloat16), build.stream_handle())
    build.check(lib, BWD, rc)
    build.LAUNCHES[BWD] += 1
    return gout, dw, sums
