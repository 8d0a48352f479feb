"""Width-sharded serving: the rules a forward follows when the image width
is sharded over the ``model`` ranks of a grid (``parallel.grid``), and how
a forward reaches them (port of rdfc_gan_tpu/parallel/mesh.py:82-89,
``spatial_sharding``, whose partitioning XLA derives; here it is written
out).

The input's width W must be a multiple of M (``check_width``, the
condition of ``spatial_sharding``'s ``device_put``), and the input and the
outputs are split evenly, W / M columns a rank. Inside the nets an
activation of global width W_l has XLA's layout for uneven shards: every
rank holds c_l = ceil(W_l / M) columns, rank m the global columns [m c_l,
(m + 1) c_l), and the columns at or past W_l are padding, on the last ranks
(``grid.owned``, ``grid.valid_cols``; at W = 40 over M = 4 the 1/32 level
has 2 columns on 4 ranks). W_l is not a function of c_l, so every
activation carries its own: ``valid_width(t)``, set by the serve on the
input shards and by every rule on its output, and passed on by the mode
below from an op's input to its output of the same shard width.

Every op that changes or reads across the width computes the output columns
its rank owns in its output's layout, and takes the global input columns
their receptive field needs (``halo.exchange``, a window per rank, which
may lie off the rank's own columns when the output's shards are not the
input's divided by the stride), with zeros (-inf for max pooling) before
column 0 and at or past W_l: padding belongs to the image, never to a
shard's edge, and a padded column is never read. Every sum and count over
the plane (the means, the variances, the instance norm's moments, the PSP
bins) takes only the image columns. Per-pixel ops (eval batch norm,
activations, 1x1 ops, channel concats, softmaxes) run on the padding too,
and what they leave there is never read.

How a forward reaches the rules: ``sharded(grid)`` makes the grid active
and enters a ``TorchFunctionMode`` that routes ``F.conv2d`` (every kernel,
stride, dilation, padding and group count; ``nn.Conv2d`` and the 1x1
``EqualLinear``), ``F.conv_transpose2d`` and ``F.max_pool2d`` to their
sharded rules, refuses the width-reading ops no rule covers (``REFUSED``),
and carries W_l through every other op. The port's own helpers read
``active()``: ``Conv2dSame`` (``conv2d`` with the TF "same" pads of the
global W_l), ``bilinear_resize`` (``resize_width``), the PSP pooling
(``width_matrix``, ``width_sum``), the squeeze-excite mean
(``plane_mean``), ``AdaIN`` (``plane_mean_var``), the instance norm
(``ops.kernels.norm_kernel.instance_norm_fwd_sharded``), the skips' trims
(``trim``: a decoder output whose shards are not its skip's is moved to the
skip's layout), the sizes the resizes aim at (``plane_size``) and the
NLSPN block (``nlspn_block``: the width gathered and cut to the image, the
block run whole on every rank of the row, the owned columns kept). The
same modules and parameters run sharded; with no grid active nothing
changes.

Serving only: ``sharded`` raises where autograd would record the forward.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.modules.utils import _pair
from torch.overrides import TorchFunctionMode

from . import halo
from .grid import (Grid, gather_width, owned, shard_cols, shard_width,
                   valid_cols)

# the attribute that carries an activation's global image width W_l
_WIDTH = "_rdfc_image_width"

_ACTIVE: Optional[Grid] = None


def active() -> Optional[Grid]:
    """The grid of the sharded forward running now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def _set(grid: Optional[Grid]):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, grid
    try:
        yield
    finally:
        _ACTIVE = prev


def suspended():
    """No grid inside the block: ops run unsharded (the NLSPN block on the
    gathered plane, and the rules' own local ops)."""
    return _set(None)


def check_width(W: int, M: int):
    """Raise ValueError unless M divides W, as ``spatial_sharding``'s
    ``device_put`` requires of the input."""
    if W % M:
        raise ValueError(
            f"width {W} cannot be sharded over {M} model ranks: as in "
            f"spatial_sharding's device_put, the global size of the width "
            f"should be divisible by {M}, but it is equal to {W}")


@contextlib.contextmanager
def sharded(grid: Grid):
    """Run the block as rank (d, m) of ``grid``'s width sharding."""
    if torch.is_grad_enabled():
        raise RuntimeError("a width-sharded forward serves only: run it "
                           "under torch.inference_mode() or no_grad()")
    with _SpatialMode(), _set(grid if grid.M > 1 else None):
        yield


def with_width(t: torch.Tensor, W: int) -> torch.Tensor:
    """``t``, marked as a shard of an activation of global width W."""
    setattr(t, _WIDTH, W)
    return t


def valid_width(t: torch.Tensor) -> int:
    """The global image width W_l of a sharded activation."""
    W = getattr(t, _WIDTH, None)
    if W is None:
        raise RuntimeError(f"a width-sharded op read a tensor of shape "
                           f"{tuple(t.shape)} whose image width no rule or "
                           f"op has set")
    return W


def _carry(out, args, kwargs):
    """Mark the tensors an op returned with the image width of its first
    marked input of the same shard width (a per-pixel op's output is laid
    out as its input)."""
    ins = [t for a in (*args, *kwargs.values())
           for t in (a if isinstance(a, (tuple, list)) else (a,))
           if hasattr(t, _WIDTH)]
    if not ins:
        return
    for o in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(o, torch.Tensor) and o.dim() and \
                not hasattr(o, _WIDTH):
            for t in ins:
                if t.shape[-1] == o.shape[-1]:
                    setattr(o, _WIDTH, getattr(t, _WIDTH))
                    break


def _exchange(x, windows, W, grid, fill=0.0):
    return halo.exchange(x, windows, W, grid.model_group, grid.m, grid.M,
                         fill)


def plane_size(t: torch.Tensor) -> Tuple[int, int]:
    """The global (H, W_l) of an activation."""
    if _ACTIVE is None:
        return t.shape[2], t.shape[3]
    return t.shape[2], valid_width(t)


def _strided_windows(W_out: int, M: int, s: int, left: int, span: int):
    """Each rank's input window for its outputs of a width-W_out output of
    a stride-s window of ``span`` columns, the input padded by ``left``:
    output o reads input columns [o s - left, o s - left + span)."""
    c = shard_cols(W_out, M)
    return [(r * c * s - left, (r * c + c - 1) * s - left + span)
            for r in range(M)]


def conv2d(x, weight, bias, stride, dilation, groups,
           pad_h: Tuple[int, int], pad_w: Tuple[int, int]):
    """``F.conv2d`` of the global image padded by ``pad_h`` (top, bottom)
    and ``pad_w`` (left, right): this rank's output shard, from the window
    of input columns its outputs read. A 1x1 stride-1 convolution without
    width padding is per pixel and runs on the shard as it is."""
    grid = _ACTIVE
    (sh, s), (dh, d) = _pair(stride), _pair(dilation)
    span = d * (weight.shape[3] - 1) + 1
    left, right = pad_w
    top, bottom = pad_h
    pixel = span == 1 and s == 1 and left == right == 0
    W = getattr(x, _WIDTH, None) if pixel else valid_width(x)
    with suspended():
        if top != bottom:
            x, top = F.pad(x, (0, 0, top, bottom)), 0
        if pixel:
            out = F.conv2d(x, weight, bias, (sh, 1), (top, 0), (dh, 1),
                           groups)
            return out if W is None else with_width(out, W)
        W_out = (W + left + right - span) // s + 1
        ext = _exchange(x, _strided_windows(W_out, grid.M, s, left, span),
                        W, grid)
        return with_width(F.conv2d(ext, weight, bias, (sh, s), (top, 0),
                                   (dh, d), groups), W_out)


def _conv2d_rule(x, weight, bias=None, stride=1, padding=0, dilation=1,
                 groups=1):
    if isinstance(padding, str):
        raise NotImplementedError(f"conv2d padding={padding!r} has no "
                                  f"width-sharded rule")
    ph, pw = _pair(padding)
    return conv2d(x, weight, bias, stride, dilation, groups, (ph, ph),
                  (pw, pw))


def _conv_transpose2d_rule(x, weight, bias=None, stride=1, padding=0,
                           output_padding=0, groups=1, dilation=1):
    """A transposed conv: global output o takes inputs i with o = i s - p +
    j d (j < k), W_out = (W - 1) s - 2 p + d (k - 1) + op + 1 columns. Rank
    m's outputs [o0, o0 + c) need inputs from i0 = ceil((o0 + p - d (k -
    1)) / s); the window starts there and runs far enough that the
    transposed conv of it, cropped by o0 + p - i0 s on its left, gives c
    outputs (``ConvTranspose2d(3, 2, 1, 1)``: a valid 10 gives 20, where
    the skip may hold 19; ``trim`` cuts it)."""
    grid = _ACTIVE
    (sh, s), (ph, p) = _pair(stride), _pair(padding)
    (oph, op), (dh, d) = _pair(output_padding), _pair(dilation)
    reach = d * (weight.shape[3] - 1)
    W = valid_width(x)
    W_out = (W - 1) * s - 2 * p + reach + op + 1
    c = shard_cols(W_out, grid.M)
    windows, crops = [], []
    for r in range(grid.M):
        o0 = r * c
        i0 = min(-((reach - o0 - p) // s), (o0 + p) // s)
        crop = o0 + p - i0 * s
        n = max((o0 + c - 1 + p) // s + 1 - i0,
                -(-(c - 1 - reach + 2 * crop) // s) + 1)
        windows.append((i0, i0 + n))
        crops.append(crop)
    with suspended():
        ext = _exchange(x, windows, W, grid)
        out = F.conv_transpose2d(ext, weight, bias, (sh, s),
                                 (ph, crops[grid.m]), (oph, 0), groups,
                                 (dh, d))
        return with_width(out[..., :c], W_out)


def _max_pool2d_rule(x, kernel_size, stride=None, padding=0, dilation=1,
                     ceil_mode=False, return_indices=False):
    """Max pooling as ``conv2d``'s windows, with -inf past the image."""
    if ceil_mode or return_indices:
        raise NotImplementedError("max_pool2d with ceil_mode or indices "
                                  "has no width-sharded rule")
    grid = _ACTIVE
    (kh, k), (ph, p), (dh, d) = (_pair(kernel_size), _pair(padding),
                                 _pair(dilation))
    sh, s = _pair(stride if stride is not None else kernel_size)
    span = d * (k - 1) + 1
    W = valid_width(x)
    W_out = (W + 2 * p - span) // s + 1
    with suspended():
        ext = _exchange(x, _strided_windows(W_out, grid.M, s, p, span), W,
                        grid, -float("inf"))
        return with_width(F.max_pool2d(ext, (kh, k), (sh, s), (ph, 0),
                                       (dh, d)), W_out)


RULES = {F.conv2d: _conv2d_rule,
         F.conv_transpose2d: _conv_transpose2d_rule,
         F.max_pool2d: _max_pool2d_rule}
# ops that read across the width and have no rule: refused under a grid
REFUSED = (F.pad, F.interpolate, F.adaptive_avg_pool2d,
           F.adaptive_max_pool2d, F.avg_pool2d, F.unfold, F.fold,
           F.grid_sample, F.instance_norm, F.layer_norm, F.group_norm,
           F.conv1d, F.conv3d)


class _SpatialMode(TorchFunctionMode):
    """Routes ``RULES`` to their sharded rules, refuses ``REFUSED`` and
    carries the image width through every other op while a grid is
    active."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _ACTIVE is None:
            return func(*args, **kwargs)
        rule = RULES.get(func)
        if rule is not None:
            return rule(*args, **kwargs)
        if func in REFUSED:
            raise NotImplementedError(
                f"{getattr(func, '__name__', func)} has no width-sharded "
                f"rule")
        out = func(*args, **kwargs)
        _carry(out, args, kwargs)
        return out


@functools.lru_cache(maxsize=None)
def _resize_plan(mat: Callable, src: int, dst: int, M: int, m: int,
                 replicated: bool):
    """(windows, weights): every rank's window of input columns, the
    support of its output rows of the global (dst, src) interpolation
    matrix ``mat(src, dst)``, and rank m's (c, window) block of it; the
    rows of padded outputs are zero. A replicated input has no windows and
    rank m's block spans it all."""
    full = mat(src, dst)
    c = shard_cols(dst, M)
    rows = [full[r * c:min((r + 1) * c, dst)] for r in range(M)]
    if replicated:
        block = np.zeros((c, src), np.float32)
        block[:len(rows[m])] = rows[m]
        return None, block
    windows = []
    for r in rows:
        cols = np.nonzero(r.any(axis=0))[0]
        windows.append((int(cols[0]), int(cols[-1]) + 1) if cols.size
                       else (0, 0))
    a, b = windows[m]
    block = np.zeros((c, b - a), np.float32)
    block[:len(rows[m])] = rows[m][:, a:b]
    return tuple(windows), block


def resize_width(out: torch.Tensor, mat: Callable, dst: int,
                 replicated: bool = False) -> torch.Tensor:
    """The width step of ``bilinear_resize`` to ``dst`` global columns:
    this rank's shard of them from the window of input columns in the
    support of their rows of the global matrix ``mat(src, dst)``, src the
    input's image width; ``replicated``: the input is the whole width on
    every rank (a PSP bin), so nothing is fetched. Summed in f32, rounded
    to out's type, the weights in its type, as ``bilinear_resize``."""
    grid = _ACTIVE
    src = out.shape[-1] if replicated else valid_width(out)
    if src == dst and not replicated:
        return out
    windows, block = _resize_plan(mat, src, dst, grid.M, grid.m,
                                  replicated)
    with suspended():
        ext = out if replicated else _exchange(out, windows, src, grid)
        wx = torch.from_numpy(block).to(out.device, out.dtype).float()
        return with_width(torch.matmul(ext.float(), wx.t()).to(out.dtype),
                          dst)


def _image(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """This rank's image columns of a sharded activation, and the first of
    them as a global column."""
    grid = _ACTIVE
    v = valid_cols(valid_width(x), grid.M, grid.m)
    return x[..., :v], grid.m * x.shape[-1]


def width_matrix(mat: np.ndarray, x: torch.Tensor):
    """This rank's image columns of x and their columns of a (rows, W_l)
    matrix over the global image width."""
    xi, lo = _image(x)
    return xi, np.ascontiguousarray(mat[:, lo:lo + xi.shape[-1]])


def width_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a partial sum over this rank's columns, summed over the
    row's ranks (in place)."""
    grid = _ACTIVE
    with suspended():
        return halo.all_reduce_sum(t.contiguous(), grid.model_group, grid.M)


def plane_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of each (b, c) plane, (B, C, 1, 1): ``x.mean((2, 3))``, or
    under a grid the sums of the image columns summed over the row and
    divided by the global H W_l (the squeeze-excite mean)."""
    if _ACTIVE is None:
        return x.mean(dim=(2, 3), keepdim=True)
    xi, _ = _image(x)
    n = x.shape[2] * valid_width(x)
    return width_sum(xi.sum(dim=(2, 3), keepdim=True)) / n


def plane_mean_var(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Under a grid: the mean and the unbiased (ddof 1) variance of each
    (b, c) plane over the global plane, (B, C, 1, 1) each: the mean from
    the summed sums, then the summed squares about it, of the image
    columns."""
    xi, _ = _image(x)
    n = x.shape[2] * valid_width(x)
    mean = width_sum(xi.sum(dim=(2, 3), keepdim=True)) / n
    d = xi - mean
    return mean, width_sum((d * d).sum(dim=(2, 3), keepdim=True)) / (n - 1)


def trim(fd: torch.Tensor, fe: torch.Tensor) -> torch.Tensor:
    """A decoder output cut to its skip's size (the transposed conv's
    overhang: 20 columns where the skip has 19). Under a grid, in the
    skip's layout: where the two hold as many columns a rank (at every even
    M) the overhang is a padded column already; else (5 doubled to 10 over
    M = 3 is 4 columns a rank, where its skip of 9 holds 3) the skip's
    columns are fetched from the decoder's shards."""
    fd = fd[:, :, :fe.shape[2]]
    if _ACTIVE is None:
        return fd[..., :fe.shape[3]]
    grid = _ACTIVE
    W = valid_width(fe)
    if fd.shape[3] != fe.shape[3]:
        with suspended():
            fd = _exchange(fd, [owned(W, grid.M, r) for r in range(grid.M)],
                           W, grid)
    return with_width(fd, W)


def nlspn_block(block: Callable, *inputs: torch.Tensor):
    """The NLSPN block under a grid, on planes at the input's width (which
    M divides, so no shard holds padding): its inputs' widths gathered in
    the row, the block run whole (its kernels on the whole plane on every
    rank of the row, as JAX partitions nothing inside a Pallas call), and
    the owned columns of its output kept. Returns (output shard, max
    |offset|)."""
    grid = _ACTIVE
    W = valid_width(inputs[0])
    with suspended():
        whole = [gather_width(t, grid) for t in inputs]
        if whole[0].shape[-1] != W:
            raise ValueError(f"the NLSPN block's planes are {W} wide, "
                             f"which {grid.M} ranks do not split evenly")
        out, max_offset = block(*whole)
        return with_width(shard_width(out, grid), W), max_offset


def serve(forward: Callable, grid: Grid, rgb: torch.Tensor,
          raw_depth: torch.Tensor, *args, assemble: bool = False) -> dict:
    """``forward(rgb, raw_depth, *args)``, a dict of (B, C, H, W) outputs,
    as rank (d, m) of ``grid``: ``rgb`` and ``raw_depth`` are this data
    row's rows at the whole width W, which M must divide; the rank takes
    its W / M columns and returns its shards of the outputs, or with
    ``assemble`` the whole width gathered in the row. ``nlspn_max_offset``
    is the max over the grid."""
    if grid.M == 1:
        out = forward(rgb, raw_depth, *args)
    else:
        W = rgb.shape[3]
        check_width(W, grid.M)
        with sharded(grid):
            out = forward(with_width(shard_width(rgb, grid), W),
                          with_width(shard_width(raw_depth, grid), W), *args)
        if assemble:
            out = {k: gather_width(v, grid) if v.dim() == 4 else v
                   for k, v in out.items()}
    if "nlspn_max_offset" in out and dist.is_initialized():
        off = out["nlspn_max_offset"].float().clone()
        dist.all_reduce(off, op=dist.ReduceOp.MAX)
        out["nlspn_max_offset"] = off
    return out
