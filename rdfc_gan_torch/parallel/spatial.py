"""Width-sharded serving: the rules a forward follows when the image width
is sharded over the ``model`` ranks of a grid (``parallel.grid``), and how
a forward reaches them (port of rdfc_gan_tpu/parallel/mesh.py:82-89,
``spatial_sharding``, whose partitioning XLA derives; here it is written
out).

Rank m of M owns columns [m w, (m + 1) w) of every activation. Every op
that changes or reads across the width computes the output columns its rank
owns, split evenly, and takes what their receptive field needs from the
neighbours (``halo.exchange``), with zeros (-inf for max pooling) only past
the global image: padding belongs to the image, never to a shard's edge.
The input width must be a multiple of 32 M (``check_width``): 32 is the
largest total stride of the served nets (EfficientNet-B5 in G_normal), so
every layer's width divides evenly and no ``ceil`` or trim falls inside
the image. XLA pads uneven shards instead; this is a stated deviation.

How a forward reaches the rules: ``sharded(grid)`` makes the grid active
and enters a ``TorchFunctionMode`` that routes ``F.conv2d`` (every kernel,
stride, dilation, padding and group count; ``nn.Conv2d`` and the 1x1
``EqualLinear``), ``F.conv_transpose2d`` and ``F.max_pool2d`` to their
sharded rules, and refuses the width-reading ops no rule covers
(``REFUSED``). The port's own helpers read ``active()``: ``Conv2dSame``
(``conv2d`` with the global TF "same" pads), ``bilinear_resize``
(``resize_width``), the PSP pooling (``width_matrix``, ``width_sum``), the
squeeze-excite mean (``plane_mean``), ``AdaIN`` (``plane_mean_var``), the
instance norm (``ops.kernels.norm_kernel.instance_norm_fwd_sharded``), the
skips' trims (``check_trim``), the sizes the resizes aim at
(``plane_size``) and the NLSPN block (``nlspn_block``: the width gathered,
the block run whole on every rank of the row, the owned columns kept). The
same modules and parameters run sharded; with no grid active nothing
changes. Batch norm in eval mode, activations, 1x1 ops, channel concats and
softmaxes are per pixel and run as they are.

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
from .grid import Grid, gather_width, shard_width

# the largest total stride of the served nets: G_normal's EfficientNet-B5
# reaches 1/32, G_A2B 1/16 (en6), PSPNet 1/8
MAX_STRIDE = 32

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
    """Raise ValueError unless W is a multiple of 32 M."""
    if W % (MAX_STRIDE * M):
        raise ValueError(
            f"width {W} cannot be sharded over {M} model ranks: width "
            f"sharding needs W divisible by {MAX_STRIDE} x M = "
            f"{MAX_STRIDE * M} ({MAX_STRIDE} is the served nets' largest "
            f"total stride)")


@contextlib.contextmanager
def sharded(grid: Grid):
    """Run the block as rank (d, m) of ``grid``'s width sharding."""
    if torch.is_grad_enabled():
        raise RuntimeError("a width-sharded forward serves only: run it "
                           "under torch.inference_mode() or no_grad()")
    with _SpatialMode(), _set(grid if grid.M > 1 else None):
        yield


def _exchange(x, left, right, grid, fill=0.0):
    return halo.exchange(x, left, right, grid.model_group, grid.m, grid.M,
                         fill)


def plane_size(t: torch.Tensor) -> Tuple[int, int]:
    """The global (H, W) of an activation."""
    M = _ACTIVE.M if _ACTIVE is not None else 1
    return t.shape[2], t.shape[3] * M


def _even_outputs(op: str, w: int, s: int, M: int, out_w: int):
    """Raise unless the op's global output width is the input's / s, so
    that every rank owns w / s of them."""
    if w % s or out_w * s != w * M:
        raise ValueError(f"{op}: {M} x {w} input columns at stride {s} give "
                         f"{out_w} outputs, which do not split evenly")


def conv2d(x, weight, bias, stride, dilation, groups,
           pad_h: Tuple[int, int], pad_w: Tuple[int, int]):
    """``F.conv2d`` of the global image padded by ``pad_h`` (top, bottom)
    and ``pad_w`` (left, right): this rank's outputs, from its columns with
    a halo of ``left`` before them and ``(k - 1) d - left - (s - 1)`` after
    (cropped where negative)."""
    grid = _ACTIVE
    (sh, s), (dh, d) = _pair(stride), _pair(dilation)
    k = weight.shape[3]
    left, right = pad_w
    w = x.shape[3]
    span = d * (k - 1) + 1
    _even_outputs("conv2d", w, s, grid.M,
                  (w * grid.M + left + right - span) // s + 1)
    with suspended():
        ext = _exchange(x, left, span - 1 - left - (s - 1), grid)
        top, bottom = pad_h
        if top != bottom:
            ext, top = F.pad(ext, (0, 0, top, bottom)), 0
        return F.conv2d(ext, weight, bias, (sh, s), (top, 0), (dh, d),
                        groups)


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
    """A transposed conv whose global output is s times the input's width:
    output o takes inputs i with o = i s - p + j d, so the rank's s w
    outputs need floor(((k - 1) d - p) / s) columns before its own and
    floor((p - 1) / s) + 1 after (``ConvTranspose2d(3, 2, 1, 1)``: its
    right neighbour's first column)."""
    grid = _ACTIVE
    (sh, s), (ph, p) = _pair(stride), _pair(padding)
    (oph, op), (dh, d) = _pair(output_padding), _pair(dilation)
    k = weight.shape[3]
    w = x.shape[3]
    W = w * grid.M
    if (W - 1) * s - 2 * p + d * (k - 1) + op + 1 != s * W:
        raise ValueError(f"conv_transpose2d: the output of {W} columns is "
                         f"not {s} x {W}")
    left, right = (d * (k - 1) - p) // s, (p - 1) // s + 1
    if left < 0:
        raise NotImplementedError("conv_transpose2d: padding past the "
                                  "kernel's reach has no sharded rule")
    with suspended():
        ext = _exchange(x, left, right, grid)
        out = F.conv_transpose2d(ext, weight, bias, (sh, s),
                                 (ph, left * s + p), (oph, 0), groups,
                                 (dh, d))
        if out.shape[3] < s * w:
            raise ValueError("conv_transpose2d: the halo does not reach the "
                             "rank's outputs")
        return out[..., :s * w]


def _max_pool2d_rule(x, kernel_size, stride=None, padding=0, dilation=1,
                     ceil_mode=False, return_indices=False):
    """Max pooling as ``conv2d``'s halo, with -inf past the image."""
    if ceil_mode or return_indices:
        raise NotImplementedError("max_pool2d with ceil_mode or indices "
                                  "has no width-sharded rule")
    grid = _ACTIVE
    (kh, k), (ph, p), (dh, d) = (_pair(kernel_size), _pair(padding),
                                 _pair(dilation))
    sh, s = _pair(stride if stride is not None else kernel_size)
    w = x.shape[3]
    span = d * (k - 1) + 1
    _even_outputs("max_pool2d", w, s, grid.M,
                  (w * grid.M + 2 * p - span) // s + 1)
    with suspended():
        ext = _exchange(x, p, span - 1 - p - (s - 1), grid, -float("inf"))
        return F.max_pool2d(ext, (kh, k), (sh, s), (ph, 0), (dh, d))


RULES = {F.conv2d: _conv2d_rule,
         F.conv_transpose2d: _conv_transpose2d_rule,
         F.max_pool2d: _max_pool2d_rule}
# ops that read across the width and have no rule: refused under a grid
REFUSED = (F.pad, F.interpolate, F.adaptive_avg_pool2d,
           F.adaptive_max_pool2d, F.avg_pool2d, F.unfold, F.fold,
           F.grid_sample, F.instance_norm, F.layer_norm, F.group_norm,
           F.conv1d, F.conv3d)


class _SpatialMode(TorchFunctionMode):
    """Routes ``RULES`` to their sharded rules and refuses ``REFUSED``
    while a grid is active; every other op runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _ACTIVE is not None:
            rule = RULES.get(func)
            if rule is not None:
                return rule(*args, **kwargs)
            if func in REFUSED:
                raise NotImplementedError(
                    f"{getattr(func, '__name__', func)} has no width-sharded "
                    f"rule")
        return func(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def _resize_plan(mat: Callable, src: int, dst: int, M: int, m: int,
                 replicated: bool) -> Tuple[int, int, np.ndarray]:
    """(left, right, weights): the halo every rank takes (the widest any
    rank needs) and rank m's (dst / M, left + w + right) block of the
    global (dst, src) interpolation matrix ``mat(src, dst)``, zero past
    the image; a replicated input takes no halo."""
    full = mat(src, dst)
    wo = dst // M
    if replicated:
        return 0, 0, np.ascontiguousarray(full[m * wo:(m + 1) * wo])
    w = src // M
    left = right = 0
    for r in range(M):
        cols = np.nonzero(full[r * wo:(r + 1) * wo].any(axis=0))[0]
        if cols.size:
            left = max(left, r * w - int(cols[0]))
            right = max(right, int(cols[-1]) - ((r + 1) * w - 1))
    cols = np.arange(m * w - left, (m + 1) * w + right)
    inside = (cols >= 0) & (cols < src)
    block = np.zeros((wo, cols.size), np.float32)
    block[:, inside] = full[m * wo:(m + 1) * wo, cols[inside]]
    return left, right, block


def resize_width(out: torch.Tensor, mat: Callable, dst: int,
                 replicated: bool = False) -> torch.Tensor:
    """The width step of ``bilinear_resize`` to ``dst`` global columns:
    this rank's dst / M outputs from the input columns in the support of
    their rows of the global matrix ``mat(src, dst)``, fetched as a halo;
    ``replicated``: the input is the whole width on every rank (a PSP bin),
    so nothing is fetched. Summed in f32, rounded to out's type, the
    weights in its type, as ``bilinear_resize``."""
    grid = _ACTIVE
    if dst % grid.M:
        raise ValueError(f"resize to width {dst} does not split over "
                         f"{grid.M} ranks")
    src = out.shape[-1] * (1 if replicated else grid.M)
    if src == dst and not replicated:
        return out
    left, right, block = _resize_plan(mat, src, dst, grid.M, grid.m,
                                      replicated)
    with suspended():
        ext = out if replicated else _exchange(out, left, right, grid)
        wx = torch.from_numpy(block).to(out.device, out.dtype).float()
        return torch.matmul(ext.float(), wx.t()).to(out.dtype)


def width_matrix(mat: np.ndarray) -> np.ndarray:
    """This rank's columns of a (rows, W) matrix over the global width."""
    w = mat.shape[1] // _ACTIVE.M
    return np.ascontiguousarray(mat[:, _ACTIVE.m * w:(_ACTIVE.m + 1) * w])


def width_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``, a partial sum over this rank's columns, summed over the
    row's ranks (in place)."""
    grid = _ACTIVE
    with suspended():
        return halo.all_reduce_sum(t.contiguous(), grid.model_group, grid.M)


def plane_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of each (b, c) plane, (B, C, 1, 1): ``x.mean((2, 3))``, or
    under a grid the local sums summed over the row and divided by the
    global H W (the squeeze-excite mean)."""
    if _ACTIVE is None:
        return x.mean(dim=(2, 3), keepdim=True)
    n = x.shape[2] * x.shape[3] * _ACTIVE.M
    return width_sum(x.sum(dim=(2, 3), keepdim=True)) / n


def plane_mean_var(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Under a grid: the mean and the unbiased (ddof 1) variance of each
    (b, c) plane over the global plane, (B, C, 1, 1) each: the mean from
    the summed sums, then the summed squares about it."""
    n = x.shape[2] * x.shape[3] * _ACTIVE.M
    mean = width_sum(x.sum(dim=(2, 3), keepdim=True)) / n
    d = x - mean
    return mean, width_sum((d * d).sum(dim=(2, 3), keepdim=True)) / (n - 1)


def check_trim(fd: torch.Tensor, fe: torch.Tensor):
    """A decoder output trimmed to its skip's width: under a grid the
    widths divide evenly and must agree, or the trim would fall inside the
    image on every shard but the last."""
    if _ACTIVE is not None and fd.shape[3] != fe.shape[3]:
        raise ValueError(f"a trim of width {fd.shape[3]} to {fe.shape[3]} "
                         f"would fall inside a width shard")


def nlspn_block(block: Callable, *inputs: torch.Tensor):
    """The NLSPN block under a grid: its inputs' widths gathered in the row,
    the block run whole (its kernels on the whole plane on every rank of
    the row, as JAX partitions nothing inside a Pallas call), and the
    owned columns of its output kept. Returns (output shard, max
    |offset|)."""
    grid = _ACTIVE
    with suspended():
        whole = [gather_width(t, grid) for t in inputs]
        out, max_offset = block(*whole)
        return shard_width(out, grid), max_offset


def serve(forward: Callable, grid: Grid, rgb: torch.Tensor,
          raw_depth: torch.Tensor, *args, assemble: bool = False) -> dict:
    """``forward(rgb, raw_depth, *args)``, a dict of (B, C, H, W) outputs,
    as rank (d, m) of ``grid``: ``rgb`` and ``raw_depth`` are this data
    row's rows at the whole width; the rank takes its columns and returns
    its shards of the outputs, or with ``assemble`` the whole width
    gathered in the row. ``nlspn_max_offset`` is the max over the grid."""
    if grid.M == 1:
        out = forward(rgb, raw_depth, *args)
    else:
        check_width(rgb.shape[3], grid.M)
        with sharded(grid):
            out = forward(shard_width(rgb, grid), shard_width(raw_depth, grid),
                          *args)
        if assemble:
            out = {k: gather_width(v, grid) if v.dim() == 4 else v
                   for k, v in out.items()}
    if "nlspn_max_offset" in out and dist.is_initialized():
        off = out["nlspn_max_offset"].float().clone()
        dist.all_reduce(off, op=dist.ReduceOp.MAX)
        out["nlspn_max_offset"] = off
    return out
