"""The exchanges of width-sharded serving within a ``model`` group
(``parallel.grid``): halos of columns for the convolutions, pools and
resizes, whole widths, and sums.

Rank m of M holds columns [m w, (m + 1) w) of a width M w. ``exchange``
returns its columns [m w - left, (m + 1) w + right): the left halo from the
ranks before it, the right halo from those after it, and ``fill`` (zeros,
or -inf for a max pool) past the edge of the image, never at a shard's
edge; a negative ``right`` crops. Strips go by ``all_gather`` in the group
(every rank sends one strip of its last ``left`` and first ``right``
columns and keeps its neighbours'); a halo wider than a shard (a dilated
convolution at 1/8 of a narrow image) gathers the whole width. With M = 1
nothing is exchanged.

``STATS`` counts the bytes this rank receives, by kind, and the calls:
``halo`` (strips and the widths gathered for a halo), ``gather`` (whole
widths: the NLSPN block's inputs, assembled outputs) and ``reduce`` (the
sums of the pools, means and norms).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist
import torch.nn.functional as F

STATS: collections.Counter = collections.Counter()


def reset_stats():
    STATS.clear()


def _count(kind: str, t: torch.Tensor, peers: int):
    STATS[f"{kind}_bytes"] += peers * t.numel() * t.element_size()
    STATS[f"{kind}_calls"] += 1


def all_gather_width(x: torch.Tensor, group, M: int,
                     kind: str = "gather") -> torch.Tensor:
    """The M shards of the group side by side along the last axis."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(M)]
    dist.all_gather(parts, x, group=group)
    _count(kind, x, M - 1)
    return torch.cat(parts, dim=-1)


def all_reduce_sum(t: torch.Tensor, group, M: int) -> torch.Tensor:
    """``t`` summed over the group, in place; returns it."""
    if M > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        _count("reduce", t, M - 1)
    return t


def exchange(x: torch.Tensor, left: int, right: int, group, m: int, M: int,
             fill: float = 0.0) -> torch.Tensor:
    """Columns [m w - left, (m + 1) w + right) of a width M w of which this
    rank holds [m w, (m + 1) w) as the last axis of ``x``: ``fill`` past the
    image's edges; ``right`` < 0 crops that many of x's last columns."""
    w = x.shape[-1]
    r = max(right, 0)
    if M == 1 or (left == 0 and r == 0):
        out = F.pad(x, (left, r), value=fill) if left or r else x
    elif left <= w and r <= w:
        strip = torch.cat([x[..., w - left:], x[..., :r]], dim=-1)
        strip = strip.contiguous()
        parts = [torch.empty_like(strip) for _ in range(M)]
        dist.all_gather(parts, strip, group=group)
        _count("halo", strip, M - 1)
        lo = (parts[m - 1][..., :left] if m > 0 else
              torch.full_like(x[..., :left], fill))
        hi = (parts[m + 1][..., left:] if m < M - 1 else
              torch.full_like(x[..., :r], fill))
        out = torch.cat([lo, x, hi], dim=-1)
    else:
        whole = F.pad(all_gather_width(x, group, M, "halo"), (left, r),
                      value=fill)
        out = whole[..., m * w:m * w + left + w + r]
    return out[..., :out.shape[-1] + right] if right < 0 else out
