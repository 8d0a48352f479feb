"""The exchanges of width-sharded serving within a ``model`` group
(``parallel.grid``): windows of columns for the convolutions, pools,
resizes and trims, whole widths, and sums.

An activation of global width W is laid out in shards of c columns (rank m
holds [m c, (m + 1) c); the columns at or past W are padding).
``exchange`` gives each rank r the global columns [a_r, b_r) of its window
``windows[r]``, with ``fill`` (zeros, or -inf for a max pool) at every
column before 0 or at or past W: padding belongs to the image, never to a
shard's edge, and a padded column's contents are never read. A window may
be any range: a halo around the rank's own columns, or, where an op's
output shards are not its input's divided by the stride, a range shifted
off them, reaching past the neighbour at small deep shards. Each rank
sends one strip: the runs of its image columns that the other ranks'
windows take (a halo's first and last columns), side by side, padded to
the longest such strip of the group so that ``all_gather`` moves strips of
one size; every rank computes every rank's window, so all agree on the
strips without asking. Where no window reaches another rank's columns
nothing is exchanged.

``STATS`` counts the bytes this rank receives, by kind, and the calls:
``halo`` (the strips of the windows), ``gather`` (whole widths: the NLSPN
block's inputs, assembled outputs) and ``reduce`` (the sums of the pools,
means and norms).
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.distributed as dist

STATS: collections.Counter = collections.Counter()


def reset_stats():
    STATS.clear()


def _count(kind: str, t: torch.Tensor, peers: int):
    STATS[f"{kind}_bytes"] += peers * t.numel() * t.element_size()
    STATS[f"{kind}_calls"] += 1


def all_gather_width(x: torch.Tensor, group, M: int) -> torch.Tensor:
    """The M shards of the group side by side along the last axis."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(M)]
    dist.all_gather(parts, x, group=group)
    _count("gather", x, M - 1)
    return torch.cat(parts, dim=-1)


def all_reduce_sum(t: torch.Tensor, group, M: int) -> torch.Tensor:
    """``t`` summed over the group, in place; returns it."""
    if M > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        _count("reduce", t, M - 1)
    return t


@functools.lru_cache(maxsize=None)
def _strips(windows, c: int, W: int, M: int):
    """(segments, L): for each rank, the runs of its image columns that the
    other ranks' windows take, merged, as (first, end, offset in its
    strip) in its own columns; L, the longest strip (0: nothing moves)."""
    segments, L = [], 0
    for q in range(M):
        lo, hi = q * c, min((q + 1) * c, W)
        took = sorted((max(a, lo) - q * c, min(b, hi) - q * c)
                      for r, (a, b) in enumerate(windows)
                      if r != q and max(a, lo) < min(b, hi))
        runs = []
        for a, b in took:
            if runs and a <= runs[-1][1]:
                runs[-1][1] = max(runs[-1][1], b)
            else:
                runs.append([a, b])
        off, segs = 0, []
        for a, b in runs:
            segs.append((a, b, off))
            off += b - a
        segments.append(tuple(segs))
        L = max(L, off)
    return tuple(segments), L


def exchange(x: torch.Tensor, windows, W: int, group, m: int, M: int,
             fill: float = 0.0) -> torch.Tensor:
    """Global columns [a, b) = ``windows[m]`` of a width W laid out in
    shards of ``c = x.shape[-1]`` columns, of which this rank holds [m c,
    (m + 1) c): ``fill`` before column 0 and at or past W. ``windows``
    holds every rank's window, the same on every rank of the group."""
    c = x.shape[-1]
    a, b = windows[m]
    segments, L = _strips(tuple(windows), c, W, M)
    parts = None
    if L:
        pieces = [x[..., lo:hi] for lo, hi, _ in segments[m]]
        n = sum(hi - lo for lo, hi, _ in segments[m])
        if n < L:
            pieces.append(x.new_zeros((*x.shape[:-1], L - n)))
        strip = torch.cat(pieces, dim=-1).contiguous()
        parts = [torch.empty_like(strip) for _ in range(M)]
        dist.all_gather(parts, strip, group=group)
        _count("halo", strip, M - 1)

    def filled(n):
        return torch.full((*x.shape[:-1], n), fill, dtype=x.dtype,
                          device=x.device)

    def received(q, j, e):
        """Global columns [j, e) of rank q, from its strip."""
        for lo, hi, off in segments[q]:
            if lo <= j - q * c < hi:
                k = off + j - q * c - lo
                return parts[q][..., k:k + e - j]
        raise AssertionError("a window reached columns its owner did not "
                             "send")

    pieces = [filled(min(b, 0) - a)] if a < 0 else []
    j, hi = max(a, 0), min(b, W)
    while j < hi:
        q = j // c
        e = min(hi, (q + 1) * c)
        pieces.append(x[..., j - q * c:e - q * c] if q == m else
                      received(q, j, e))
        j = e
    if b > max(a, W):
        pieces.append(filled(b - max(a, W)))
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat(pieces, dim=-1) if pieces else x[..., :0]
