"""Data parallelism over ranks: one process a card, ``torch.distributed``,
launched by ``torchrun`` (port of rdfc_gan_tpu/parallel/mesh.py).

The JAX package builds a mesh over every device, shards each batch over its
``data`` axis and lets XLA insert the collectives, so a jitted step computes
the loss, the BatchNorm statistics and the gradient of the global batch
(mesh.py:1-10). Here every collective is explicit and each is a no-op at
world size 1, where no process group is needed:

  * ``init_distributed`` reads what ``torchrun`` sets (RANK, WORLD_SIZE,
    LOCAL_RANK), joins NCCL on the card or gloo on the CPU (a group the
    caller already made is used as it is), checks ``mesh_shape`` and picks
    this rank's device;
  * ``all_reduce_sum`` / ``all_reduce_max`` (in place), ``broadcast_from_
    rank0`` (``replicate_state``), ``all_gather_object`` (the evaluator's
    ``process_allgather``), ``barrier``;
  * ``all_reduce_grads``: the gradient of every listed parameter summed over
    the ranks, in one flat buffer a dtype (the engines call it once an
    optimizer, between the backward and the clip);
  * ``rank_rows``: this rank's block of a global-batch tensor. Ranks hold
    consecutive blocks in rank order, as ``make_array_from_process_local_
    data`` lays out the JAX global batch (rdfc_gan_tpu/data/loader.py:
    174-180).

Each rank's loss is its share of the global loss (its numerator over the
global denominator), so the summed gradient is the gradient of the global
batch. A ``model`` mesh axis (``mesh_shape`` ``{"data": D, "model": M}``,
D x M the world) shards the width of a served image over M ranks
(``parallel.grid``, ``parallel.spatial``: the JAX ``spatial_sharding``,
mesh.py:82-89); a train step runs at world D x M as data parallelism, the
global batch ``batch_size`` x D x M, as the JAX ``train.py`` computes it
there (train.py:45-53).
"""

from __future__ import annotations

import os
from typing import Any, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0, the one that writes files."""
    return rank() == 0


def mesh_axes(mesh_shape, world: int) -> Tuple[int, int]:
    """(D, M) of ``mesh_shape``: ``model`` defaults to 1 and ``data`` to
    the world over ``model``; None puts every rank on ``data``."""
    axes = dict(mesh_shape or {})
    M = int(axes.get("model", 1))
    return int(axes.get("data", world // max(M, 1))), M


def check_mesh_shape(mesh_shape, world: int):
    """``mesh_shape`` None puts every rank on ``data``; otherwise its axes
    are ``data`` and ``model`` (``parallel.grid``: rows over ``data``, the
    width of a served image over ``model``) and data x model must be the
    world size. Raises ValueError."""
    if not mesh_shape:
        return
    axes = dict(mesh_shape)
    unknown = sorted(set(axes) - {"data", "model"})
    if unknown:
        raise ValueError(f"mesh_shape {axes}: unknown axes {unknown}; the "
                         f"port's axes are 'data' and 'model'")
    D, M = mesh_axes(axes, world)
    if D < 1 or M < 1 or D * M != world:
        raise ValueError(f"mesh_shape {axes}: data x model = {D} x {M} "
                         f"must equal the world size {world}")


def init_distributed(cfg) -> Tuple[torch.device, bool]:
    """Join the ranks and pick this rank's device. Returns (device, whether
    this call made the process group, so the caller destroys it at exit).

    A group the caller already made is used as it is. Otherwise, where
    ``torchrun`` set RANK and WORLD_SIZE, NCCL is initialised for a CUDA
    device and gloo for the CPU; with neither, the run is world 1 with no
    group. ``cfg.device`` ``cuda`` means ``cuda:{LOCAL_RANK}`` (a local
    rank past the cards raises); an explicit ``cuda:N`` is taken as given
    (two ranks may share a card); ``cpu`` is the CPU."""
    name = str(cfg.get("device", "cuda"))
    made = False
    if is_initialized():
        world = world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    check_mesh_shape(cfg.get("mesh_shape"), world)
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available; pass --device cpu to run on "
                               "the CPU")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0"))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} but only "
                    f"{torch.cuda.device_count()} CUDA devices")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"device {name!r}: expected cuda, cuda:N or cpu")
    if not is_initialized() and "RANK" in os.environ \
            and "WORLD_SIZE" in os.environ:
        dist.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
        made = True
    return device, made


def destroy(made: bool):
    """Destroy the process group if ``init_distributed`` made it."""
    if made and is_initialized():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The max of ``t`` over the ranks, in place; returns it."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def _by_dtype(tensors: Iterable[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def broadcast_from_rank0(tensors: Iterable[torch.Tensor]):
    """Overwrite each tensor with rank 0's, one flat buffer a dtype
    (``replicate_state``, train.py:89)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for group in _by_dtype(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            _scatter_back(flat, group)


def _scatter_back(flat: torch.Tensor, tensors: List[torch.Tensor]):
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_grads(params: Iterable[torch.nn.Parameter]):
    """Sum the gradients of ``params`` over the ranks, one flat buffer a
    dtype, in the parameters' order. A parameter without a gradient has
    none on any rank (every rank runs the same graph) and is left so."""
    if world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        for group in _by_dtype(grads):
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            _scatter_back(flat, group)


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (through the CPU)."""
    if world_size() == 1:
        return [obj]
    out: List[Optional[Any]] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier():
    if world_size() > 1:
        dist.barrier()


def rank_rows(t: torch.Tensor, index: Optional[int] = None,
              count: Optional[int] = None) -> torch.Tensor:
    """This rank's rows of a global-batch tensor: block ``rank`` of
    ``world`` equal blocks of dim 0, or block ``index`` of ``count`` (a
    grid's data row, ``parallel.grid``)."""
    if count is None:
        index, count = rank(), world_size()
    if count == 1:
        return t
    n = t.shape[0]
    if n % count:
        raise ValueError(f"global batch {n} does not split over {count} "
                         f"ranks")
    b = n // count
    return t[index * b:(index + 1) * b]
