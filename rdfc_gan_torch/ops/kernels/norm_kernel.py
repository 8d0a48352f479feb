"""Instance norm on the card: wrappers of ``csrc/instance_norm.cu`` with
their plain PyTorch versions, and the differentiable ``instance_norm``
(port of rdfc_gan_tpu/models/layers.py:219-281, the JAX ``instance_norm``
and its output-residual ``custom_vjp``; the TPU kernels were
attic/norm_kernel.py:_in_fwd_kernel and _in_bwd_kernel).

    forward:   a = rsqrt(max(E[x^2] - E[x]^2, 0) + eps), b = -E[x] a   (f32)
               y = x * T(a) + T(b)                    in x's type T
    backward:  dx = T(a) * (dy - T(E[dy]) - y * T(E[dy y]))   in dy's type

The statistics are f32 whatever the activation type, E over each (b, c)
plane, NCHW, each summed and divided in f64 and rounded to f32 once (the
JAX package sums in f32; its order cannot be followed, and the f32 train
step amplifies a last-bit change of these statistics far beyond rounding,
PERF.md). The backward reads the forward's output y and the (B, C)
f32 scale a, not x (the JAX residuals). Each wrapper takes its plain
version for a tensor on the CPU and launches its kernel, or raises, for
any other. The forward, a kernel of the served path, is the dispatcher op
``rdfc_gan_torch::instance_norm_fwd`` (``fwd_op``), which ``torch.export``
keeps in an exported program. The JAX function's ``pack`` (a TPU lane
layout) has no counterpart here.

The plain versions sum in their kernel's order, divide as IEEE does and
take a correctly rounded rsqrt, as the kernels do, so the two agree bit for
bit. Both kernels cut a plane by one rule (``_plan``: vectors, thread block
clusters and several planes a block), the forward staging x
(``fwd_plan``, ``_fwd_sum``), the backward dy and y (``bwd_plan``,
``_bwd_sum``). ``_block_sum`` (one block a plane, ``bwd_block_threads``)
is the f32 conv-block kernels' order.

The forward split for a plane whose width is sharded over ranks
(``parallel.spatial``), two kernels of the same source with their plain
versions: ``instance_norm_moments`` (each plane's f64 sums in the forward's
order) and ``instance_norm_apply`` (from the ranks' added sums, the
forward's finalize, the (B, C) scale a and y, rounded as the forward rounds
them). ``instance_norm_fwd_sharded`` runs moments, the all-reduce of the
sums over the row and apply: no other op runs between the two launches.
Both cut a plane by ``fwd_plan`` and stage a block's chunk of x in shared
memory, with the TMA's bulk copy where the plane's vector is 16 bytes
(``bulk_copy``), else with ``cp.async``; both refuse a plane the forward
refuses (a stage past ``MAX_STAGE_BYTES``). The plain ``apply`` is
``instance_norm_finalize`` and the elementwise pass.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...parallel import spatial
from . import build

SOURCE = "instance_norm"
FWD = "instance_norm_fwd"
BWD = "instance_norm_bwd"
MOMENTS = "instance_norm_moments"
APPLY = "instance_norm_apply"
_FLOATS = (torch.float32, torch.bfloat16)


# the plan (instance_norm.cu:plan and its constants)
STAGE_BYTES = 40 * 1024
MAX_STAGE_BYTES = 200 * 1024
MAX_CLUSTER = 8
WIDE_CLUSTER = 16
BLOCK_THREADS = 256
MAX_TEAM = 512
STEPS = 8


class Plan(NamedTuple):
    """How a kernel cuts a plane: ``vec`` elements a vector, ``cluster``
    blocks a plane, ``cvec`` vectors a block's chunk, ``team`` threads a
    chunk, ``teams`` planes a block."""
    vec: int
    cluster: int
    cvec: int
    team: int
    teams: int


@functools.lru_cache(maxsize=None)
def _plan(n: int, itemsize: int, arrays: int) -> Plan:
    """The partition of a plane of n values of ``itemsize`` bytes of which a
    block stages ``arrays`` arrays (instance_norm.cu:plan): the widest
    vector of at most 16 bytes whose width divides n; a cluster of 2-8
    blocks where the staged arrays exceed ``STAGE_BYTES``, of 16 where 8
    blocks cannot stage them; about ``STEPS`` vectors a thread."""
    vec = 16 // itemsize
    while n % vec:
        vec //= 2
    cluster = 1
    while cluster < MAX_CLUSTER and n * itemsize * arrays > cluster * \
            STAGE_BYTES:
        cluster *= 2
    cvec = -(-(n // vec) // cluster)
    if arrays * cvec * vec * itemsize > MAX_STAGE_BYTES and \
            cluster == MAX_CLUSTER:
        cluster = WIDE_CLUSTER  # what 8 blocks cannot stage
        cvec = -(-(n // vec) // cluster)
    team = 32
    while team < MAX_TEAM and 2 * team * STEPS <= cvec:
        team *= 2
    teams = 1 if cluster > 1 else max(1, BLOCK_THREADS // team)
    return Plan(vec, cluster, cvec, team, teams)


def fwd_plan(n: int, itemsize: int) -> Plan:
    """The forward's plan: it stages x."""
    return _plan(n, itemsize, 1)


def bwd_plan(n: int, itemsize: int) -> Plan:
    """The backward's plan: it stages dy and y."""
    return _plan(n, itemsize, 2)


def _plan_sum(v: torch.Tensor, p: Plan) -> torch.Tensor:
    """Sum of each (B, C) plane of ``v`` in the order of plan ``p``, in
    v's type: cluster rank r takes vectors [r cvec, (r + 1) cvec); its
    thread t adds vectors t, t + team, ... into one accumulator per vector
    lane, in turn; the lanes are added in order, the warp by xor shuffles
    over 16, 8, 4, 2, 1 lanes, the team's warps in order, the ranks in
    order. Returns (B, C)."""
    B, C, H, W = v.shape
    n = H * W
    steps = -(-p.cvec // p.team)
    # zeros past the plane (or a rank's chunk) add nothing to a sum
    v = F.pad(v.reshape(B * C, n), (0, p.cluster * p.cvec * p.vec - n))
    v = v.reshape(B * C, p.cluster, p.cvec, p.vec)
    v = F.pad(v, (0, 0, 0, steps * p.team - p.cvec))
    v = v.reshape(B * C, p.cluster, steps, p.team, p.vec)
    acc = torch.zeros_like(v[:, :, 0])
    for j in range(steps):
        acc = acc + v[:, :, j]
    t = acc[..., 0]
    for lane in range(1, p.vec):
        t = t + acc[..., lane]
    t = t.reshape(B * C, p.cluster, p.team // 32, 32)
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        t = t + t[..., lanes ^ o]
    w = t[..., 0]
    team = w[..., 0]
    for k in range(1, p.team // 32):
        team = team + w[..., k]
    total = team[:, 0]
    for r in range(1, p.cluster):
        total = total + team[:, r]
    return total.reshape(B, C)


def _fwd_sum(v: torch.Tensor, itemsize: int) -> torch.Tensor:
    """Sum of each plane of ``v`` in the forward kernel's order, for
    elements of ``itemsize`` bytes."""
    return _plan_sum(v, fwd_plan(v.shape[2] * v.shape[3], itemsize))


def _bwd_sum(v: torch.Tensor, itemsize: int) -> torch.Tensor:
    """Sum of each plane of ``v`` in the backward kernel's order, for
    elements of ``itemsize`` bytes."""
    return _plan_sum(v, bwd_plan(v.shape[2] * v.shape[3], itemsize))


def bwd_block_threads(n: int) -> int:
    """Threads of the f32 conv-block kernels' block for a plane of n values
    (conv_block.cu:threads_for)."""
    return 128 if n <= 1024 else 256 if n <= 4096 else 512


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of each (B, C) plane of ``v`` in the f32 conv-block kernels'
    order and type (one block a plane): thread t adds elements t, t + T,
    ... in turn; each warp adds by xor shuffles over 16, 8, 4, 2, 1 lanes;
    the warp sums are added in order. Returns (B, C)."""
    B, C, H, W = v.shape
    n = H * W
    T = bwd_block_threads(n)
    rows = -(-n // T)
    # zeros past the plane add nothing to a thread's sum
    v = F.pad(v.reshape(B * C, n), (0, rows * T - n)).reshape(B * C, rows, T)
    acc = v[:, 0]
    for r in range(1, rows):
        acc = acc + v[:, r]
    acc = acc.reshape(B * C, T // 32, 32)
    lanes = torch.arange(32, device=v.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    total = acc[:, 0, 0]
    for w in range(1, T // 32):
        total = total + acc[:, w, 0]
    return total.reshape(B, C)


def _mean(s: torch.Tensor, n: int) -> torch.Tensor:
    """The f64 sums ``s`` / n, rounded to f32. The divisor is a tensor:
    ATen's CUDA division by a Python number multiplies by its reciprocal,
    which is not the kernels' IEEE division."""
    return (s / torch.full_like(s, n)).float()


def instance_norm_fwd_plain(x: torch.Tensor, eps: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, a): the JAX ``_instance_norm_fwd_impl`` in torch, one-pass f32
    statistics in the forward kernel's order; a is the (B, C) f32
    scale."""
    return instance_norm_apply_plain(x, instance_norm_moments_plain(x),
                                     x.shape[2] * x.shape[3], eps)


def instance_norm_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 2) f64: the sum and the sum of squares of each (b, c) plane
    of x, in the forward kernel's order (``fwd_plan``, ``_fwd_sum``)."""
    xf = x.double()
    size = x.element_size()
    return torch.stack([_fwd_sum(xf, size), _fwd_sum(xf * xf, size)], -1)


def instance_norm_finalize(sums: torch.Tensor, n: int, eps: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b), (B, C) f32 each, from the (B, C, 2) f64 sums over planes of
    n values, as the forward kernel computes them: m = sum / n and
    m2 = sum of squares / n rounded to f32, var = max(m2 - m m, 0),
    a = rsqrt(var + eps) correctly rounded, b = -m a."""
    m = _mean(sums[..., 0], n)
    var = torch.clamp_min(_mean(sums[..., 1], n) - m * m, 0.0) + eps
    a = (1.0 / torch.sqrt(var.double())).float()
    return a, -m * a


def instance_norm_apply_plain(x: torch.Tensor, sums: torch.Tensor, n: int,
                              eps: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, a): the finalize of the (B, C, 2) f64 sums over planes of n
    values (``instance_norm_finalize``), then y = x * T(a) + T(b) in x's
    type T, the product and the sum rounded apart; a (B, C) f32."""
    a, b = instance_norm_finalize(sums, n, eps)
    dt = x.dtype
    return x * a[:, :, None, None].to(dt) + b[:, :, None, None].to(dt), a


def instance_norm_bwd_plain(dy: torch.Tensor, y: torch.Tensor,
                            a: torch.Tensor) -> torch.Tensor:
    """The JAX ``_instance_norm_bwd``: f32 reductions (the product in f32),
    the combination in dy's type with the statistics rounded once; the sums
    in the backward kernel's order."""
    dt = dy.dtype
    n, size = dy.shape[2] * dy.shape[3], dy.element_size()
    m1 = _mean(_bwd_sum(dy.double(), size), n)[:, :, None, None].to(dt)
    m2 = _mean(_bwd_sum(dy.double() * y.double(), size), n)[:, :, None,
                                                             None].to(dt)
    return a[:, :, None, None].to(dt) * (dy - m1 - y * m2)


def _check(name, *tensors):
    build.require_cuda(name, *tensors)
    x = tensors[0]
    if x.dim() != 4 or x.dtype not in _FLOATS:
        raise ValueError(f"{name}: (B,C,H,W) f32 or bf16 expected, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for t in tensors[1:]:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: inputs must share one shape and type")


def _check_stage(name, p: Plan, arrays: int, H: int, W: int, itemsize: int):
    """Raise where a block's stage of ``arrays`` arrays passes
    ``MAX_STAGE_BYTES`` (instance_norm.cu:launch_planned refuses it)."""
    if arrays * p.teams * p.cvec * p.vec * itemsize > MAX_STAGE_BYTES:
        raise ValueError(f"{name}: a {H}x{W} plane exceeds a cluster of "
                         f"{WIDE_CLUSTER} staged blocks")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it does not start on 16 bytes: the
    kernels' vectors start at the tensor."""
    return t.clone() if t.data_ptr() % 16 else t


def _fwd_launch(x: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA implementation of ``fwd_op``: one launch of
    ``instance_norm_fwd``, counted."""
    lib = build.library(SOURCE)
    B, C, H, W = x.shape
    x = _aligned(x)
    y = torch.empty_like(x)
    a = torch.empty((B, C), dtype=torch.float32, device=x.device)
    rc = lib.instance_norm_fwd(x.data_ptr(), y.data_ptr(), a.data_ptr(),
                               B * C, H * W, float(eps),
                               int(x.dtype == torch.bfloat16),
                               build.stream_handle())
    build.check(lib, FWD, rc)
    build.LAUNCHES[FWD] += 1
    return y, a


def _fwd_fake(x, eps):
    return torch.empty_like(x), x.new_empty(x.shape[:2],
                                            dtype=torch.float32)


# the forward as a dispatcher op, so that ``torch.export`` keeps it as one
# node: the CUDA kernel on the card, the plain version on the CPU
fwd_op = build.define_op(
    f"{FWD}(Tensor x, float eps) -> (Tensor, Tensor)", _fwd_launch,
    instance_norm_fwd_plain, _fwd_fake)


def instance_norm_fwd(x: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, H, W) f32 or bf16. Returns (y in x.dtype, a (B, C) f32),
    through the dispatcher op ``rdfc_gan_torch::instance_norm_fwd``
    (``fwd_op``)."""
    if x.device.type != "cpu":
        build.library(SOURCE)
        _check(FWD, x)
        B, C, H, W = x.shape
        _check_stage(FWD, fwd_plan(H * W, x.element_size()), 1, H, W,
                     x.element_size())
    return fwd_op(x, float(eps))


def bulk_copy(n: int, itemsize: int) -> bool:
    """Whether the split's kernels stage a plane of n values of
    ``itemsize`` bytes with the TMA's bulk copy (instance_norm.cu:bulk_copy):
    where its vector is 16 bytes, so that every chunk starts and ends on 16
    bytes; else each thread copies its vectors with ``cp.async``."""
    return fwd_plan(n, itemsize).vec * itemsize == 16


def instance_norm_moments(x: torch.Tensor) -> torch.Tensor:
    """x: (B, C, H, W) f32 or bf16. Returns (B, C, 2) f64: the sum and the
    sum of squares of each plane, in the forward kernel's order; one
    launch of ``instance_norm_moments`` on the card."""
    if x.device.type == "cpu":
        return instance_norm_moments_plain(x)
    lib = build.library(SOURCE)
    _check(MOMENTS, x)
    B, C, H, W = x.shape
    x = _aligned(x)
    sums = x.new_empty((B, C, 2), dtype=torch.float64)
    rc = lib.instance_norm_moments(x.data_ptr(), sums.data_ptr(), B * C,
                                   H * W, int(x.dtype == torch.bfloat16),
                                   build.stream_handle())
    build.check(lib, MOMENTS, rc)
    build.LAUNCHES[MOMENTS] += 1
    return sums


def instance_norm_apply(x: torch.Tensor, sums: torch.Tensor, n: int,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, H, W) f32 or bf16; sums: (B, C, 2) f64, the moments of
    planes of n values (x's columns of them, summed over the ranks).
    Returns (y in x's type, a (B, C) f32): the forward's finalize and y =
    x * T(a) + T(b), rounded as the forward kernel rounds them; one launch
    of ``instance_norm_apply`` on the card."""
    if x.device.type == "cpu":
        return instance_norm_apply_plain(x, sums, n, eps)
    lib = build.library(SOURCE)
    _check(APPLY, x)
    B, C, H, W = x.shape
    if sums.shape != (B, C, 2) or sums.dtype != torch.float64 or \
            not sums.is_cuda or not sums.is_contiguous():
        raise ValueError(f"{APPLY}: sums must be (B, C, 2) f64 on the card, "
                         f"contiguous")
    x = _aligned(x)
    y = torch.empty_like(x)
    a = x.new_empty((B, C), dtype=torch.float32)
    rc = lib.instance_norm_apply(x.data_ptr(), sums.data_ptr(), y.data_ptr(),
                                 a.data_ptr(), B * C, H * W, int(n),
                                 float(eps), int(x.dtype == torch.bfloat16),
                                 build.stream_handle())
    build.check(lib, APPLY, rc)
    build.LAUNCHES[APPLY] += 1
    return y, a


def instance_norm_fwd_sharded(x: torch.Tensor, eps: float, group=None,
                              parts: int = 1
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The IN forward of a plane whose width is split over the ``parts``
    ranks of ``group``, x this rank's columns (``parallel.spatial``): the
    moments of its columns, their f64 sums summed over the group, then the
    forward's finalize over the global plane and y of its columns
    (``instance_norm_apply``). Returns (y, a) as ``instance_norm_fwd``; at
    ``parts`` 1 both equal its bit for bit. Serving only: raises where
    autograd would need a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("instance_norm_fwd_sharded has no backward: a "
                           "width-sharded forward serves only")
    sums = instance_norm_moments(x)
    if parts > 1:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    return instance_norm_apply(x, sums, x.shape[2] * x.shape[3] * parts, eps)


def instance_norm_bwd(dy: torch.Tensor, y: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """dy, y: (B, C, H, W), one type, f32 or bf16; a: (B, C) f32. Returns
    dx in dy.dtype."""
    if dy.device.type == "cpu":
        return instance_norm_bwd_plain(dy, y, a)
    lib = build.library(SOURCE)
    _check(BWD, dy, y)
    build.require_cuda(BWD, a)
    B, C, H, W = dy.shape
    if tuple(a.shape) != (B, C) or a.dtype != torch.float32:
        raise ValueError(f"{BWD}: a must be (B, C) f32")
    _check_stage(BWD, bwd_plan(H * W, dy.element_size()), 2, H, W,
                 dy.element_size())
    dy, y = _aligned(dy), _aligned(y)
    dx = torch.empty_like(dy)
    rc = lib.instance_norm_bwd(dy.data_ptr(), y.data_ptr(), a.data_ptr(),
                               dx.data_ptr(), B * C, H * W,
                               int(dy.dtype == torch.bfloat16),
                               build.stream_handle())
    build.check(lib, BWD, rc)
    build.LAUNCHES[BWD] += 1
    return dx


class _InstanceNorm(torch.autograd.Function):
    """The JAX ``custom_vjp`` of layers.py:239-281: the forward keeps its
    output y and the scale a; the backward is the output-residual formula."""

    @staticmethod
    def forward(ctx, x, eps):
        y, a = instance_norm_fwd(x, eps)
        ctx.save_for_backward(y, a)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, a = ctx.saved_tensors
        return instance_norm_bwd(dy.contiguous(), y, a), None


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-image, per-channel normalisation, biased variance, no affine:
    (B, C, H, W) f32 or bf16 in, the same type out, differentiable in x.
    Under a width-sharded forward (``parallel.spatial``) the statistics
    are the global plane's: ``instance_norm_fwd_sharded`` over the row."""
    grid = spatial.active()
    if grid is not None:
        with spatial.suspended():
            return instance_norm_fwd_sharded(x, eps, grid.model_group,
                                             grid.M)[0]
    return _InstanceNorm.apply(x, eps)
