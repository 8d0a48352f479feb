"""Parity of the port's instance norm with the JAX package, on the CPU.

The plain forward and the ``autograd.Function``'s gradient against
``rdfc_gan_tpu.models.layers.instance_norm`` and ``jax.grad`` (through the
JAX custom VJP and through its autodiff), at planes that include the
served 14x19, an odd 17x23 and one that the forward kernel splits over a
thread block cluster, eps 1e-5 and 1e-3, f32 and bf16; the plain versions
against the retired TPU kernels (attic/norm_kernel.py) in Pallas interpret
mode, also at planes that the port's kernels split over a thread block
cluster.
Inputs come from numpy seeds. The kernel-vs-plain checks at the end need a
CUDA card and skip here; they import nothing of the JAX package, so they
also run where flax is missing. The plain versions sum in their kernel's
order (the forward by ``fwd_plan``, the backward by ``bwd_plan``), so
those checks are exact.

Tolerances. f32: rtol 1e-3 / atol 1e-4, the port's default; the sums run
in another order than XLA's. bf16: the f32 statistics, summed in another
order, can round a and b to neighbouring bf16 values, one ulp (2^-8) of
the scale apart, so bf16 results are held at 2^-6 of the output's largest
magnitude (two ulps with headroom), and most elements are equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.ops.kernels import norm_kernel as nk

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
SHAPES = [(2, 5, 14, 19), (1, 3, 8, 12)]
# the forward also at an odd plane and at one past a block's stage in f32
# (fwd_plan: a cluster of two blocks)
FWD_SHAPES = SHAPES + [(2, 3, 17, 23), (1, 2, 100, 123)]
BF16_TOL = 2.0 ** -6


def _x(shape, seed, scale=3.0, shift=1.5):
    r = np.random.RandomState(seed)
    return (r.normal(size=shape) * scale + shift).astype(np.float32)


def _nhwc(a, dt=F32):
    return jnp.asarray(a.transpose(0, 2, 3, 1), JDT[dt])


def _nchw(a):
    return np.asarray(jnp.asarray(a, jnp.float32)).transpose(0, 3, 1, 2)


def _close(got, want, dt):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dt == BF16:
        tol = BF16_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape", FWD_SHAPES)
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_forward_matches_jax(shape, eps, dt):
    from rdfc_gan_tpu.models import layers as jl

    x = _x(shape, 0)
    got = nk.instance_norm(torch.from_numpy(x).to(dt), eps)
    want = jl.instance_norm(_nhwc(x, dt), eps)
    assert got.dtype == dt and want.dtype == JDT[dt]
    _close(got.float().numpy(), _nchw(want), dt)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_gradient_matches_jax(shape, eps):
    """d/dx sum(w * IN(x)) against jax.grad through the JAX custom VJP
    (the output-residual backward) and through plain autodiff."""
    from rdfc_gan_tpu.models import layers as jl

    x, w = _x(shape, 1), _x(shape, 2, scale=1.0, shift=0.0)
    xt = torch.from_numpy(x).requires_grad_(True)
    (nk.instance_norm(xt, eps) * torch.from_numpy(w)).sum().backward()
    wj = _nhwc(w)
    for fn in (lambda v: jl._instance_norm(v, eps, 1),
               lambda v: jl.instance_norm(v, eps)):
        gj = jax.grad(lambda v: jnp.sum(fn(v) * wj))(_nhwc(x))
        _close(xt.grad.numpy(), _nchw(gj), F32)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_function_backward_is_output_residual(monkeypatch, dt):
    """The Function saves its output y and the f32 scale a and hands them to
    the backward: dx = a (dy - E[dy] - y E[dy y]), in dy's type; in f32 this
    is the gradient autograd takes through the plain forward."""
    x = torch.from_numpy(_x((2, 4, 14, 19), 3)).to(dt).requires_grad_(True)
    dy = torch.from_numpy(_x((2, 4, 14, 19), 4, 1.0, 0.0)).to(dt)
    seen = {}
    real = nk.instance_norm_bwd

    def spy(g, y, a):
        seen.update(y=y, a=a)
        return real(g, y, a)

    monkeypatch.setattr(nk, "instance_norm_bwd", spy)
    y = nk.instance_norm(x, 1e-5)
    y.backward(dy)
    assert x.grad.dtype == dt and seen["a"].dtype == F32
    torch.testing.assert_close(seen["y"], y.detach(), rtol=0, atol=0)
    want_y, want_a = nk.instance_norm_fwd_plain(x.detach(), 1e-5)
    torch.testing.assert_close(seen["a"], want_a, rtol=0, atol=0)
    torch.testing.assert_close(
        x.grad, nk.instance_norm_bwd_plain(dy, want_y, want_a), rtol=0,
        atol=0)
    if dt == F32:
        xr = x.detach().clone().requires_grad_(True)
        nk.instance_norm_fwd_plain(xr, 1e-5)[0].backward(dy)
        torch.testing.assert_close(x.grad, xr.grad, rtol=1e-4, atol=1e-5)


def test_bf16_follows_the_jax_rounding():
    """Queue 3 fault: ``F.instance_norm`` of a bf16 input (the port's IN
    before the kernels, reached under the train step's bf16 autocast)
    rounds the normalised value once, where the JAX package rounds a and b
    to bf16 and then the product and the sum; about half the elements came
    out one or more bf16 ulps apart. The port now rounds as JAX does: only
    the reduction order differs, which moves a few elements in a
    thousand."""
    from rdfc_gan_tpu.models import layers as jl

    x = _x((4, 64, 28, 38), 7)
    got = nk.instance_norm(torch.from_numpy(x).to(BF16)).float().numpy()
    want = _nchw(jl.instance_norm(_nhwc(x, BF16)))
    assert float(np.mean(got != want)) < 0.01


@pytest.fixture
def pallas_interpret():
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("dt", [F32, BF16])
def test_plain_matches_retired_tpu_kernels(pallas_interpret, dt):
    """The port's plain forward and backward against the TPU kernels they
    replace, run in interpret mode (pack 1)."""
    from attic import norm_kernel as ak

    shape = (2, 8, 14, 19)
    x, dy = _x(shape, 5), _x(shape, 6, 1.0, 0.0)
    xt = torch.from_numpy(x).to(dt)
    y, a = nk.instance_norm_fwd_plain(xt, 1e-5)
    yj, aj = ak.instance_norm_fwd_pallas(_nhwc(x, dt), 1e-5, 1)
    _close(y.float().numpy(), _nchw(yj), dt)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=1e-5)
    dyt = torch.from_numpy(dy).to(dt)
    dx = nk.instance_norm_bwd_plain(dyt, y, a)
    dxj = ak.instance_norm_bwd_pallas(_nhwc(dy, dt), _nhwc(
        y.float().numpy(), dt), jnp.asarray(a.numpy()), 1)
    _close(dx.float().numpy(), _nchw(dxj), dt)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_plain_forward_matches_retired_tpu_kernel_past_a_block(
        pallas_interpret, dt):
    """The plain forward against the TPU forward kernel at a plane that the
    port's forward kernel splits over a cluster of two blocks in f32 (the
    retired backward's plan takes no plane this large)."""
    from attic import norm_kernel as ak

    shape = (1, 2, 100, 123)
    assert nk.fwd_plan(100 * 123, 4).cluster == 2
    x = _x(shape, 8)
    y, a = nk.instance_norm_fwd_plain(torch.from_numpy(x).to(dt), 1e-5)
    yj, aj = ak.instance_norm_fwd_pallas(_nhwc(x, dt), 1e-5, 1)
    _close(y.float().numpy(), _nchw(yj), dt)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=1e-5)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_plain_backward_matches_retired_tpu_kernel_past_a_block(
        pallas_interpret, monkeypatch, dt):
    """The plain backward against the TPU backward kernel at a full-width
    G_B2A plane, which the port's backward kernel splits over a cluster of
    eight blocks. The retired kernel plans against a TPU VMEM budget (a
    lane-padded 224x304 plane does not fit the default); interpret mode
    has no VMEM, so the test raises the budget through the kernel's own
    knob."""
    from attic import norm_kernel as ak

    monkeypatch.setenv("RDFC_PALLAS_IN_VMEM_MB", "256")
    shape = (1, 2, 224, 304)
    assert nk.bwd_plan(224 * 304, torch.finfo(dt).bits // 8).cluster == 8
    x, dy = _x(shape, 9), _x(shape, 10, 1.0, 0.0)
    y, a = nk.instance_norm_fwd_plain(torch.from_numpy(x).to(dt), 1e-5)
    dyt = torch.from_numpy(dy).to(dt)
    dx = nk.instance_norm_bwd_plain(dyt, y, a)
    dxj = ak.instance_norm_bwd_pallas(_nhwc(dy, dt), _nhwc(
        y.float().numpy(), dt), jnp.asarray(a.numpy()), 1)
    _close(dx.float().numpy(), _nchw(dxj), dt)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _warp_tree(part):
    """The xor-shuffle sum of 32 values, as every lane ends it."""
    lane = np.array(part)
    for o in (16, 8, 4, 2, 1):
        lane = lane + lane[np.arange(32) ^ o]
    return lane[0]


def test_plain_sums_in_the_kernel_order():
    """``_block_sum``, the f32 conv-block kernels' reduction (strided f64
    thread sums, xor-shuffle warp trees, warp sums in order; the IN
    backward's until it took ``bwd_plan``), follows that order at every
    block size, and agrees with an exact sum to f64 rounding."""
    for n, threads in ((15, 128), (266, 128), (1064, 256), (4096, 256),
                       (4256, 512), (17024, 512)):
        assert nk.bwd_block_threads(n) == threads
        v = torch.from_numpy(_x((2, 3, 1, n), n, 1.0, 0.5)).double()
        got = nk._block_sum(v)
        # the same order written out for plane (0, 0), in Python floats
        part = [0.0] * threads
        for i, val in enumerate(v[0, 0, 0].tolist()):
            part[i % threads] += val
        want = 0.0
        for w in range(threads // 32):
            want += _warp_tree(part[32 * w:32 * w + 32])
        assert float(got[0, 0]) == want
        np.testing.assert_allclose(got.numpy(), v.sum((2, 3)).numpy(),
                                   rtol=1e-12)


# (n, itemsize) -> the forward's plan: G_B2A's bf16 planes (a cluster of
# four, one plane a block; several planes a block), its f32 64-channel
# plane (a cluster of eight), the W-AdaIN 14x19 (8- and 4-byte vectors),
# odd planes (scalars; one past a block's stage, with a short last rank)
FWD_PLANS = [
    ((68096, 2), (8, 4, 2128, 256, 1)), ((17024, 2), (8, 1, 2128, 256, 1)),
    ((4256, 2), (8, 1, 532, 64, 4)), ((68096, 4), (4, 8, 2128, 256, 1)),
    ((17024, 4), (4, 2, 2128, 256, 1)), ((4256, 4), (4, 1, 1064, 128, 2)),
    ((1064, 4), (4, 1, 266, 32, 8)), ((266, 4), (2, 1, 133, 32, 8)),
    ((266, 2), (2, 1, 133, 32, 8)), ((391, 2), (1, 1, 391, 32, 8)),
    ((12001, 4), (1, 2, 6001, 512, 1)), ((12004, 4), (4, 2, 1501, 128, 1)),
]


def _sum_in_plan_order(vals, p):
    """The sum of ``vals`` in the order of plan ``p``, in Python floats:
    cluster ranks over contiguous chunks; in a chunk, thread t adds
    vectors t, t + team, ... with one accumulator a lane; lanes, then the
    warp's xor tree, then the team's warps, then the ranks, each in
    order."""
    n = len(vals)
    want = 0.0
    for r in range(p.cluster):
        part = []
        for t in range(p.team):
            lanes = [0.0] * p.vec
            for j in range(t, p.cvec, p.team):
                g = r * p.cvec + j
                if g * p.vec >= n:
                    break
                for lane in range(p.vec):
                    lanes[lane] += vals[g * p.vec + lane]
            s = lanes[0]
            for lane in lanes[1:]:
                s += lane
            part.append(s)
        rank = _warp_tree(part[:32])
        for w in range(1, p.team // 32):
            rank += _warp_tree(part[32 * w:32 * w + 32])
        want = rank if r == 0 else want + rank
    return want


@pytest.mark.parametrize("n_size,plan", FWD_PLANS,
                         ids=[f"{n}x{s}B" for (n, s), _ in FWD_PLANS])
def test_plain_fwd_sums_in_the_kernel_order(n_size, plan):
    """The forward's plain statistics follow its kernel's partition
    (``fwd_plan``: cluster ranks over contiguous chunks; in a chunk,
    thread t adds vectors t, t + team, ... with one accumulator a lane;
    lanes, then the warp's xor tree, then the team's warps, then the ranks,
    each in order), written out here in Python floats, and agree with an
    exact sum to f64 rounding."""
    n, size = n_size
    p = nk.fwd_plan(n, size)
    assert tuple(p) == plan
    v = torch.from_numpy(_x((2, 3, 1, n), n, 1.0, 0.5)).double()
    got = nk._fwd_sum(v, size)
    assert float(got[0, 0]) == _sum_in_plan_order(v[0, 0, 0].tolist(), p)
    np.testing.assert_allclose(got.numpy(), v.sum((2, 3)).numpy(),
                               rtol=1e-12)


# (n, itemsize) -> the backward's plan (it stages dy and y): G_B2A's bf16
# planes (a cluster of eight, of two; four planes a block), its f32
# 64-channel plane (a cluster of eight), the W-AdaIN 14x19 (8 planes a
# block, 4-byte bf16 vectors), odd planes (scalars: one block of 512
# threads a plane; a cluster of four with a short last rank; a warp a
# plane), a 480x640 f32 plane (past what eight blocks stage: sixteen)
BWD_PLANS = [
    ((68096, 2), (8, 8, 1064, 128, 1)), ((17024, 2), (8, 2, 1064, 128, 1)),
    ((4256, 2), (8, 1, 532, 64, 4)), ((68096, 4), (4, 8, 2128, 256, 1)),
    ((266, 2), (2, 1, 133, 32, 8)), ((4097, 2), (1, 1, 4097, 512, 1)),
    ((12001, 4), (1, 4, 3001, 256, 1)), ((391, 4), (1, 1, 391, 32, 8)),
    ((307200, 4), (4, 16, 4800, 512, 1)),
]


@pytest.mark.parametrize("n_size,plan", BWD_PLANS,
                         ids=[f"{n}x{s}B" for (n, s), _ in BWD_PLANS])
def test_plain_bwd_sums_in_the_kernel_order(n_size, plan):
    """The backward's plain statistics follow its kernel's partition
    (``bwd_plan``: the forward's rule with dy and y staged), in the order
    written out in Python floats, and agree with an exact sum to f64
    rounding; both of its sums (dy, and dy * y) take that order."""
    n, size = n_size
    p = nk.bwd_plan(n, size)
    assert tuple(p) == plan
    v = torch.from_numpy(_x((2, 3, 1, n), n, 1.0, 0.5)).double()
    got = nk._bwd_sum(v, size)
    assert float(got[0, 0]) == _sum_in_plan_order(v[0, 0, 0].tolist(), p)
    np.testing.assert_allclose(got.numpy(), v.sum((2, 3)).numpy(),
                               rtol=1e-12)
    # the plain f32 backward's statistics are these sums over n, rounded
    dy = torch.from_numpy(_x((1, 1, 1, n), n + 1, 1.0, 0.0))
    y = torch.from_numpy(_x((1, 1, 1, n), n + 2, 1.0, 0.0))
    a = torch.ones((1, 1))
    m1 = nk._mean(nk._bwd_sum(dy.double(), 4), n)
    m2 = nk._mean(nk._bwd_sum(dy.double() * y.double(), 4), n)
    want = a[0, 0] * (dy - m1[0, 0] - y * m2[0, 0])
    torch.testing.assert_close(nk.instance_norm_bwd_plain(dy, y, a), want,
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 512, 14, 19), (4, 192, 112, 152),
                                   (2, 7, 3, 5), (2, 64, 224, 304),
                                   (4, 3, 17, 23), (2, 256, 56, 76),
                                   (2, 3, 17, 241), (1, 2, 11, 1091),
                                   (1, 2, 480, 640)])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_kernels_match_plain_on_card(shape, dt):
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(shape, device="cuda", generator=g) * 3 + 1.5).to(dt)
    dy = torch.randn(shape, device="cuda", generator=g).to(dt)
    y, a = nk.instance_norm_fwd(x, 1e-5)
    dx = nk.instance_norm_bwd(dy, y, a)
    torch.cuda.synchronize()
    py, pa = nk.instance_norm_fwd_plain(x, 1e-5)
    pdx = nk.instance_norm_bwd_plain(dy, y, a)
    assert y.dtype == dt and dx.dtype == dt and a.dtype == F32
    for got, want in ((a, pa), (y, py), (dx, pdx)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_fwd_plan_matches_the_kernel_on_card():
    """``fwd_plan`` mirrors instance_norm.cu:fwd_plan, and ``bulk_copy``
    (which planes the split's kernels stage with the TMA) its bulk_copy, at
    the plans of ``FWD_PLANS`` and at every plane size up to 3000 and a
    sweep past."""
    import ctypes

    from rdfc_gan_torch.ops.kernels import build

    _card()
    lib = build.library(nk.SOURCE)
    out = (ctypes.c_int * 5)()
    sizes = [n for (n, _), _ in FWD_PLANS] + list(range(1, 3001)) + list(
        range(3001, 420000, 997))
    for n in sizes:
        for size in (2, 4):
            lib.instance_norm_fwd_plan(n, size, out)
            assert tuple(out) == tuple(nk.fwd_plan(n, size)), (n, size)
            assert bool(lib.instance_norm_bulk_copy(n, size)) == \
                nk.bulk_copy(n, size), (n, size)


@pytest.mark.gpu
def test_bwd_plan_matches_the_kernel_on_card():
    """``bwd_plan`` mirrors instance_norm.cu:bwd_plan, at the plans of
    ``BWD_PLANS`` and at every plane size up to 3000 and a sweep past."""
    import ctypes

    from rdfc_gan_torch.ops.kernels import build

    _card()
    lib = build.library(nk.SOURCE)
    out = (ctypes.c_int * 5)()
    sizes = [n for (n, _), _ in BWD_PLANS] + list(range(1, 3001)) + list(
        range(3001, 420000, 997))
    for n in sizes:
        for size in (2, 4):
            lib.instance_norm_bwd_plan(n, size, out)
            assert tuple(out) == tuple(nk.bwd_plan(n, size)), (n, size)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 512, 30, 40), (2, 768, 60, 40),
                                   (2, 384, 120, 40), (2, 192, 240, 320),
                                   (2, 192, 240, 80), (4, 3, 17, 23)])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_split_kernels_match_plain_on_card(shape, dt):
    """The forward's split for a width-sharded plane (the W-AdaIN planes
    of 2x480x640, whole and as shards, and an odd plane): moments, and
    apply's y and scale a, bit for bit against their plain versions, and
    their one-rank composition bit for bit against the forward kernel."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(shape, device="cuda", generator=g) * 3 + 1.5).to(dt)
    n = shape[2] * shape[3]
    s = nk.instance_norm_moments(x)
    y, a = nk.instance_norm_apply(x, s, n, 1e-5)
    torch.cuda.synchronize()
    assert s.dtype == torch.float64 and y.dtype == dt and a.dtype == F32
    torch.testing.assert_close(s, nk.instance_norm_moments_plain(x), rtol=0,
                               atol=0)
    py, pa = nk.instance_norm_apply_plain(x, s, n, 1e-5)
    for got, want in ((y, py), (a, pa)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    y1, a1 = nk.instance_norm_fwd_sharded(x, 1e-5)
    y7, a7 = nk.instance_norm_fwd(x, 1e-5)
    for got, want in ((a1, a7), (y1, y7), (a, a7), (y, y7)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n,size,bulk", [
    (600, 4, True), (2400, 4, True), (9600, 4, True), (38400, 4, True),
    (600, 2, True), (266, 4, False), (266, 2, False), (391, 4, False),
    (391, 2, False), (4, 4, True), (8, 2, True), (12, 2, False)])
def test_bulk_copy_takes_whole_16_byte_vectors(n, size, bulk):
    """The TMA stages a plane where its vector is 16 bytes: the W-AdaIN
    planes of 2x480x640 as M = 2 shards (600 .. 38400 values), f32 and
    bf16; not the 14x19 planes (8-byte f32 or 4-byte bf16 vectors), an odd
    17x23 plane, or 12 bf16 values (8-byte vectors)."""
    assert nk.bulk_copy(n, size) is bulk
