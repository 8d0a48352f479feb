"""Parity of the port's instance norm with the JAX package, on the CPU.

The plain forward and the ``autograd.Function``'s gradient against
``rdfc_gan_tpu.models.layers.instance_norm`` and ``jax.grad`` (through the
JAX custom VJP and through its autodiff), at planes that include the
served 14x19, eps 1e-5 and 1e-3, f32 and bf16; the plain versions against
the retired TPU kernels (attic/norm_kernel.py) in Pallas interpret mode.
Inputs come from numpy seeds. The kernel-vs-plain checks at the end need a
CUDA card and skip here; they import nothing of the JAX package, so they
also run where flax is missing. The plain versions sum in the kernels'
order, so those checks are exact.

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


@pytest.mark.parametrize("shape", SHAPES)
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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_plain_sums_in_the_kernel_order():
    """The plain statistics follow the kernels' reduction (strided f64
    thread sums, xor-shuffle warp trees, warp sums in order) at every
    block size, and agree with an exact sum to f64 rounding."""
    for n, threads in ((15, 128), (266, 128), (1064, 256), (4096, 256),
                       (4256, 512), (17024, 512)):
        assert nk.block_threads(n) == threads
        v = torch.from_numpy(_x((2, 3, 1, n), n, 1.0, 0.5)).double()
        got = nk._block_sum(v)
        # the same order written out for plane (0, 0), in Python floats
        part = [0.0] * threads
        for i, val in enumerate(v[0, 0, 0].tolist()):
            part[i % threads] += val
        warps = []
        for w in range(threads // 32):
            lane = np.array(part[32 * w:32 * w + 32])
            for o in (16, 8, 4, 2, 1):
                lane = lane + lane[np.arange(32) ^ o]
            warps.append(lane[0])
        want = 0.0
        for w in warps:
            want += w
        assert float(got[0, 0]) == want
        np.testing.assert_allclose(got.numpy(), v.sum((2, 3)).numpy(),
                                   rtol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 512, 14, 19), (4, 192, 112, 152),
                                   (2, 7, 3, 5)])
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
