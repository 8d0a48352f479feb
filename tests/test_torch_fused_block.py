"""Parity of the port's fused BasicBlock and its conv kernels' plain versions
with the JAX package, on the CPU, and of the train-mode BatchNorm under bf16.

* The block (``ops/fused_block.basic_block``, plain versions on the CPU)
  against the JAX ``BasicBlock`` in train mode: output, running statistics,
  the gradients of x, both kernels, both gammas and both betas.
* ``conv3x3_fwd_plain`` / ``conv3x3_bwd_plain`` against the retired TPU
  kernels (attic/conv_block_kernel.py) in Pallas interpret mode.
* The plain versions' summation order, written out.
* ``BatchNorm2d`` on a bf16 input against the JAX ``BatchNorm``: equal bit
  for bit (torch's fused batch norm rounds the normalised value once).
* ``gpu``-marked checks of the kernels against their plain versions, which
  skip without a card: the f32 kernels bit for bit, the bf16 ones within
  the tolerance ``conv_block_kernel`` states
  (tests/test_torch_conv3x3_bf16.py).

Tolerances: rtol 1e-3 / atol 1e-4 for values (f32, the port's default);
the running statistics rtol 1e-4 / atol 1e-5; gradients within 2e-4 of each
tensor's largest entry plus 5e-6 (tests/test_torch_train_step.py). The attic
kernels sum in f32 and take the moments before rounding y, the port in f64
after it: f32 rounding apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models.layers import BatchNorm2d
from rdfc_gan_torch.models.resnet import BasicBlock
from rdfc_gan_torch.ops.fused_block import basic_block
from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

FWD = dict(rtol=1e-3, atol=1e-4)
STATS = dict(rtol=1e-4, atol=1e-5)


def _r(shape, seed, scale=1.0, shift=0.0):
    r = np.random.RandomState(seed)
    return (r.normal(size=shape) * scale + shift).astype(np.float32)


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _hwio(w):
    return jnp.asarray(np.asarray(w).transpose(2, 3, 1, 0))


def _grad_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max() + 5e-6)


# ------------------------------------------------------- the whole block --
def _torch_block(C, seed):
    torch.manual_seed(seed)
    blk = BasicBlock(C, C).train()
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
            bn.running_mean.uniform_(-0.2, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
    return blk


def _jax_vars(blk):
    p = {"Conv_0": {"kernel": _hwio(blk.conv1.weight.detach())},
         "Conv_1": {"kernel": _hwio(blk.conv2.weight.detach())}}
    s = {}
    for i, bn in enumerate((blk.bn1, blk.bn2)):
        p[f"BatchNorm_{i}"] = {"scale": jnp.asarray(bn.weight.detach()),
                               "bias": jnp.asarray(bn.bias.detach())}
        s[f"BatchNorm_{i}"] = {"mean": jnp.asarray(bn.running_mean),
                               "var": jnp.asarray(bn.running_var)}
    return p, s


@pytest.mark.parametrize("shape", [(2, 8, 8, 12), (3, 4, 7, 5)])
def test_block_matches_jax_train_mode(shape):
    from rdfc_gan_tpu.models.resnet import BasicBlock as JBlock

    B, C, H, W = shape
    blk = _torch_block(C, 0)
    assert blk.fused()
    params, stats = _jax_vars(blk)
    x = _r(shape, 1, 2.0, 0.3)
    wr = _r(shape, 2)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = blk(xt)
    (out * torch.from_numpy(wr)).sum().backward()

    jb = JBlock(planes=C)

    def loss(p, xj):
        o, mut = jb.apply({"params": p, "batch_stats": stats}, xj,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(o * _nhwc(wr)), (o, mut)

    (_, (want, mut)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, _nhwc(x))
    np.testing.assert_allclose(out.detach().numpy(), _nchw(want), **FWD)
    for i, bn in enumerate((blk.bn1, blk.bn2)):
        ms = mut["batch_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(ms["mean"]), **STATS)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(ms["var"]), **STATS)
        assert int(bn.num_batches_tracked) == 1
        g = gp[f"BatchNorm_{i}"]
        _grad_close(bn.weight.grad.numpy(), np.asarray(g["scale"]))
        _grad_close(bn.bias.grad.numpy(), np.asarray(g["bias"]))
    for conv, name in ((blk.conv1, "Conv_0"), (blk.conv2, "Conv_1")):
        want_w = np.asarray(gp[name]["kernel"]).transpose(3, 2, 0, 1)
        _grad_close(conv.weight.grad.numpy(), want_w)
    _grad_close(xt.grad.numpy(), _nchw(gx))


def test_block_bf16_rounds_as_jax():
    """bf16: the block's output against the JAX BasicBlock applied to the
    same bf16 input and bf16 parameters (f32 statistics, the affine in
    bf16). The statistics and the convs are summed in another order and
    round y1 differently, so some elements move by a bf16 ulp."""
    from rdfc_gan_tpu.models.resnet import BasicBlock as JBlock

    shape = (2, 8, 8, 12)
    blk = _torch_block(8, 3)
    params, stats = _jax_vars(blk)
    x = _r(shape, 4, 2.0, 0.3)
    with torch.no_grad():
        out = blk(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    # every parameter in the compute type, as the JAX train step casts them
    params = jax.tree.map(lambda v: v.astype(jnp.bfloat16), params)
    want = JBlock(planes=8).apply({"params": params, "batch_stats": stats},
                                  _nhwc(x).astype(jnp.bfloat16), train=True,
                                  mutable=["batch_stats"])[0]
    got, want = out.float().numpy(), _nchw(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2 ** -6,
                               atol=2 ** -6 * np.abs(want).max())
    assert float(np.mean(got != want)) < 0.05


def test_eval_and_projection_blocks_are_not_fused():
    assert not BasicBlock(4, 4).eval().fused()
    assert not BasicBlock(4, 8).train().fused()
    assert not BasicBlock(4, 4, stride=2).train().fused()
    assert not BasicBlock(4, 4, dilation=2).train().fused()


# -------------------------------------------- plain versions vs the attic --
@pytest.mark.parametrize("act,affine", [("none", False), ("relu", True),
                                        ("none", True)])
def test_plain_forward_matches_retired_tpu_kernel(act, affine):
    from attic import conv_block_kernel as ak

    B, C, Co, H, W = 2, 8, 6, 8, 8
    u = _r((B, C, H, W), 5, 1.5, 0.2)
    w = _r((Co, C, 3, 3), 6, 0.3)
    a = _r((C,), 7, 0.3, 1.0) if affine else None
    b = _r((C,), 8, 0.3) if affine else None
    ta = None if a is None else torch.from_numpy(a)
    tb = None if b is None else torch.from_numpy(b)
    y, mom = ck.conv3x3_fwd_plain(torch.from_numpy(u), torch.from_numpy(w),
                                  ta, tb, act)
    yj, momj = ak.fused_conv3x3_fwd(
        _nhwc(u), _hwio(w),
        jnp.asarray(a if affine else np.ones(C, np.float32)),
        jnp.asarray(b if affine else np.zeros(C, np.float32)), act=act)
    np.testing.assert_allclose(y.numpy(), _nchw(yj), **FWD)
    assert mom.dtype == torch.float64 and mom.shape == (B, 2, Co)
    np.testing.assert_allclose(mom.numpy(), np.asarray(momj), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("act,finalize,sums,carry", [
    ("relu", True, True, False), ("none", True, False, True),
    ("none", False, False, False)])
def test_plain_backward_matches_retired_tpu_kernel(act, finalize, sums,
                                                   carry):
    from attic import conv_block_kernel as ak

    B, C, Co, H, W = 2, 8, 6, 8, 8
    g = _r((B, Co, H, W), 10)
    u = _r((B, C, H, W), 11, 1.5, 0.2)
    w = _r((Co, C, 3, 3), 12, 0.3)
    relu = act == "relu"
    a = _r((C,), 13, 0.3, 1.0) if relu else np.ones(C, np.float32)
    b = _r((C,), 14, 0.3) if relu else np.zeros(C, np.float32)
    y = _r((B, Co, H, W), 15, 2.0, 0.5)
    fin = np.stack([_r((Co,), 16, 0.3, 1.0), _r((Co,), 17, 0.1),
                    _r((Co,), 18, 0.1), _r((Co,), 19, 0.3),
                    _r((Co,), 20, 0.1, 0.8)])
    xh = (_r((C,), 21, 0.3), _r((C,), 22, 0.1, 0.8))
    cy = _r((B, C, H, W), 23)
    t = torch.from_numpy
    gout, dw, s = ck.conv3x3_bwd_plain(
        t(g), t(u), t(w), t(a) if relu else None, t(b) if relu else None,
        act, y=t(y) if finalize else None, fin=t(fin) if finalize else None,
        xh=(t(xh[0]), t(xh[1])) if sums else None,
        carry=t(cy) if carry else None)
    wf = _hwio(w)[::-1, ::-1].swapaxes(2, 3)

    def rows(v):
        return jnp.broadcast_to(jnp.asarray(v)[None], (B,) + v.shape)

    gj, dwj, sj = ak.fused_conv3x3_bwd(
        _nhwc(g), _nhwc(u), wf, rows(a), rows(b),
        y=_nhwc(y) if finalize else None,
        fin=rows(fin) if finalize else None,
        xh=rows(np.stack(xh)) if sums else None,
        carry=_nhwc(cy) if carry else None, act=act)
    np.testing.assert_allclose(gout.numpy(), _nchw(gj), **FWD)
    np.testing.assert_allclose(dw.numpy(),
                               np.asarray(dwj).transpose(3, 2, 0, 1), **FWD)
    if sums:
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-4,
                                   atol=1e-3)
    else:
        assert s is None and sj is None


def test_plain_sums_in_the_kernel_order():
    """Each conv output adds its (ci, kh, kw) terms in turn; each weight
    gradient entry adds along the row, then the rows of a group in turn,
    then the groups: written out here in Python floats for one entry."""
    B, C, Co, H, W = 2, 3, 2, 5, 4
    z = torch.from_numpy(_r((B, C, H, W), 30))
    w = torch.from_numpy(_r((Co, C, 3, 3), 31))
    acc = ck._seq_conv(z, w)
    zp = np.pad(z.double().numpy(), ((0, 0), (0, 0), (1, 1), (1, 1)))
    wd = w.double().numpy()
    s = 0.0
    for ci in range(C):
        for kh in range(3):
            for kw in range(3):
                s += float(zp[1, ci, 2 + kh, 3 + kw]) * float(wd[1, ci, kh,
                                                                   kw])
    assert float(acc[1, 1, 2, 3]) == s
    dy = torch.from_numpy(_r((B, Co, H, W), 32))
    dw = ck._seq_wgrad(z, dy)
    rows = []
    for b in range(B):
        for h in range(H):
            r = 0.0
            for x in range(W):
                r += float(zp[b, 2, h + 0, x + 2]) * float(dy[b, 1, h, x])
            rows.append(r)
    tot = 0.0
    for g0 in range(0, len(rows), ck.ROW_GROUP):
        grp = 0.0
        for r in rows[g0:g0 + ck.ROW_GROUP]:
            grp += r
        tot += grp
    assert float(dw[1, 2, 0, 2]) == np.float32(tot)


# ---------------------------------------------- BatchNorm2d under bf16 --
def test_batchnorm_bf16_follows_the_jax_rounding():
    """Queue 3 fault: torch's fused batch norm of a bf16 input (what every
    train-mode BN gets under the train step's bf16 autocast) rounds the
    normalised value once; the JAX BatchNorm rounds a and b to bf16, then
    the product and the sum. Now bit for bit as JAX."""
    from rdfc_gan_tpu.models.layers import BatchNorm as JBatchNorm

    x = _r((4, 128, 28, 38), 40, 3.0, 1.5)
    bn = BatchNorm2d(128, eps=1e-5).train()
    with torch.no_grad():
        # values of bf16, as the JAX train step casts its parameters
        bn.weight.copy_(torch.from_numpy(_r((128,), 41, 0.2, 1.0))
                        .to(torch.bfloat16).float())
        bn.bias.copy_(torch.from_numpy(_r((128,), 42, 0.3))
                      .to(torch.bfloat16).float())
    got = bn(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    params = {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = {"mean": jnp.zeros(128), "var": jnp.ones(128)}
    want, mut = JBatchNorm(momentum=0.9, epsilon=1e-5).apply(
        {"params": params, "batch_stats": stats},
        _nhwc(x).astype(jnp.bfloat16), mutable=["batch_stats"])
    np.testing.assert_array_equal(got.float().detach().numpy(),
                                  _nchw(want.astype(jnp.float32)))
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               **STATS)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               **STATS)


def test_batchnorm_bf16_gradient_matches_jax_in_f32():
    """The bf16 formula's gradient (autograd's) is the JAX BatchNorm's;
    checked on the same formula in f32, where it is exact to rounding."""
    from rdfc_gan_tpu.models.layers import _bn_train_fwd_impl

    x = _r((3, 5, 6, 7), 43, 2.0, 0.5)
    wr = _r((3, 5, 6, 7), 44)
    bn = BatchNorm2d(5).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    xt = torch.from_numpy(x).requires_grad_(True)
    (bn._forward_rounded(xt) * torch.from_numpy(wr)).sum().backward()
    sc, bi = (jnp.asarray(p.detach().numpy()) for p in (bn.weight, bn.bias))

    def loss(xj, s, b):
        return jnp.sum(_bn_train_fwd_impl(xj, s, b, 1e-5, 1, None)[0]
                       * _nhwc(wr))

    gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(_nhwc(x), sc, bi)
    _grad_close(xt.grad.numpy(), _nchw(gx))
    _grad_close(bn.weight.grad.numpy(), np.asarray(gs))
    _grad_close(bn.bias.grad.numpy(), np.asarray(gb))


# ------------------------------------------------------ kernels on a card --
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 20, 37), (1, 24, 9, 70)])
def test_kernels_match_plain_on_card(dt, shape):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, C, H, W = shape

    def rnd(*s, scale=1.0):
        return torch.randn(s, device="cuda", generator=gen) * scale

    u = rnd(B, C, H, W).to(dt)
    w = rnd(C, C, 3, 3, scale=0.2)
    a, b = rnd(C, scale=0.3) + 1, rnd(C, scale=0.3)
    # f32: conv_block.cu, bit-equal; bf16: conv3x3_bf16.cu, f32 sums on the
    # tensor cores, within the stated tolerance (conv_block_kernel.Y_ULPS,
    # Y_SUM_RTOL, MOM_RTOL, SUM_RTOL)
    bf16 = dt == torch.bfloat16
    for args in ((None, None, "none"), (a, b, "relu")):
        got = ck.conv3x3_fwd(u, w, *args)
        if bf16:
            rows = ck.check_fwd_bf16(got, u, w, *args)
            assert ck.within(rows), rows
            continue
        want = ck.conv3x3_fwd_plain(u, w, *args)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    g, y, cy = rnd(B, C, H, W).to(dt), rnd(B, C, H, W).to(dt), \
        rnd(B, C, H, W).to(dt)
    fin = torch.stack([rnd(C) + 1, rnd(C, scale=0.1), rnd(C, scale=0.1),
                       rnd(C), rnd(C, scale=0.1) + 1])
    xh = (rnd(C), rnd(C, scale=0.1) + 1)
    for kw in (dict(a=a, b=b, act="relu", y=y, fin=fin, xh=xh),
               dict(y=y, fin=fin, carry=cy), {}):
        got = ck.conv3x3_bwd(g, u, w, **kw)
        if bf16:
            assert (got[2] is None) == ("xh" not in kw)
            rows = ck.check_bwd_bf16(got, g, u, w, **kw)
            assert ck.within(rows), rows
            continue
        want = ck.conv3x3_bwd_plain(g, u, w, **kw)
        for x, y_ in zip(got, want):
            if y_ is None:
                assert x is None
            else:
                torch.testing.assert_close(x, y_, rtol=0, atol=0)


@pytest.mark.gpu
def test_block_kernels_match_plain_on_card():
    _card()
    from unittest import mock

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 16, 12, 20), device="cuda", generator=gen)
    blk = BasicBlock(16, 16).cuda().train()
    outs = []
    for patch in (False, True):
        xt = x.clone().requires_grad_(True)
        blk.zero_grad()
        ctx = (mock.patch.multiple(
            "rdfc_gan_torch.ops.fused_block",
            conv3x3_fwd=ck.conv3x3_fwd_plain,
            conv3x3_bwd=ck.conv3x3_bwd_plain) if patch
            else mock.patch.dict({}))
        with ctx:
            out, _ = basic_block(xt, blk.conv1.weight, blk.bn1.weight,
                                 blk.bn1.bias, blk.conv2.weight,
                                 blk.bn2.weight, blk.bn2.bias)
            out.square().sum().backward()
        outs.append([out.detach(), xt.grad] + [p.grad.clone()
                                               for p in blk.parameters()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
