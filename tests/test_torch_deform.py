"""The port's general deformable ops and NLSPN refine stages against the JAX
package, on the CPU: ``deform_gather``, ``modulated_deform_conv`` (its JAX
weight, offsets and mask carried by ``utils.convert``), their gradients,
``deform_psroi_pooling``, ``nlspn_refine`` and ``nlspn_refine_stencil``.
The same numpy-seeded inputs go through both packages.

Tolerances: forwards rtol = atol = 1e-5 and gradients rtol 1e-4,
atol 1e-5 (f32 sums in other orders); the NLSPN refines at 1e-5 too,
tighter than the port's parity tolerance (rtol 1e-3, atol 1e-4), which
they meet. The JAX package is imported inside the CPU tests only: the
gpu-marked test at the end runs on the card's machine.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rdfc_gan_torch.ops import (deform_gather, deform_psroi_pooling,
                                modulated_deform_conv, nlspn_refine,
                                nlspn_refine_stencil)
from rdfc_gan_torch.ops.nlspn import NLSPNParamsSpec
from rdfc_gan_torch.utils.convert import (deform_conv_weight_from_jax,
                                          deform_mask_from_jax,
                                          deform_offsets_from_jax)

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

B, H, W = 2, 9, 11
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _jax_deform():
    from rdfc_gan_tpu.ops import deform

    return deform


def _jax_inputs(r, C, K, off_scale=2.5):
    """feat (B, H, W, C), offsets (B, H, W, K, 2) and mask (B, H, W, K) in
    the JAX layouts; offsets large enough that some corners leave the
    image."""
    feat = r.normal(size=(B, H, W, C)).astype(np.float32)
    off = r.uniform(-off_scale, off_scale, (B, H, W, K, 2)).astype(np.float32)
    mask = r.uniform(0, 1, (B, H, W, K)).astype(np.float32)
    return feat, off, mask


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("kernel_size", [(3, 3), (3, 5)])
@pytest.mark.parametrize("dilation", [1, 2])
def test_deform_gather_matches_jax(with_mask, kernel_size, dilation):
    import jax.numpy as jnp

    jd = _jax_deform()
    r = np.random.RandomState(0)
    K = kernel_size[0] * kernel_size[1]
    feat, off, mask = _jax_inputs(r, 3, K)
    want = jd.deform_gather(jnp.asarray(feat), jnp.asarray(off),
                            jnp.asarray(mask) if with_mask else None,
                            kernel_size, dilation)
    got = deform_gather(_nchw(feat), deform_offsets_from_jax(off),
                        deform_mask_from_jax(mask) if with_mask else None,
                        kernel_size, dilation)
    assert tuple(got.shape) == (B, 3, K, H, W)
    np.testing.assert_allclose(got.numpy().transpose(0, 3, 4, 2, 1),
                               np.asarray(want), **FWD)


# (Cin, Cout, groups): plain, depthwise (Cin/g = 1) and Cin/g = 2, where
# the JAX weight's grouped reading differs from HWIO
GROUPS = [(4, 6, 1), (4, 8, 4), (4, 6, 2)]


def _conv_case(seed, cin, cout, groups, kernel_size=(3, 3)):
    r = np.random.RandomState(seed)
    kh, kw = kernel_size
    feat, off, mask = _jax_inputs(r, cin, kh * kw)
    w = r.normal(size=(kh * kw, cin // groups, cout)).astype(np.float32)
    bias = r.normal(size=(cout,)).astype(np.float32)
    return feat, off, mask, w, bias


@pytest.mark.parametrize("cin,cout,groups", GROUPS)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_modulated_deform_conv_matches_jax(cin, cout, groups, with_bias,
                                           with_mask):
    import jax.numpy as jnp

    jd = _jax_deform()
    feat, off, mask, w, bias = _conv_case(1, cin, cout, groups)
    want = jd.modulated_deform_conv(
        jnp.asarray(feat), jnp.asarray(off),
        jnp.asarray(mask) if with_mask else None, jnp.asarray(w),
        jnp.asarray(bias) if with_bias else None, groups=groups)
    got = modulated_deform_conv(
        _nchw(feat), deform_offsets_from_jax(off),
        deform_mask_from_jax(mask) if with_mask else None,
        deform_conv_weight_from_jax(w, groups, 3, 3),
        torch.from_numpy(bias) if with_bias else None, groups=groups)
    assert tuple(got.shape) == (B, cout, H, W)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **FWD)


@pytest.mark.parametrize("cin,cout,groups", GROUPS)
def test_modulated_deform_conv_grads_match_jax(cin, cout, groups):
    """Gradients of sum(out^2) in feat, offsets, mask and weight against
    ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    jd = _jax_deform()
    feat, off, mask, w, bias = _conv_case(2, cin, cout, groups)

    def loss(f, o, m, k):
        out = jd.modulated_deform_conv(f, o, m, k, jnp.asarray(bias),
                                       groups=groups)
        return jnp.sum(out * out)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (feat, off, mask, w)))
    tf = _nchw(feat).requires_grad_()
    to = deform_offsets_from_jax(off).requires_grad_()
    tm = deform_mask_from_jax(mask).requires_grad_()
    tw = deform_conv_weight_from_jax(w, groups, 3, 3).requires_grad_()
    out = modulated_deform_conv(tf, to, tm, tw, torch.from_numpy(bias),
                                groups=groups)
    (out * out).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[0]), **GRAD)
    np.testing.assert_allclose(to.grad.numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(want[1]), **GRAD)
    np.testing.assert_allclose(tm.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want[2]), **GRAD)
    np.testing.assert_allclose(
        tw.grad.numpy(),
        deform_conv_weight_from_jax(np.asarray(want[3]), groups, 3,
                                    3).numpy(), **GRAD)


@pytest.mark.parametrize("cin,cout,groups", GROUPS)
@pytest.mark.parametrize("dilation", [1, 2])
def test_zero_offsets_are_grouped_conv2d(cin, cout, groups, dilation):
    """At zero offsets and no mask, the port's weight means what the
    reference DCNv2 weight means: a grouped ``F.conv2d`` with 'same'
    padding."""
    r = np.random.RandomState(3)
    feat = torch.from_numpy(r.normal(size=(B, cin, H, W)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(cout, cin // groups, 3, 3)).astype(
        np.float32))
    bias = torch.from_numpy(r.normal(size=(cout,)).astype(np.float32))
    got = modulated_deform_conv(feat, torch.zeros((B, 9, 2, H, W)), None, w,
                                bias, dilation=dilation, groups=groups)
    want = F.conv2d(feat, w, bias, padding=dilation, dilation=dilation,
                    groups=groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)


def test_integer_offset_is_a_shift():
    """One tap moved by a whole (dy, dx) = (2, -3) reads feat there, and
    zero where that lies outside the image, exactly."""
    r = np.random.RandomState(4)
    feat = r.normal(size=(B, 3, H, W)).astype(np.float32)
    off = torch.zeros((B, 1, 2, H, W))
    off[:, :, 0], off[:, :, 1] = 2.0, -3.0
    got = deform_gather(torch.from_numpy(feat), off, None, (1, 1)).numpy()
    want = np.zeros_like(feat)
    want[:, :, :H - 2, 3:] = feat[:, :, 2:, :W - 3]
    np.testing.assert_array_equal(got[:, :, 0], want)


P, SPP = 3, 2


def _psroi_case(seed, C):
    r = np.random.RandomState(seed)
    feat = r.normal(size=(B, 12, 14, C)).astype(np.float32)
    # (batch, x1, y1, x2, y2) at spatial scale 1/2, one ROI reaching past
    # the image, two ROIs on each batch item, one of them a sliver
    rois = np.array([[0, 2, 3, 17, 20], [1, 0, 0, 30, 26],
                     [1, 10, 4, 34, 30], [0, 6, 6, 6.1, 6.1]], np.float32)
    off = r.uniform(-0.5, 0.5, (len(rois), P, P, 2)).astype(np.float32)
    return feat, rois, off


@pytest.mark.parametrize("ps,offsets,no_trans", [
    (True, True, False), (False, True, False), (True, True, True),
    (False, False, False)])
def test_deform_psroi_pooling_matches_jax(ps, offsets, no_trans):
    import jax.numpy as jnp

    from rdfc_gan_tpu.ops.deform_roi import deform_psroi_pooling as jpsroi

    C = P * P * 2
    feat, rois, off = _psroi_case(5, C)
    kw = dict(pooled_size=P, output_dim=2 if ps else None, spatial_scale=0.5,
              sample_per_part=SPP, gamma=0.1, no_trans=no_trans)
    want = jpsroi(jnp.asarray(feat), jnp.asarray(rois),
                  jnp.asarray(off) if offsets else None, **kw)
    got = deform_psroi_pooling(
        _nchw(feat), torch.from_numpy(rois),
        torch.from_numpy(off.transpose(0, 3, 1, 2).copy()) if offsets
        else None, **kw)
    assert tuple(got.shape) == (len(rois), 2 if ps else C, P, P)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), **FWD)


def _refine_inputs(seed, preserve):
    """pred_init, the guidance conv's raw output in the reference channel
    layout (offsets within the stencil radius 2), confidence, origin
    depth."""
    r = np.random.RandomState(seed)
    num = 8
    raw = np.zeros((B, 3 * num, H, W), np.float32)
    raw[:, :2 * num] = r.uniform(-1.2, 1.2, (B, 2 * num, H, W))
    raw[:, 2 * num:] = r.normal(size=(B, num, H, W))
    conf = r.uniform(0.2, 1.0, (B, 1, H, W)).astype(np.float32)
    pred = r.normal(size=(B, 1, H, W)).astype(np.float32)
    fix = np.where(r.uniform(size=(B, 1, H, W)) > 0.6,
                   np.abs(r.normal(size=(B, 1, H, W))), 0.0).astype(
                       np.float32)
    spec = dict(prop_time=4, preserve_input=preserve)
    return spec, raw, conf, pred, fix


@pytest.mark.parametrize("stencil", [False, True])
@pytest.mark.parametrize("preserve", [False, True])
def test_nlspn_refine_matches_jax(stencil, preserve):
    import jax.numpy as jnp

    from rdfc_gan_tpu.ops import nlspn as jn
    from rdfc_gan_tpu.ops import nlspn_stencil as jst
    from rdfc_gan_tpu.utils.torch_convert import nlspn_offset_channel_perm

    spec_kw, raw, conf, pred, fix = _refine_inputs(6, preserve)
    gamma = 0.5 * 8

    def nhwc(a):
        return jnp.asarray(a.transpose(0, 2, 3, 1))

    jraw = nhwc(raw)[..., nlspn_offset_channel_perm(8)]
    jfn = jst.nlspn_refine_stencil if stencil else jn.nlspn_refine
    want = jfn(nhwc(pred), jraw, nhwc(conf), jnp.asarray(gamma),
               jn.NLSPNParamsSpec(**spec_kw), origin_depth=nhwc(fix))
    tfn = nlspn_refine_stencil if stencil else nlspn_refine
    got = tfn(torch.from_numpy(pred), torch.from_numpy(raw),
              torch.from_numpy(conf), torch.tensor(gamma),
              NLSPNParamsSpec(**spec_kw), origin_depth=torch.from_numpy(fix))
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[..., 0],
                               **FWD)


@pytest.mark.parametrize("C", [1, 5])
def test_fixed_order_scatter_add_matches_scatter_add(C):
    """The sampled feature's gradient sum on the CPU adds each target's
    contributions one at a time in increasing n, as ``scatter_add_`` does:
    bit for bit, at about 80 contributions a target, on four threads."""
    from rdfc_gan_torch.ops import deform

    r = np.random.default_rng(3)
    B, N, L = 2, 4000, 50
    g = torch.from_numpy(r.normal(size=(B, C, N)).astype(np.float32))
    idx = torch.from_numpy(r.integers(0, L, (B, N)))
    want = torch.zeros((B, C, L)).scatter_add_(
        2, idx[:, None].expand(B, C, N), g)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = deform._fixed_order_scatter_add(g, idx, L)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_deform_conv_backward_repeats_on_card():
    """Two backward passes of a DCNv2 layer (64 -> 64 channels, groups 1
    and 64, and 1 -> 1 channel as NLSPN uses it; offsets up to 4 pixels)
    on the card give bit-equal gradients: the sampled feature's gradient
    adds in a fixed order, where ``torch.gather``'s CUDA backward adds with
    atomics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, w = 2, 28, 38
    off = torch.empty((b, 9, 2, h, w), device="cuda").uniform_(
        -4, 4, generator=gen)
    mask = torch.rand((b, 9, h, w), device="cuda", generator=gen)
    for c, groups in ((64, 1), (64, 64), (1, 1)):
        feat = torch.randn((b, c, h, w), device="cuda", generator=gen)
        weight = torch.randn((c, c // groups, 3, 3), device="cuda",
                             generator=gen)

        def grads():
            ins = [t.clone().requires_grad_() for t in (feat, off, mask,
                                                        weight)]
            out = modulated_deform_conv(*ins, groups=groups)
            (out * out).sum().backward()
            return [t.grad for t in ins]

        for u, v in zip(grads(), grads()):
            assert torch.equal(u, v)
