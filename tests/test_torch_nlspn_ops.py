"""Parity of the PyTorch port's NLSPN ops with the JAX package, on the CPU.

The same numpy-seeded inputs go through both packages. Offsets use the
reference channel layout on the torch side; the JAX side receives them
through ``torch_convert.nlspn_offset_channel_perm``, as converted weights
would produce them. The Pallas kernels run in interpret mode, as
``tests/test_nlspn_stencil.py`` runs them. The kernel-vs-plain checks at
the end need a CUDA card and skip here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.ops import nlspn as tn
from rdfc_gan_torch.ops import nlspn_guard as tguard
from rdfc_gan_torch.ops import nlspn_stencil as tst
from rdfc_gan_torch.ops.kernels import mask_kernel as tmk
from rdfc_gan_torch.ops.kernels import nlspn_kernel as tnk
from rdfc_gan_tpu.ops import nlspn as jn
from rdfc_gan_tpu.ops import nlspn_guard as jguard
from rdfc_gan_tpu.ops import nlspn_stencil as jst
from rdfc_gan_tpu.utils.torch_convert import nlspn_offset_channel_perm

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

B, H, W = 2, 11, 13


def _inputs(seed, off_scale=1.2, preserve=False, prop_time=4):
    r = np.random.RandomState(seed)
    spec_kw = dict(prop_time=prop_time, preserve_input=preserve)
    num = 8
    raw = np.zeros((B, 3 * num, H, W), np.float32)
    raw[:, :2 * num] = r.uniform(-off_scale, off_scale, (B, 2 * num, H, W))
    raw[:, 2 * num:] = r.normal(size=(B, num, H, W))
    conf = r.uniform(0.2, 1.0, (B, 1, H, W)).astype(np.float32)
    feat = r.normal(size=(B, 1, H, W)).astype(np.float32)
    fix = np.where(r.uniform(size=(B, 1, H, W)) > 0.6,
                   np.abs(r.normal(size=(B, 1, H, W))), 0.0).astype(np.float32)
    return spec_kw, raw, conf, feat, fix


def _jraw(raw):
    perm = nlspn_offset_channel_perm(raw.shape[1] // 3)
    return jnp.asarray(raw.transpose(0, 2, 3, 1)[..., perm])


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _both_affinities(seed, radius, **kw):
    spec_kw, raw, conf, feat, fix = _inputs(seed, **kw)
    tspec, jspec = tn.NLSPNParamsSpec(**spec_kw), jn.NLSPNParamsSpec(**spec_kw)
    gamma = 0.5 * 8
    toff, taff = tn.nlspn_offset_affinity(
        torch.from_numpy(raw), torch.from_numpy(conf), torch.tensor(gamma),
        tspec, conf_sample_radius=radius)
    joff, jaff = jn.nlspn_offset_affinity(
        _jraw(raw), _nhwc(conf), jnp.asarray(gamma), jspec,
        conf_sample_radius=radius)
    return (tspec, jspec, toff, taff, joff, jaff, feat, fix)


@pytest.mark.parametrize("radius", [None, 2])
def test_offset_affinity_matches_jax(radius):
    _, _, toff, taff, joff, jaff, _, _ = _both_affinities(0, radius)
    np.testing.assert_allclose(toff.numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(joff), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(taff.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jaff), rtol=1e-5, atol=1e-6)


def _jax_masks(joff, jaff, R):
    return np.asarray(jst.build_shift_masks(joff, jaff, 3, R))


@pytest.mark.parametrize("R", [2, 3])
def test_build_shift_masks_matches_jax_one_hot(R):
    _, _, toff, taff, joff, jaff, _, _ = _both_affinities(1, R)
    got = tst.build_shift_masks(toff, taff, 3, R).numpy()
    np.testing.assert_allclose(got, _jax_masks(joff, jaff, R),
                               rtol=1e-5, atol=1e-6)


def _interpret_scatter(w, sy, sx, S):
    from jax.experimental import pallas as pl

    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    orig = pl.pallas_call
    mk._FORCE_PALLAS = True
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(mk.scatter_shift_masks(
            jnp.asarray(w), jnp.asarray(sy), jnp.asarray(sx), S))
    finally:
        pl.pallas_call = orig
        mk._FORCE_PALLAS = False


def test_scatter_plain_matches_pallas_interpret():
    """Random weights and indices, some out of range, which must add
    nothing: the port's plain scatter == the Pallas _scatter_kernel."""
    r = np.random.RandomState(2)
    K, S, h, w_ = 36, 8, 16, 20
    w = r.uniform(-1, 1, (B, K, h, w_)).astype(np.float32)
    sy = r.randint(-1, S + 1, (B, K, h, w_)).astype(np.int32)
    sx = r.randint(-1, S + 1, (B, K, h, w_)).astype(np.int32)
    got = tmk.scatter_shift_masks(torch.from_numpy(w), torch.from_numpy(sy),
                                  torch.from_numpy(sx), S).numpy()
    np.testing.assert_allclose(got, _interpret_scatter(w, sy, sx, S),
                               rtol=1e-6, atol=1e-6)


def test_build_shift_masks_matches_pallas_scatter():
    """The whole mask build with the JAX scatter taken by the Pallas kernel
    in interpret mode (the TPU path)."""
    from jax.experimental import pallas as pl

    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    _, _, toff, taff, joff, jaff, _, _ = _both_affinities(3, 2)
    orig = pl.pallas_call
    mk._FORCE_PALLAS = True
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        want = _jax_masks(joff, jaff, 2)
    finally:
        pl.pallas_call = orig
        mk._FORCE_PALLAS = False
    got = tst.build_shift_masks(toff, taff, 3, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R,preserve", [(2, False), (2, True), (3, False),
                                        (3, True)])
def test_stencil_propagate_matches_jax(R, preserve):
    tspec, _, toff, taff, joff, jaff, feat, fix = _both_affinities(
        4, R, preserve=preserve)
    tM = tst.build_shift_masks(toff, taff, 3, R)
    got = tst.stencil_propagate(torch.from_numpy(feat), tM, tspec.prop_time,
                                R, torch.from_numpy(fix), preserve)
    want = jst.stencil_propagate(_nhwc(feat), jnp.asarray(tM.numpy()),
                                 tspec.prop_time, R, feat_fix=_nhwc(fix),
                                 preserve_input=preserve)
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[..., 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("preserve", [False, True])
def test_bf16_propagation_matches_pallas_interpret(preserve):
    """The kernel's plain version (M rounded to bf16) == the Pallas
    propagation chain in interpret mode. Both sides see the same rounded
    masks, so only f32 summation order separates them."""
    from jax.experimental import pallas as pl

    import rdfc_gan_tpu.ops.pallas.nlspn_kernel as nk

    tspec, _, toff, taff, _, _, feat, fix = _both_affinities(
        5, 2, preserve=preserve)
    tM = tst.build_shift_masks(toff, taff, 3, 2)
    got = tnk.nlspn_stencil_propagate(torch.from_numpy(feat), tM,
                                      torch.from_numpy(fix), tspec.prop_time,
                                      2, preserve)
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        want = nk.nlspn_stencil_propagate_pallas(
            _nhwc(feat), jnp.asarray(tM.numpy()), _nhwc(fix),
            tspec.prop_time, 2, preserve)
    finally:
        pl.pallas_call = orig
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[..., 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("preserve", [False, True])
def test_gather_propagate_matches_jax(preserve):
    tspec, jspec, toff, taff, joff, jaff, feat, fix = _both_affinities(
        6, None, preserve=preserve, off_scale=2.5)
    got = tn.nlspn_propagate(torch.from_numpy(feat), toff, taff, tspec,
                             feat_fix=torch.from_numpy(fix))
    want = jn.nlspn_propagate(_nhwc(feat), joff, jaff, jspec,
                              feat_fix=_nhwc(fix))
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[..., 0],
                               rtol=1e-5, atol=1e-5)


def test_propagate_auto_on_cpu_is_the_unrounded_stencil():
    tspec, _, toff, taff, _, _, feat, _ = _both_affinities(7, 2)
    M = tst.build_shift_masks(toff, taff, 3, 2)
    f = torch.from_numpy(feat)
    got = tnk.propagate_auto(f, M, tspec.prop_time, 2)
    want = tst.stencil_propagate(f, M, tspec.prop_time, 2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("max_offset,cfg", [
    (1.0, {"use_nlspn_refine": True}),
    (2.3, {"use_nlspn_refine": True}),
    (9.0, {"use_nlspn_refine": True, "nlspn_offset_radius": 3}),
    (9.0, {"use_nlspn_refine": True, "nlspn_impl": "gather"}),
    (9.0, {"use_nlspn_refine": False}),
])
def test_escalate_nlspn_cfg_matches_jax(max_offset, cfg):
    assert tguard.escalate_nlspn_cfg(cfg, max_offset) == \
        jguard.escalate_nlspn_cfg(cfg, max_offset)


# ----------------------------------------------------------- on the card --
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [8, 10, 12])
def test_scatter_kernel_matches_plain_on_card(S):
    _card()
    g = torch.Generator(device="cuda").manual_seed(S)
    shape = (4, 36, 56, 76)
    w = torch.rand(shape, device="cuda", generator=g) * 2 - 1
    sy = torch.randint(-1, S + 1, shape, device="cuda", generator=g,
                       dtype=torch.int32)
    sx = torch.randint(-1, S + 1, shape, device="cuda", generator=g,
                       dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        got = tmk.scatter_shift_masks(w.to(dt), sy, sx, S)
        want = tmk.scatter_shift_masks_plain(w.to(dt), sy, sx, S)
        torch.cuda.synchronize()
        assert got.dtype == dt
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("R,preserve", [(2, False), (2, True), (3, False)])
def test_propagation_kernel_matches_plain_on_card(R, preserve):
    _card()
    tspec, _, toff, taff, _, _, feat, fix = _both_affinities(
        8, R, preserve=preserve, prop_time=18)
    M = tst.build_shift_masks(toff, taff, 3, R).cuda()
    f, fx = torch.from_numpy(feat).cuda(), torch.from_numpy(fix).cuda()
    got = tnk.nlspn_stencil_propagate(f, M, fx, 18, R, preserve)
    want = tst.stencil_propagate(f, M.to(torch.bfloat16), 18, R, fx,
                                 preserve)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
