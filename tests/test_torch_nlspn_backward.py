"""Parity of the port's NLSPN backward with the JAX package, on the CPU.

The plain versions of the four backward kernels (the scatter's gather, the
chain that stores its inputs X, the reverse gradient chain, the shift
correlation) against the JAX Pallas kernels in interpret mode, as
``tests/test_nlspn_stencil.py`` runs them, and against the XLA fallbacks;
then the gradients of the port's two propagation Functions and of the mask
build against ``jax.grad``. Inputs come from numpy seeds. The
kernel-vs-plain checks at the end need a CUDA card and skip here.

Tolerances. A gather copies values: exact. The plain chains sum in the
XLA order and the Pallas kernels in column groups, so f32 results agree to
rounding, amplified by T=4 steps of 64-term sums: rtol 1e-5, atol 1e-5.
Stacks stored in bf16 may round one ulp apart (2^-8): rtol 8e-3. Gradients
through whole Functions: rtol 1e-4, atol 1e-5 in f32; with bf16 stacks the
mask gradient sums bf16-rounded products, so it is held by its relative L2
error (< 1e-2) and elementwise at 2% of its scale, as the JAX package's own
test holds its kernels against its f32 reference. A correlation stored in
bf16 from f32 stacks: the two f32 sums (equal within the f32 case's
tolerance) may round to neighbouring bf16 values, so 1 bf16 ulp of the
reference plus the f32 case's atol.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.ops import nlspn as tn
from rdfc_gan_torch.ops import nlspn_stencil as tst
from rdfc_gan_torch.ops.kernels import mask_kernel as tmk
from rdfc_gan_torch.ops.kernels import nlspn_kernel as tnk
from rdfc_gan_tpu.ops import nlspn_stencil as jst

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

B, H, W, T = 2, 8, 9, 4
F32, BF16 = torch.float32, torch.bfloat16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}


@pytest.fixture
def pallas_interpret():
    """Route pallas_call through interpret mode and force the Pallas
    branches of mask_kernel, restoring both afterwards."""
    from jax.experimental import pallas as pl

    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    mk._FORCE_PALLAS = True
    try:
        yield
    finally:
        pl.pallas_call = orig
        mk._FORCE_PALLAS = False


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _window(R):
    lo, hi = tst.shift_window(R)
    return lo, hi - lo + 1


def _chain_inputs(seed, R):
    """feat0 (B,H,W), an M stack already rounded to bf16, fix with zeros."""
    r = np.random.RandomState(seed)
    _, S = _window(R)
    feat0 = r.normal(size=(B, H, W)).astype(np.float32)
    M = (r.normal(size=(B, S, S, H, W)) * 0.2).astype(np.float32)
    M16 = torch.from_numpy(M).to(BF16)
    fix = (np.abs(r.normal(size=(B, H, W)))
           * (r.random_sample((B, H, W)) > 0.4)).astype(np.float32)
    return torch.from_numpy(feat0), M16, torch.from_numpy(fix)


# ------------------------------------------------------ kernel 2: gather --
def _jax_gather(dM, sy, sx, S, wdt):
    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    dw, _, _ = mk._scatter_bwd(S, (jnp.asarray(sy), jnp.asarray(sx),
                                   jnp.zeros((0,), wdt)), dM)
    return dw


@pytest.mark.parametrize("dt", [F32, BF16])
def test_gather_plain_matches_pallas_and_xla(dt, pallas_interpret):
    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    r = np.random.RandomState(0)
    K, S = 36, 8
    dM = torch.from_numpy(r.normal(size=(B, S * S, H, W)).astype(
        np.float32)).to(dt)
    jdM = jnp.asarray(dM.float().numpy()).astype(JDT[dt])
    sy = r.randint(0, S, (B, K, H, W)).astype(np.int32)
    sx = r.randint(0, S, (B, K, H, W)).astype(np.int32)
    got = tmk.shift_mask_gather(dM, torch.from_numpy(sy),
                                torch.from_numpy(sx), S, dt)
    assert got.dtype == dt
    pallas = _jax_gather(jdM, sy, sx, S, JDT[dt])
    mk._FORCE_PALLAS = False
    xla = _jax_gather(jdM, sy, sx, S, JDT[dt])
    np.testing.assert_array_equal(_np(got), _np(pallas))
    np.testing.assert_array_equal(_np(got), _np(xla))


def test_gather_out_of_range_gives_zero_as_pallas(pallas_interpret):
    """Out-of-range indices: 0, as the Pallas kernel (the XLA fallback
    clips instead; callers clamp, so only the kernel's semantics count)."""
    r = np.random.RandomState(1)
    K, S = 36, 8
    dM = r.normal(size=(B, S * S, H, W)).astype(np.float32)
    sy = r.randint(-1, S + 1, (B, K, H, W)).astype(np.int32)
    sx = r.randint(-1, S + 1, (B, K, H, W)).astype(np.int32)
    got = tmk.shift_mask_gather(torch.from_numpy(dM), torch.from_numpy(sy),
                                torch.from_numpy(sx), S, F32)
    want = _jax_gather(jnp.asarray(dM), sy, sx, S, jnp.float32)
    assert (got == 0).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- kernel 4: forward chain + X --
@pytest.mark.parametrize("R,preserve,dt", [(2, False, F32), (3, True, BF16)])
def test_forward_x_plain_matches_pallas_and_xla(R, preserve, dt,
                                                pallas_interpret):
    import rdfc_gan_tpu.ops.pallas.nlspn_kernel as nk

    feat0, M16, fix = _chain_inputs(2, R)
    lo, S = _window(R)
    out, X = tnk.propagate_x(feat0, M16, fix if preserve else None, T, R, dt)
    assert X.dtype == dt and X.shape == (T, B, H, W)
    jM = jnp.asarray(M16.float().numpy()).astype(jnp.bfloat16)
    jfix = jnp.asarray(fix.numpy())
    jout, jX = nk._pallas_forward_x(jnp.asarray(feat0.numpy()), jM, jfix,
                                    (jfix > 0).astype(jnp.float32), T, R,
                                    preserve, JDT[dt])
    xo, xX = jst._scan_forward(jnp.asarray(feat0.numpy()),
                               jM.astype(jnp.float32), T, lo, S,
                               max(-lo, lo + S - 1),
                               jfix if preserve else None,
                               (jfix > 0) if preserve else None)
    xtol = dict(rtol=8e-3, atol=1e-5) if dt == BF16 else dict(rtol=1e-5,
                                                              atol=1e-5)
    for want_out, want_X in ((jout, jX), (xo, xX)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(X), _np(want_X), **xtol)


# ---------------------------------------------- kernel 5: reverse chain --
@pytest.mark.parametrize("R,preserve,dt", [(2, False, F32), (3, True, BF16)])
def test_reverse_chain_plain_matches_pallas_and_xla(R, preserve, dt,
                                                    pallas_interpret):
    import rdfc_gan_tpu.ops.pallas.nlspn_kernel as nk

    g0, M16, fix = _chain_inputs(3, R)
    lo, S = _window(R)
    G, dfeat, dfix = tnk.reverse_chain(g0, M16, fix if preserve else None,
                                       T, R, dt)
    assert G.dtype == dt and G.shape == (T, B, H, W)
    jM = jnp.asarray(M16.float().numpy()).astype(jnp.bfloat16)
    jfix = jnp.asarray(fix.numpy())
    jG, jdfeat, jdfix = nk._pallas_reverse_chain(
        jnp.asarray(g0.numpy()), jM, (jfix > 0).astype(jnp.float32), T, R,
        preserve, JDT[dt])
    gtol = dict(rtol=8e-3, atol=1e-5) if dt == BF16 else dict(rtol=1e-5,
                                                              atol=1e-5)
    np.testing.assert_allclose(_np(G), _np(jG), **gtol)
    # the XLA fallback: _prop_bwd's reverse scan (its dM needs X, so the
    # forward's stack from the plain twin is handed in)
    _, X = tnk.propagate_x(torch.zeros_like(g0), M16,
                           fix if preserve else None, T, R, F32)
    xdfeat, _, xdfix = jst._prop_bwd(
        T, R, preserve, (jnp.asarray(X.numpy()), jM.astype(jnp.float32),
                         (jfix > 0) if preserve else None,
                         jfix[..., None]), jnp.asarray(g0.numpy())[..., None])
    for want_feat, want_fix in ((jdfeat, jdfix), (xdfeat[..., 0],
                                                   xdfix[..., 0])):
        np.testing.assert_allclose(dfeat.numpy(), np.asarray(want_feat),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dfix.numpy(), np.asarray(want_fix),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------ kernel 6: shift correlation --
def _assert_bf16_sums(got, want):
    """Sums of bf16-rounded products: relative L2 error < 1e-2, and each
    entry within 2% of the largest."""
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 1e-2, rel_l2
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=0.02 * np.abs(want).max())



@pytest.mark.parametrize("R,dt", [(2, F32), (3, BF16)])
def test_shift_correlation_plain_matches_pallas_and_xla(R, dt,
                                                        pallas_interpret):
    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    r = np.random.RandomState(4)
    lo, S = _window(R)
    G = torch.from_numpy(r.normal(size=(T, B, H, W)).astype(np.float32)).to(
        dt)
    X = torch.from_numpy(r.normal(size=(T, B, H, W)).astype(np.float32)).to(
        dt)
    got = tmk.shift_correlation(G, X, S, lo)
    assert got.dtype == F32 and got.shape == (B, S * S, H, W)
    jG = jnp.asarray(G.float().numpy()).astype(JDT[dt])
    jX = jnp.asarray(X.float().numpy()).astype(JDT[dt])
    pallas = mk.shift_correlation(jG, jX, S, lo)
    mk._FORCE_PALLAS = False
    xla = mk.shift_correlation(jG, jX, S, lo)
    for want in (pallas, xla):
        if dt == BF16:  # JAX rounds each product to bf16, the port not
            _assert_bf16_sums(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


def _assert_within_bf16_ulp(got, want, atol):
    """|got - want| <= one bf16 ulp of want (2^-7 of the power of two at or
    below |want|) + atol."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    bad = np.abs(got - want) > ulp + atol
    assert not bad.any(), (got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("R,dt", [(2, F32), (3, BF16)])
def test_shift_correlation_plain_bf16_out_matches_pallas_and_xla(
        R, dt, pallas_interpret):
    """dM stored in bf16 (the JAX function's ``out_dtype``), as the bf16
    train step stores it."""
    import rdfc_gan_tpu.ops.pallas.mask_kernel as mk

    r = np.random.RandomState(14)
    lo, S = _window(R)
    G = torch.from_numpy(r.normal(size=(T, B, H, W)).astype(np.float32)).to(
        dt)
    X = torch.from_numpy(r.normal(size=(T, B, H, W)).astype(np.float32)).to(
        dt)
    got = tmk.shift_correlation(G, X, S, lo, BF16)
    assert got.dtype == BF16 and got.shape == (B, S * S, H, W)
    jG = jnp.asarray(G.float().numpy()).astype(JDT[dt])
    jX = jnp.asarray(X.float().numpy()).astype(JDT[dt])
    pallas = mk.shift_correlation(jG, jX, S, lo, out_dtype=jnp.bfloat16)
    mk._FORCE_PALLAS = False
    xla = mk.shift_correlation(jG, jX, S, lo, out_dtype=jnp.bfloat16)
    for want in (pallas, xla):
        assert want.dtype == jnp.bfloat16
        if dt == BF16:  # JAX rounds each product to bf16, the port not
            _assert_bf16_sums(_np(got), _np(want))
        else:
            _assert_within_bf16_ulp(_np(got), _np(want), atol=1e-5)


# ------------------------------------------------ the Functions' grads --
def _cotangent(seed):
    return np.random.RandomState(seed).normal(size=(B, 1, H, W)).astype(
        np.float32)


def _torch_grads(fn, feat, M, fix, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (feat, M, fix)]
    out = fn(*leaves)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def _jax_grads(fn, feat, M, fix, cot):
    def loss(a, m, fx):
        out = fn(a, m, fx)
        return jnp.sum(out.astype(jnp.float32) * _nhwc(cot)), out

    (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                     has_aux=True)(_nhwc(feat),
                                                   jnp.asarray(M), _nhwc(fix))
    return out, g


def _assert_grads(got_out, got_g, want_out, want_g, tol):
    np.testing.assert_allclose(got_out.numpy()[:, 0],
                               np.asarray(want_out)[..., 0], **tol)
    np.testing.assert_allclose(got_g[0].numpy()[:, 0],
                               np.asarray(want_g[0])[..., 0], **tol,
                               err_msg="feat")
    np.testing.assert_allclose(got_g[1].float().numpy(),
                               _np(want_g[1]), **tol, err_msg="M")
    if got_g[2] is None:  # no gradient reaches fix: None here, zeros in JAX
        assert not np.asarray(want_g[2]).any()
        return
    np.testing.assert_allclose(got_g[2].numpy()[:, 0],
                               np.asarray(want_g[2])[..., 0], **tol,
                               err_msg="fix")


@pytest.mark.parametrize("R,preserve", [(2, False), (2, True), (3, True)])
def test_stencil_propagate_grads_match_jax(R, preserve):
    """The plain Function (the CPU path, unrounded M) against jax.grad of
    the JAX stencil_propagate and its two-phase custom VJP."""
    feat0, M16, fix = _chain_inputs(5, R)
    feat, M, fx = (feat0.numpy()[:, None], M16.float().numpy(),
                   fix.numpy()[:, None])
    cot = _cotangent(6)
    got_out, got_g = _torch_grads(
        lambda a, m, f: tst.stencil_propagate(a, m, T, R, f, preserve),
        feat, M, fx, cot)
    want_out, want_g = _jax_grads(
        lambda a, m, f: jst.stencil_propagate(a, m, T, R, feat_fix=f,
                                              preserve_input=preserve),
        feat, M, fx, cot)
    assert (got_g[2] is None) == (not preserve)
    _assert_grads(got_out, got_g, want_out, want_g,
                  dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("dt,preserve", [(F32, False), (BF16, True)])
def test_card_function_plain_twin_matches_pallas_grad(dt, preserve,
                                                      pallas_interpret):
    """The card's Function, run on the CPU with the plain versions of
    kernels 4, 5 and 6, against jax.grad of nlspn_stencil_propagate_pallas
    with every Pallas kernel in interpret mode. The stacks are f32 for an
    f32 M and bf16 for a bf16 M on both sides."""
    import rdfc_gan_tpu.ops.pallas.nlspn_kernel as nk

    R = 2
    feat0, M16, fix = _chain_inputs(7, R)
    feat, fx = feat0.numpy()[:, None], fix.numpy()[:, None]
    cot = _cotangent(8)
    leaves = [torch.from_numpy(feat).requires_grad_(True),
              M16.to(dt, copy=True).requires_grad_(True),
              torch.from_numpy(fx).requires_grad_(True)]
    out = tnk.nlspn_stencil_propagate(leaves[0], leaves[1], leaves[2], T, R,
                                      preserve)
    (out * torch.from_numpy(cot)).sum().backward()
    assert leaves[1].grad.dtype == dt
    jM = jnp.asarray(M16.float().numpy()).astype(JDT[dt])

    def loss(a, m, f):
        o = nk.nlspn_stencil_propagate_pallas(a, m, f, T, R, preserve)
        return jnp.sum(o * _nhwc(cot)), o

    (_, want_out), want_g = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(_nhwc(feat), jM, _nhwc(fx))
    got_g = [t.grad for t in leaves]
    if dt == F32:
        _assert_grads(out.detach(), got_g, want_out, want_g,
                      dict(rtol=1e-4, atol=1e-5))
        return
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy()[:, 0],
                               np.asarray(want_out)[..., 0], **tol)
    np.testing.assert_allclose(got_g[0].numpy()[:, 0],
                               np.asarray(want_g[0])[..., 0], **tol)
    np.testing.assert_allclose(got_g[2].numpy()[:, 0],
                               np.asarray(want_g[2])[..., 0], **tol)
    _assert_bf16_sums(got_g[1].float().numpy(), _np(want_g[1]))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_card_function_twin_correlates_into_M_dtype(dt, monkeypatch):
    """The card Function's backward asks the correlation for dM in M's
    type, so a bf16 step casts no dM: on the CPU twin the correlation's own
    result is already bf16 (f32 for an f32 M) and is M's gradient."""
    seen = []

    def spy(G, X, S, lo, out_dtype=F32):
        dM = tmk.shift_correlation_plain(G, X, S, lo, out_dtype)
        seen.append(dM)
        return dM

    monkeypatch.setattr(tmk, "shift_correlation", spy)
    R = 2
    feat0, M16, fix = _chain_inputs(12, R)
    M = M16.to(dt, copy=True).requires_grad_(True)
    out = tnk.nlspn_stencil_propagate(feat0[:, None], M, fix[:, None], T, R,
                                      True)
    (out * torch.from_numpy(_cotangent(13))).sum().backward()
    assert len(seen) == 1 and seen[0].dtype == dt
    assert M.grad.dtype == dt
    assert torch.equal(M.grad, seen[0].reshape(M.shape))


# a sweep of planes (odd ones, W not a multiple of the run, planes smaller
# than a tile) and the correlation kernel's windows
CORR_PLAN_SHAPES = [(b, h, w, S) for b in (1, 3) for h in (1, 7, 8, 17, 224)
                    for w in (1, 5, 31, 33, 304) for S in (4, 6, 8, 10, 12)]


@pytest.mark.parametrize("B_,H_,W_,S", CORR_PLAN_SHAPES[::7] + [
    (4, 224, 304, 8), (2, 17, 23, 12), (1, 5, 7, 4)])
def test_corr_plan_covers_every_output_once(B_, H_, W_, S):
    """The correlation kernel's cut (``corr_plan``, the mirror of the
    kernel's export, which the card check holds against it): walking its
    blocks and threads as the kernel does, every output (b, shift, h, w)
    is written by one thread, and nothing outside the plane."""
    p = tmk.corr_plan(B_, H_, W_, S)
    runs_row = p.tile_w // p.run
    assert p.threads == runs_row * p.tile_h * (S // p.rows)
    assert p.threads % 32 == 0 and p.threads <= 1024
    assert S % p.rows == 0 and p.grid_b == B_
    tid = np.arange(p.threads)
    wl = tid % runs_row * p.run
    hl = tid // runs_row % p.tile_h
    iy0 = tid // (runs_row * p.tile_h) * p.rows
    seen = np.zeros((B_, S * S, H_, W_), np.int32)
    for by in range(p.grid_h):
        for bx in range(p.grid_w):
            h = by * p.tile_h + hl
            w = bx * p.tile_w + wl
            keep = (h < H_) & (w < W_)
            for j in range(p.rows):
                for ix in range(S):
                    s = (iy0 + j) * S + ix
                    for k in range(p.run):
                        ok = keep & (w + k < W_)
                        seen[:, s[ok], h[ok], w[ok] + k] += 1
    assert (seen == 1).all()


def test_corr_plan_refuses_other_windows():
    with pytest.raises(ValueError, match=r"\(4, 6, 8, 10, 12\)"):
        tmk.corr_plan(1, 8, 8, 14)
    with pytest.raises(ValueError):
        tmk.corr_plan(0, 8, 8, 8)


@pytest.mark.parametrize("R", [2, 3])
def test_build_shift_masks_grads_match_jax(R):
    """Gradients of the mask build in the offsets and the affinities: the
    scatter's backward is the gather."""
    r = np.random.RandomState(9)
    num = 8
    raw = np.zeros((B, 3 * num, H, W), np.float32)
    raw[:, :2 * num] = r.uniform(-R / 1.25, R / 1.25, (B, 2 * num, H, W))
    raw[:, 2 * num:] = r.normal(size=(B, num, H, W))
    spec = tn.NLSPNParamsSpec(prop_time=T)
    off, aff = tn.nlspn_offset_affinity(torch.from_numpy(raw), None,
                                        torch.tensor(4.0),
                                        spec._replace(conf_prop=False))
    off = off.detach().requires_grad_(True)
    aff = aff.detach().requires_grad_(True)
    lo, S = _window(R)
    cot = r.normal(size=(B, S, S, H, W)).astype(np.float32)
    (tst.build_shift_masks(off, aff, 3, R)
     * torch.from_numpy(cot)).sum().backward()

    joff = jnp.asarray(off.detach().numpy().transpose(0, 3, 4, 1, 2))
    jaff = jnp.asarray(aff.detach().numpy().transpose(0, 2, 3, 1))
    gj_off, gj_aff = jax.grad(
        lambda o, a: jnp.sum(jst.build_shift_masks(o, a, 3, R) * cot),
        argnums=(0, 1))(joff, jaff)
    assert float(off.grad.abs().max()) > 0
    np.testing.assert_allclose(off.grad.numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(gj_off), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aff.grad.numpy().transpose(0, 2, 3, 1),
                               np.asarray(gj_aff), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- on the card --
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("S,shape", [(8, (4, 36, 56, 76)),
                                     (10, (2, 36, 17, 23)),
                                     (8, (3, 36, 5, 7))])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_gather_kernel_matches_plain_on_card(dt, S, shape):
    """Bit for bit, out-of-range indices included (they give 0); the
    vector path (HW a multiple of 8) and the scalar one (odd HW)."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    dM = torch.randn((shape[0], S * S) + shape[2:], device="cuda",
                     generator=g).to(dt)
    sy = torch.randint(-1, S + 1, shape, device="cuda", generator=g,
                       dtype=torch.int32)
    sx = torch.randint(-1, S + 1, shape, device="cuda", generator=g,
                       dtype=torch.int32)
    for out_dt in (F32, BF16):
        got = tmk.shift_mask_gather(dM, sy, sx, S, out_dt)
        want = tmk.shift_mask_gather_plain(dM, sy, sx, S, out_dt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("R,preserve,dt", [(2, False, F32), (2, True, BF16),
                                           (3, True, F32)])
def test_backward_chain_kernels_match_plain_on_card(R, preserve, dt):
    _card()
    feat0, M16, fix = _chain_inputs(10, R)
    feat0, M16, fix = feat0.cuda(), M16.cuda(), fix.cuda()
    fx = fix if preserve else None
    out, X = tnk.propagate_x(feat0, M16, fx, 18, R, dt)
    pout, pX = tst.propagate_x_plain(feat0, M16, fx, 18, R, dt)
    G, dfeat, dfix = tnk.reverse_chain(feat0, M16, fx, 18, R, dt)
    pG, pdfeat, pdfix = tst.reverse_chain_plain(feat0, M16, fx, 18, R, dt)
    lo, S = _window(R)
    dM = tmk.shift_correlation(G, X, S, lo)
    pdM = tmk.shift_correlation_plain(pG, pX, S, lo)
    torch.cuda.synchronize()
    for a, b in ((out, pout), (X, pX), (G, pG), (dfeat, pdfeat),
                 (dfix, pdfix), (dM, pdM)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (S, (T, B, H, W)): the train step's plane; an odd plane (staged value by
# value, scalar stores); W a multiple of 4 but not of 8 (f32 stacks copied
# 16 bytes at a time, bf16 ones value by value); W even but not a multiple
# of 4; planes smaller than one tile, W a multiple of 8 (copied) or odd; a
# tall plane; H not a multiple of the tile's 8 rows, W of its 32 columns
CORR_CASES = [(8, (18, 4, 224, 304)), (4, (3, 2, 17, 23)),
              (10, (5, 1, 9, 36)), (12, (4, 3, 30, 46)),
              (4, (2, 2, 5, 16)), (12, (2, 1, 5, 7)), (8, (6, 1, 300, 20)),
              (10, (3, 1, 13, 40))]


@pytest.mark.gpu
@pytest.mark.parametrize("S,shape", CORR_CASES)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_correlation_kernel_matches_plain_on_card(S, shape, dt):
    """Bit for bit, dM in f32 and in bf16; one launch a call."""
    _card()
    from rdfc_gan_torch.ops.kernels import build

    lo = 1 - S // 2
    g = torch.Generator(device="cuda").manual_seed(S)
    G = torch.randn(shape, device="cuda", generator=g).to(dt)
    X = torch.randn(shape, device="cuda", generator=g).to(dt)
    build.reset_launches()
    for out_dt in (F32, BF16):
        got = tmk.shift_correlation(G, X, S, lo, out_dt)
        want = tmk.shift_correlation_plain(G, X, S, lo, out_dt)
        torch.cuda.synchronize()
        assert got.dtype == out_dt
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert build.LAUNCHES[tmk.CORR] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [F32, BF16])
def test_correlation_kernel_multiplies_out_of_image_zeros(dt):
    """A non-finite G at the border: the out-of-image X is a zero that is
    multiplied, so the shifts that leave the image give NaN, as the plain
    version's do."""
    _card()
    S, shape = 8, (3, 2, 17, 22)
    g = torch.Generator(device="cuda").manual_seed(1)
    G = torch.randn(shape, device="cuda", generator=g).to(dt)
    X = torch.randn(shape, device="cuda", generator=g).to(dt)
    G[1, 0, 0, 0] = float("inf")
    G[2, 1, -1, -1] = float("nan")
    for out_dt in (F32, BF16):
        got = tmk.shift_correlation(G, X, S, 1 - S // 2, out_dt)
        want = tmk.shift_correlation_plain(G, X, S, 1 - S // 2, out_dt)
        torch.cuda.synchronize()
        assert torch.isnan(want).any()
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)


# (R, T, (B, H, W), preserve): one step; an odd plane (no vector store;
# rows end inside a run); S=10 and S=12 with preserve; and three planes
# whose runs overflow a block's shared memory on an H100 (227 KB a block,
# 132 blocks), so the rest of the pre-shifted stack is read back from the
# scratch stack every step: the train step's 4x224x304 at S=8 (208 of 258
# runs a block resident) and S=10 (131 of 258), and a tall odd plane,
# 1x4000x61 at S=8 (214 of 243); 16x352x1216 at S=8, whose blocks take
# their rows in two bands of 40 a step (the rows of 6486 runs and their
# halo pass a block's 227 KB; none of its runs is resident); and
# 1x16x8000, whose rows and halo alone pass it, so a block takes a row in
# chunks of 906 runs
CHAIN_CASES = [(2, 1, (2, 8, 9), False), (2, 5, (2, 17, 23), True),
               (2, 18, (4, 224, 304), False), (3, 6, (4, 224, 304), True),
               (4, 3, (1, 17, 23), True), (1, 4, (3, 9, 16), False),
               (2, 4, (1, 4000, 61), True), (2, 2, (16, 352, 1216), True),
               (2, 3, (1, 16, 8000), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,T_,shape,preserve", CHAIN_CASES)
@pytest.mark.parametrize("dt", [F32, BF16])
def test_reverse_chain_kernel_matches_plain_on_card(R, T_, shape, preserve,
                                                    dt):
    """Bit for bit: G, dfeat and dfix of the one-launch chain against
    ``reverse_chain_plain``, f32 and bf16 G."""
    _card()
    _, S = _window(R)
    r = np.random.RandomState(20 + R)
    g0 = torch.from_numpy(r.normal(size=shape).astype(np.float32)).cuda()
    M16 = torch.from_numpy((r.normal(size=(shape[0], S, S) + shape[1:])
                            * 0.2).astype(np.float32)).to(BF16).cuda()
    fix = torch.from_numpy((np.abs(r.normal(size=shape))
                            * (r.random_sample(shape) > 0.4)).astype(
        np.float32)).cuda() if preserve else None
    got = tnk.reverse_chain(g0, M16, fix, T_, R, dt)
    want = tst.reverse_chain_plain(g0, M16, fix, T_, R, dt)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
