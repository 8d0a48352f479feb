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
from rdfc_gan_torch.ops.kernels import build
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


# ------------------------------------------- the forward chains' kernel --
# (R, T, (B, H, W), preserve): one step; an odd plane (scalar stores, M's
# rows padded); S=10 and S=12 with preserve; R=0 and R=1; the served
# 4x224x304 at S=8 (208 of a block's 258 runs resident on an H100) and at
# S=10 (131 of 258); a tall odd plane; 16x352x1216 at S=8, whose blocks
# take their runs in two bands of rows a step (the rows of 6486 runs and
# their halo pass a block's 227 KB); and 1x16x8000, whose rows and halo
# alone pass it, so a block takes a row in chunks of 906 runs
FORWARD_CASES = [(2, 1, (2, 8, 9), False), (2, 5, (2, 17, 23), True),
                 (3, 4, (1, 17, 23), True), (4, 3, (1, 17, 23), True),
                 (0, 3, (2, 30, 44), True), (1, 4, (3, 9, 16), False),
                 (2, 18, (4, 224, 304), False), (3, 6, (4, 224, 304), True),
                 (2, 4, (1, 4000, 61), True),
                 (2, 2, (16, 352, 1216), True), (2, 3, (1, 16, 8000), True)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,T_,shape,preserve", FORWARD_CASES)
def test_forward_chain_kernels_match_plain_on_card(R, T_, shape, preserve):
    """Bit for bit: the served chain against ``stencil_propagate``, and the
    chain that stores X against ``propagate_x_plain`` with X in f32 and
    bf16, each one cooperative launch a chain."""
    _card()
    S = 2 * R + 4
    r = np.random.RandomState(30 + R)
    feat = torch.from_numpy(r.normal(size=shape).astype(np.float32)).cuda()
    M16 = torch.from_numpy((r.normal(size=(shape[0], S, S) + shape[1:])
                            * 0.2).astype(np.float32)).to(
        torch.bfloat16).cuda()
    fix = torch.from_numpy((np.abs(r.normal(size=shape))
                            * (r.random_sample(shape) > 0.4)).astype(
        np.float32)).cuda() if preserve else None
    fix4 = None if fix is None else fix[:, None]
    build.reset_launches()
    got = tnk.nlspn_stencil_propagate(feat[:, None], M16, fix4, T_, R,
                                      preserve)
    want = tst.stencil_propagate(feat[:, None], M16, T_, R, fix4, preserve)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for dt in (torch.float32, torch.bfloat16):
        out, X = tnk.propagate_x(feat, M16, fix, T_, R, dt)
        pout, pX = tst.propagate_x_plain(feat, M16, fix, T_, R, dt)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, pout, rtol=0, atol=0)
        torch.testing.assert_close(X, pX, rtol=0, atol=0)
    assert dict(build.LAUNCHES) == {tnk.NAME: 1, tnk.NAME_X: 2}


# an H100 SXM: 132 SMs, 227 KB of shared memory a block
H100_SMS, H100_SMEM = 132, 232448
# (B, H, W, S): the planes of FORWARD_CASES
PLAN_SHAPES = sorted({(s[0], s[1], s[2], 2 * R + 4)
                      for R, _, s, _ in FORWARD_CASES})
# a sweep of batches, heights, widths (odd ones, and widths whose row and
# halo alone pass a block's shared memory, which the plan cuts into chunks
# of runs) and windows
PLAN_SWEEP = [(b, h, w, S) for b in (1, 4, 16)
              for h in (1, 7, 224, 352, 1000)
              for w in (1, 9, 61, 304, 1216, 4000, 9000) for S in (4, 8, 12)]


def _bands(p, Rr, runs, block):
    """The bands of ``block`` in the order the kernel takes them
    (nlspn_propagate.cu:propagate_chain_kernel): (first run, end run,
    first row, end row, first run of the row chunk)."""
    r0 = block * p.rpb
    r1 = min(r0 + p.rpb, runs)
    for ra in range(r0 // Rr, (r1 - 1) // Rr + 1, p.band_rows):
        rb = min(ra + p.band_rows, (r1 - 1) // Rr + 1)
        for ca in range(0, Rr, p.band_runs):
            nc = min(p.band_runs, Rr - ca)
            fa, fb = max(r0, ra * Rr + ca), min(r1, (rb - 1) * Rr + ca + nc)
            if fa < fb:
                yield fa, fb, ra, rb, ca


def _check_chain_plan(B_, H_, W_, S, reverse=False):
    """The chains' plan on an H100: every run is owned by one block and lies
    in one band of it; a band's rows and halo and the resident runs' masks
    fit in a block's shared memory; no plane is refused. Each run's window
    (rows h + lo .. h + hi and columns w + lo .. w + 7 + hi of the forward
    chains; the reverse chain reads the transpose, h - hi .. h - lo and
    w - hi .. w + 7 - lo) lies in the band's staged tile: rows ra + lo ..
    rb - 1 + hi (forward) or ra - hi .. rb - 1 - lo (reverse), columns
    from LEFT before the band's first run on."""
    p = tnk.chain_plan(B_, H_, W_, S, H100_SMS, H100_SMEM)
    lo, hi = 1 - S // 2, S // 2
    if reverse:
        lo, hi = -hi, -lo
    Rr = -(-W_ // tnk.RUN)
    runs = B_ * H_ * Rr
    assert 1 <= p.blocks <= H100_SMS
    assert p.threads % 32 == 0 and 32 <= p.threads <= tnk.MAX_THREADS
    assert (p.blocks - 1) * p.rpb < runs <= p.blocks * p.rpb
    assert 0 <= p.nres <= p.rpb
    assert p.band_rows >= 1 and 1 <= p.band_runs <= Rr
    assert p.band_runs == Rr or p.band_rows == 1  # a band's runs: one range
    tile = (p.band_rows + S - 1) * (
        tnk.LEFT + p.band_runs * tnk.RUN + tnk.RIGHT) * 4
    assert p.smem == tile + p.nres * S * S * 16 <= H100_SMEM
    seen = np.zeros(runs, np.int32)
    for block in range(p.blocks):
        for fa, fb, ra, rb, ca in _bands(p, Rr, runs, block):
            assert rb - ra <= p.band_rows
            for r in (fa, fb - 1):  # a band's runs lie in its rows and chunk
                assert ra <= r // Rr < rb
                assert ca <= r % Rr < ca + p.band_runs
            # the band's tile: rows and image columns staged
            t_rows = (ra + lo, rb - 1 + hi)
            t_cols = (ca * tnk.RUN - tnk.LEFT,
                      ca * tnk.RUN - tnk.LEFT + tnk.LEFT
                      + p.band_runs * tnk.RUN + tnk.RIGHT - 1)
            for r in (fa, fb - 1):
                gr, w0 = r // Rr, r % Rr * tnk.RUN
                assert t_rows[0] <= gr + lo and gr + hi <= t_rows[1]
                assert t_cols[0] <= w0 + lo
                assert w0 + tnk.RUN - 1 + hi <= t_cols[1]
            seen[fa:fb] += 1
    assert (seen == 1).all()
    return p


@pytest.mark.parametrize("B_,H_,W_,S", PLAN_SHAPES)
def test_chain_plan_covers_every_run_once(B_, H_, W_, S):
    """The plan (the mirror of the kernel's, which the card check holds
    against the kernel's export) at the card tests' planes; the served
    4x224x304 keeps 208 of a block's 258 runs resident, 16x352x1216 takes
    two bands of rows."""
    p = _check_chain_plan(B_, H_, W_, S)
    if (B_, H_, W_, S) == (4, 224, 304, 8):
        assert (p.rpb, p.nres, p.band_rows) == (258, 208, 8)
    if (B_, H_, W_) == (16, 352, 1216):
        assert p.band_runs == 152 and p.band_rows == 40 and p.nres == 0


def test_chain_plan_sweep_refuses_no_plane():
    """The plan's invariants over a sweep of 315 planes and windows, the
    widest cut into chunks of runs."""
    chunked = 0
    for shape in PLAN_SWEEP:
        p = _check_chain_plan(*shape)
        chunked += p.band_runs < -(-shape[2] // tnk.RUN)
    assert chunked > 0


# (B, H, W, S): the planes of the reverse chain's card tests
# (tests/test_torch_nlspn_backward.py CHAIN_CASES)
REVERSE_PLAN_SHAPES = [(2, 8, 9, 8), (2, 17, 23, 8), (4, 224, 304, 8),
                       (4, 224, 304, 10), (1, 17, 23, 12), (3, 9, 16, 6),
                       (1, 4000, 61, 8), (16, 352, 1216, 8),
                       (1, 16, 8000, 8)]


@pytest.mark.parametrize("B_,H_,W_,S", REVERSE_PLAN_SHAPES)
def test_reverse_chain_plan_covers_every_run_once(B_, H_, W_, S):
    """The same plan as the reverse chain takes it (its halo above a row):
    at the train step's 4x224x304, S=8, whole rows, 208 of a block's 258
    runs resident, as the kernel took them before it took bands; at
    16x352x1216 two bands of 40 rows, none resident."""
    p = _check_chain_plan(B_, H_, W_, S, reverse=True)
    if (B_, H_, W_, S) == (4, 224, 304, 8):
        assert (p.rpb, p.nres, p.band_rows, p.band_runs) == (258, 208, 8, 38)
    if (B_, H_, W_) == (16, 352, 1216):
        assert p.band_runs == 152 and p.band_rows == 40 and p.nres == 0
    if (B_, H_, W_) == (1, 16, 8000):
        assert p.band_rows == 1 and p.band_runs == 906


def test_reverse_chain_plan_sweep_refuses_no_plane():
    """The reverse chain's plan over the sweep of 315 planes and windows,
    16x352x1216 among them, the widest cut into chunks of runs."""
    chunked = 0
    for shape in PLAN_SWEEP:
        p = _check_chain_plan(*shape, reverse=True)
        chunked += p.band_runs < -(-shape[2] // tnk.RUN)
    assert (16, 352, 1216, 8) in PLAN_SWEEP and chunked > 0


def test_chain_kernels_refuse_other_windows(monkeypatch):
    """The chain kernels are built for S = 4..12 (R = 0..4): another window
    raises ValueError naming them, before any launch (meta tensors, the
    library faked)."""
    monkeypatch.setattr(build, "library", lambda name: None)
    monkeypatch.setattr(build, "require_cuda", lambda name, *t: None)
    B_, H_, W_, R = 1, 5, 6, 5
    S = 2 * R + 4
    plane = torch.empty((B_, H_, W_), device="meta")
    M16 = torch.empty((B_, S, S, H_, W_), dtype=torch.bfloat16, device="meta")
    for call in (
            lambda: tnk.propagate_x(plane, M16, None, 3, R, torch.float32),
            lambda: tnk.reverse_chain(plane, M16, None, 3, R, torch.float32),
            lambda: tnk.nlspn_stencil_propagate(plane[:, None], M16, None, 3,
                                                R, False)):
        with pytest.raises(ValueError, match=r"\(4, 6, 8, 10, 12\)"):
            call()
