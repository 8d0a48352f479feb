"""The bf16 tensor-core conv-block kernels (``csrc/conv3x3_bf16.cu``): what
their wrappers hand them, and the tolerance they are held to.

CPU:

* ``pack_bf16``, the K-major weight layout the wrapper packs once a call,
  unpacks to ``w.to(bf16)`` exactly, with zeros past C, for Co != C and C
  not a multiple of the 32-channel chunk.
* ``wgrad_splits`` covers every pixel tile once, no split empty.
* The tolerance helpers accept an f32-accumulated conv of bf16 values
  (``F.conv2d`` and its weight gradient in f32 on the CPU: another
  summation order than the plain f64 sums) and reject a y moved by 2 bf16
  ulps, a dW or BN sum moved past 2^-12 of its absolute sum, and moments
  moved past f64 rounding. Where a conv output cancels, the f32 sum's own
  rounding is allowed on top of the ulp, and no more.

``gpu``-marked (skip without a card): the bf16 kernels against their
plain versions at ragged shapes, Co != C among them, within the stated
tolerance, and which launch counter each dtype moves.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rdfc_gan_torch.ops.kernels import build
from rdfc_gan_torch.ops.kernels import conv_block_kernel as ck

# one intra-op thread per Tier-1 worker (see tests/test_torch_fused_block.py)
torch.set_num_threads(1)

BF = torch.bfloat16


def _r(shape, seed, scale=1.0, shift=0.0):
    r = np.random.RandomState(seed)
    return torch.from_numpy((r.normal(size=shape) * scale + shift)
                            .astype(np.float32))


@pytest.mark.parametrize("Co,C", [(40, 24), (24, 40), (8, 70), (64, 64)])
def test_pack_unpacks_to_the_bf16_weights(Co, C):
    w = _r((Co, C, 3, 3), 0)
    wk = ck.pack_bf16(w)
    assert wk.dtype == BF and wk.shape == (9, Co, -(-C // ck.CHUNK) * ck.CHUNK)
    # unpacked: (9, Co, Cp) -> (Co, C, 3, 3)
    unpacked = wk[:, :, :C].reshape(3, 3, Co, C).permute(2, 3, 0, 1)
    assert torch.equal(unpacked, w.to(BF))
    assert not wk[:, :, C:].any()
    # K-major: tap kh * 3 + kw, then co, then ci
    assert torch.equal(wk[1 * 3 + 2, Co - 1, C - 1], w[Co - 1, C - 1, 1,
                                                         2].to(BF))


@pytest.mark.parametrize("shape", [(4, 64, 64, 224, 304),
                                   (4, 512, 512, 28, 38),
                                   (2, 16, 16, 20, 37), (1, 24, 40, 9, 70),
                                   (3, 200, 8, 5, 5)])
def test_wgrad_splits_cover_every_pixel_tile(shape):
    B, C, Co, H, W = shape
    splits, per = ck.wgrad_splits(B, C, Co, H, W)
    pt = B * ck.tiles(H, W, ck.WGRAD_TILE_H, ck.WGRAD_TILE_W)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < pt <= splits * per
    blocks = splits * -(-Co // ck.BLOCK_N) * -(-C // ck.WGRAD_CI)
    # near the target: one split, or fewer than twice the target's blocks
    assert splits == 1 or blocks < 2 * ck.WGRAD_BLOCKS


def _inputs(seed, B=2, C=12, Co=10, H=9, W=13):
    u = _r((B, C, H, W), seed, 1.5, 0.2).to(BF)
    w = _r((Co, C, 3, 3), seed + 1, (2.0 / (9 * C)) ** 0.5)
    a, b = _r((C,), seed + 2, 0.3, 1.0), _r((C,), seed + 3, 0.3)
    return u, w, a, b


def _f32_fwd(u, w, a, b, act):
    """The forward with its conv summed in f32 by F.conv2d: the kernels'
    function, its sums in another order."""
    z = ck._prologue(u, a, b, act)
    y = F.conv2d(z.float(), w.to(BF).float(), padding=1).to(BF)
    return y, ck._moments(y)


@pytest.mark.parametrize("act", ["none", "relu"])
def test_tolerance_accepts_an_f32_accumulated_conv(act):
    u, w, a, b = _inputs(10)
    args = (None, None, "none") if act == "none" else (a, b, "relu")
    got = _f32_fwd(u, w, *args)
    rows = ck.check_fwd_bf16(got, u, w, *args)
    assert ck.within(rows), rows
    ulps, share, raw = ck.ulp_error(got[0],
                                    ck.conv3x3_fwd_plain(u, w, *args)[0])
    assert ulps <= ck.Y_ULPS and raw <= 1 and share < 0.05
    # the weight gradient in f32 against _seq_wgrad's f64 sums
    z = ck._prologue(u, *args)
    dy = _r((2, 10, 9, 13), 15).to(BF)
    dw = torch.nn.grad.conv2d_weight(z.float(), (10, 12, 3, 3), dy.float(),
                                     padding=1)
    err = ck.sum_error(dw, ck._seq_wgrad(z, dy), ck.abs_wgrad(z, dy))
    assert err <= ck.SUM_RTOL, err
    assert err > 0  # another order: not bit-equal, yet inside


def _bwd_kwargs(seed, C=12, Co=10):
    return dict(y=_r((2, Co, 9, 13), seed, 2.0, 0.5).to(BF),
                fin=torch.stack([_r((Co,), seed + 1, 0.3, 1.0),
                                 _r((Co,), seed + 2, 0.1),
                                 _r((Co,), seed + 3, 0.1),
                                 _r((Co,), seed + 4, 0.3),
                                 _r((Co,), seed + 5, 0.1, 0.8)]),
                xh=(_r((C,), seed + 6, 0.3), _r((C,), seed + 7, 0.1, 0.8)))


def test_tolerance_accepts_the_plain_backward_and_an_f32_one():
    u, w, a, b = _inputs(20)
    g = _r((2, 10, 9, 13), 21).to(BF)
    kw = dict(a=a, b=b, act="relu", **_bwd_kwargs(22))
    plain = ck.conv3x3_bwd_plain(g, u, w, **kw)
    rows = ck.check_bwd_bf16(plain, g, u, w, **kw)
    assert [r[0] for r in rows] == ["gout", "dW", "sums"]
    assert all(r[1] == 0 for r in rows), rows
    # dW summed in f32 by torch: inside the bound
    p = ck._bwd_parts(g, u, w, **kw)
    dw = torch.nn.grad.conv2d_weight(ck._prologue(u, a, b, "relu").float(),
                                     (10, 12, 3, 3), p["dy"].float(),
                                     padding=1)
    rows = ck.check_bwd_bf16((plain[0], dw, plain[2]), g, u, w, **kw)
    assert ck.within(rows), rows


def _ulp(v):
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v.float()), e - 8)


def test_tolerance_rejects_a_y_two_ulps_off():
    u, w, a, b = _inputs(30)
    y, mom = ck.conv3x3_fwd_plain(u, w, a, b, "relu")
    assert ck.within(ck.check_fwd_bf16((y, mom), u, w, a, b, "relu"))
    bad = y.clone()
    i = (0, 3, 4, 5)
    bad[i] = (y[i].float() + 2 * _ulp(y[i])).to(BF)
    rows = ck.check_fwd_bf16((bad, ck._moments(bad)), u, w, a, b, "relu")
    assert not ck.within(rows)
    assert 1.9 < rows[0][1] <= 2.0  # 2 ulps, less a small allowance
    one = y.clone()
    one[i] = (y[i].float() + _ulp(y[i])).to(BF)
    assert ck.within(ck.check_fwd_bf16((one, ck._moments(one)), u, w, a, b,
                                       "relu"))


def test_tolerance_allows_the_f32_rounding_where_a_sum_cancels():
    """An output near 0 from large terms: its f32 sum may be several of
    its own ulps off, within Y_SUM_RTOL of the sum over |terms|, and no
    further."""
    want = torch.tensor([2.0 ** -12, 1.0], dtype=BF)
    abs_sum = torch.tensor([4.0, 4.0])
    ulp0 = 2.0 ** -19
    allow = ck.Y_SUM_RTOL * abs_sum
    near = want.float() + torch.tensor([3 * ulp0, 0.0])
    assert 3 * ulp0 < float(allow[0])
    assert ck.ulp_error(near.to(BF), want, allow)[0] == 0.0
    assert ck.ulp_error(near.to(BF), want)[0] == 3.0
    far = want.float() + torch.tensor([float(allow[0]) + 2 * ulp0, 0.0])
    assert ck.ulp_error(far.to(BF), want, allow)[0] > ck.Y_ULPS
    # a non-cancelling output gets no visible slack: 2 ulps still fail
    two = want.float() + torch.tensor([0.0, 2 * 2.0 ** -7])
    assert ck.ulp_error(two.to(BF), want, allow)[0] > ck.Y_ULPS


def test_tolerance_rejects_moments_off_by_more_than_f64_rounding():
    u, w, a, b = _inputs(31)
    y, mom = ck.conv3x3_fwd_plain(u, w)
    bad = mom.clone()
    bad[1, 0, 2] += 1e-9 * float(y[1, 2].double().abs().sum())
    assert not ck.within(ck.check_fwd_bf16((y, bad), u, w))


@pytest.mark.parametrize("which", ["dW", "sums"])
def test_tolerance_rejects_sums_beyond_their_bound(which):
    u, w, a, b = _inputs(40)
    g = _r((2, 10, 9, 13), 41).to(BF)
    kw = dict(a=a, b=b, act="relu", **_bwd_kwargs(42))
    gout, dw, sums = ck.conv3x3_bwd_plain(g, u, w, **kw)
    p = ck._bwd_parts(g, u, w, **kw)
    if which == "dW":
        scale = ck.abs_wgrad(ck._prologue(u, a, b, "relu"), p["dy"])
        dw = dw.clone()
        dw[3, 4, 1, 2] += 2 * ck.SUM_RTOL * float(scale[3, 4, 1, 2])
    else:
        sums = sums.clone()
        sums[1, 0, 5] += 2 * ck.SUM_RTOL * float(
            p["gm"][1, 5].double().abs().sum())
    rows = dict((r[0], r) for r in ck.check_bwd_bf16((gout, dw, sums), g,
                                                      u, w, **kw))
    assert not ck.within(rows.values())
    assert 1.5 * ck.SUM_RTOL < rows[which][1] < 2.5 * ck.SUM_RTOL


# ------------------------------------------------------ kernels on a card --
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 16, 20, 37), (1, 24, 24, 9, 70),
                                   (2, 24, 40, 11, 40), (1, 72, 8, 6, 17)])
def test_bf16_kernels_match_plain_on_card(shape):
    _card()
    B, C, Co, H, W = shape
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*s, scale=1.0, shift=0.0):
        return torch.randn(s, device="cuda", generator=gen) * scale + shift

    u = rnd(B, C, H, W, scale=1.5, shift=0.2).to(BF)
    w = rnd(Co, C, 3, 3, scale=(2.0 / (9 * C)) ** 0.5)
    a, b = rnd(C, scale=0.3, shift=1.0), rnd(C, scale=0.3)
    for args in ((None, None, "none"), (a, b, "relu"), (a, b, "none")):
        got = ck.conv3x3_fwd(u, w, *args)
        assert got[0].dtype == BF and got[1].dtype == torch.float64
        rows = ck.check_fwd_bf16(got, u, w, *args)
        assert ck.within(rows), (args[2], rows)
    g, y = rnd(B, Co, H, W).to(BF), rnd(B, Co, H, W, scale=2.0).to(BF)
    cy = rnd(B, C, H, W).to(BF)
    fin = torch.stack([rnd(Co, scale=0.3, shift=1.0), rnd(Co, scale=0.1),
                       rnd(Co, scale=0.1), rnd(Co, scale=0.3),
                       rnd(Co, scale=0.1, shift=0.8)])
    xh = (rnd(C, scale=0.3), rnd(C, scale=0.1, shift=0.8))
    for kw in (dict(a=a, b=b, act="relu", y=y, fin=fin, xh=xh),
               dict(y=y, fin=fin, carry=cy), {}):
        got = ck.conv3x3_bwd(g, u, w, **kw)
        assert (got[2] is None) == ("xh" not in kw)
        rows = ck.check_bwd_bf16(got, g, u, w, **kw)
        assert ck.within(rows), (sorted(kw), rows)


@pytest.mark.gpu
@pytest.mark.parametrize("Co,C", [(40, 24), (64, 64)])
def test_weight_pack_matches_plain_on_card(Co, C):
    _card()
    w = torch.randn((Co, C, 3, 3), device="cuda")
    lib = build.library(ck.SOURCE_BF16)
    assert torch.equal(ck.pack_bf16_card(lib, w), ck.pack_bf16(w))
    assert torch.equal(ck.pack_bf16_card(lib, w, flip=True),
                       ck.pack_bf16(ck._flip(w)))


@pytest.mark.gpu
def test_each_dtype_counts_its_own_kernel_on_card():
    _card()
    u = torch.randn((1, 8, 5, 7), device="cuda")
    w = torch.randn((8, 8, 3, 3), device="cuda")
    for dt, (fwd, bwd) in ((BF, (ck.FWD, ck.BWD)),
                           (torch.float32, (ck.FWD_F32, ck.BWD_F32))):
        build.reset_launches()
        y, _ = ck.conv3x3_fwd(u.to(dt), w)
        ck.conv3x3_bwd(y, u.to(dt), w)
        assert dict(build.LAUNCHES) == {fwd: 1, bwd: 1}
