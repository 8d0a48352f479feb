"""Parity of the port's ESANet family with the JAX package, on the CPU: the
half-pixel bilinear resize against ``jax.image.resize`` (up and down, and
its gradient against ``jax.vjp``), ``LearnedUpsample`` in its four modes,
``NonBottleneck1D`` with every option, ``ResNetStem``, the SE gates, the
pyramid pooling module, ``ESANetOneModality`` with pyramid supervision on
and off and the two-modality ``ESANet``. The same numpy inputs go through
the Flax module and its port; the Flax trees are drawn from a numpy seed
(kernels N(0, 1 / fan_in), BatchNorm scales and variances in [0.5, 1.5),
every other leaf in [-0.2, 0.2)) and cross through
``utils.convert``.

Tolerances. Forwards in eval mode and of the single blocks: rtol 1e-3 /
atol 1e-4, as the other port parity tests. The resize: rtol 1e-5 / atol
1e-6 (the same f32 weights and sums; 4e-7 seen). Running statistics:
rtol 1e-4 / atol 1e-5, as ``tests/test_torch_train_step.py``. A whole
ESANet in train mode normalises its resnet18 torso's planes by batch
statistics of a few values (the 1/32 plane of a 64x64 input is 2x2), which
turns the f32 rounding of either side into relative errors of 1e-4 to
1e-3 at the outputs: JAX's own f32 result is that far from the same
function evaluated in f64. So a train-mode ESANet output is held to the
f64 JAX result: its relative L2 error at most three times JAX's own f32
error, or 2e-4 where JAX's is smaller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models import esanet as te
from rdfc_gan_torch.models.layers import NonBottleneck1D as TNB
from rdfc_gan_torch.models.layers import bilinear_resize
from rdfc_gan_torch.models.resnet import ResNetStem as TStem
from rdfc_gan_torch.utils import convert
from rdfc_gan_tpu.models import esanet as je
from rdfc_gan_tpu.models.layers import NonBottleneck1D as JNB
from rdfc_gan_tpu.models.resnet import ResNetStem as JStem

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

FWD = dict(rtol=1e-3, atol=1e-4)
STATS = dict(rtol=1e-4, atol=1e-5)
RESIZE = dict(rtol=1e-5, atol=1e-6)


def nhwc(a):
    return jnp.asarray(np.asarray(a).transpose(0, 2, 3, 1))


def nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def init_tree(module, *args, seed=0, **kw):
    """The Flax variables of ``module.init(*args, **kw)`` drawn from a numpy
    seed instead (no initialiser is traced)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    r = np.random.RandomState(seed)

    def fill(path, a):
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith("['kernel']"):
            fan_in = int(np.prod(a.shape[:-1]))
            return (r.normal(size=a.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if leaf.endswith("['weight']"):  # EqualLinear, rescaled at call
            return r.normal(size=a.shape).astype(np.float32)
        lo, hi = ((0.5, 1.5) if leaf.endswith(("['scale']", "['var']"))
                  else (-0.2, 0.2))
        return r.uniform(lo, hi, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def jax_apply(module, v, *args, train=True, f64=False, **kw):
    """(output, updated batch_stats or None) of a Flax module, jitted; with
    ``f64`` every leaf and input in float64."""
    def f(v, *a):
        if train:
            out, mut = module.apply(v, *a, train=True,
                                    mutable=["batch_stats"], **kw)
            return out, mut.get("batch_stats")
        return module.apply(v, *a, train=False, **kw), None

    if not f64:
        return jax.jit(f)(v, *args)
    with jax.enable_x64(True):
        cast = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        out = jax.jit(f)(cast(v), *cast(args))
        return jax.tree.map(np.asarray, out)


def load(module, sd, train):
    """``sd`` into ``module``, which may keep only its BatchNorms' batch
    counts and an RDFGenerator's ``fuse_layer5`` (never used; the JAX tree
    has none)."""
    missing, unexpected = module.load_state_dict(sd, strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith("num_batches_tracked") or "fuse_layer5." in k
               for k in missing), missing
    return module.train(train)


def rand(shape, seed):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def assert_running_stats(module, prefix_sd):
    for k, t in module.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), prefix_sd[k].numpy(),
                                       **STATS, err_msg=k)


def assert_train_close(got, want32, want64, what):
    """The train-mode rule of the module docstring."""
    got, want32 = np.asarray(got, np.float64), np.asarray(want32, np.float64)
    norm = np.linalg.norm(want64)
    err = np.linalg.norm(got - want64) / norm
    jax_err = np.linalg.norm(want32 - want64) / norm
    assert err <= max(3 * jax_err, 2e-4), (what, err, jax_err)


# ------------------------------------------------------------- resize --
RESIZES = [((1, 1), (8, 8)), ((5, 5), (8, 8)), ((8, 10), (15, 19)),
           ((15, 19), (29, 38)), ((57, 76), (29, 38)), ((29, 38), (8, 10)),
           ((12, 12), (12, 12)), ((9, 12), (9, 24))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_half_pixel_resize_matches_jax_image_resize(src, dst):
    """Up and down (antialiased), one axis only, and the same size (x comes
    back as it is); the gradient against JAX's vjp."""
    x = rand((2, 3) + src, 0)
    g = rand((2, 3) + dst, 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bilinear_resize(xt, dst)
    if src == dst:
        assert got is xt
        return
    got.backward(torch.from_numpy(g))

    def resize(z):
        return jax.image.resize(z, (2,) + dst + (3,), method="bilinear")

    want, vjp = jax.vjp(resize, nhwc(x))
    np.testing.assert_allclose(got.detach().numpy(), nchw(want), **RESIZE)
    np.testing.assert_allclose(xt.grad.numpy(), nchw(vjp(nhwc(g))[0]),
                               **RESIZE)


def test_half_pixel_resize_backward_repeats_bit_for_bit():
    """Two backward passes through a down- and an up-resize give the same
    bits (matrix products, no atomics)."""
    x = torch.from_numpy(rand((2, 16, 29, 38), 2))
    g = torch.from_numpy(rand((2, 16, 57, 76), 3))
    grads = []
    for _ in range(2):
        xt = x.clone().requires_grad_(True)
        bilinear_resize(bilinear_resize(xt, (15, 19)), (57, 76)).backward(g)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])


# --------------------------------------------------- LearnedUpsample --
@pytest.mark.parametrize("mode", te.UPSAMPLINGS)
@pytest.mark.parametrize("src,size", [((6, 8), None), ((8, 10), (15, 19))])
def test_learned_upsample_matches_jax(mode, src, size):
    """Each mode, at twice the input and cropped to an odd skip size (the
    nearest 2x step gives 16 x 20 and keeps the leading rows). The learned
    convs start as the bilinear kernel on both sides."""
    C = 5
    x = rand((2, C) + src, 4)
    jm = je.LearnedUpsample(mode)
    v = jm.init(jax.random.PRNGKey(0), nhwc(x), size)
    sd = {}
    convert._learned_upsample(sd, "", jax.tree.map(np.asarray,
                                                   v.get("params", {})))
    tm = te.LearnedUpsample(C, mode)
    own = tm.state_dict()
    assert set(own) == {k.lstrip(".") for k in sd}
    for k, t in sd.items():
        assert torch.equal(own[k.lstrip(".")], t), k
    with torch.no_grad():
        got = tm(torch.from_numpy(x), size)
    want = jm.apply(v, nhwc(x), size)
    out = size or (2 * src[0], 2 * src[1])
    assert got.shape == (2, C) + tuple(out)
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)


def test_nearest_2x_backward_sums_the_copies():
    x = torch.arange(6.0).reshape(1, 1, 2, 3).requires_grad_(True)
    y = te.nearest_2x(x)
    assert torch.equal(y, x.repeat_interleave(2, 2).repeat_interleave(2, 3))
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, torch.full_like(x, 4.0))


# --------------------------------------------------- NonBottleneck1D --
NB_CASES = [dict(), dict(stride=2), dict(dilation=2), dict(use_in=True),
            dict(residual_only=True), dict(cin=8)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", NB_CASES,
                         ids=["plain", "stride2", "dil2", "in", "residual",
                              "proj"])
def test_non_bottleneck_matches_jax(case, train):
    case = dict(case)
    cin = case.pop("cin", 12)
    x = rand((2, cin, 9, 13), 5)
    jm = JNB(12, **case)
    v = init_tree(jm, nhwc(x), train=True, seed=6)
    sd = {}
    convert._non_bottleneck(sd, "m", v["params"], v.get("batch_stats", {}))
    tm = load(TNB(12, in_channels=cin, **case),
              {k[2:]: t for k, t in sd.items()}, train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want, stats = jax_apply(jm, v, nhwc(x), train=train)
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)
    if train and stats:
        back = {}
        convert._non_bottleneck(back, "m", v["params"],
                                jax.tree.map(np.asarray, stats))
        assert_running_stats(tm, {k[2:]: t for k, t in back.items()})


# -------------------------------------------------------- ResNetStem --
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("cin", [3, 41])
def test_resnet_stem_matches_jax(cin, train):
    """3 channels (an image) and 41 (the vanilla depth stem: the depth and
    a 40-class guidance map); odd planes, so the max-pool's -inf padding
    shows."""
    x = rand((2, cin, 37, 50), 7)
    jm = JStem()
    v = init_tree(jm, nhwc(x), train=True, seed=8)
    sd = {}
    convert._stem(sd, "s", v["params"], v["batch_stats"])
    tm = load(TStem(cin), {k[2:]: t for k, t in sd.items()}, train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want, stats = jax_apply(jm, v, nhwc(x), train=train)
    assert got.shape == (2, 64, 10, 13)
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)
    if train:
        back = {}
        convert._stem(back, "s", v["params"], jax.tree.map(np.asarray, stats))
        assert_running_stats(tm, {k[2:]: t for k, t in back.items()})


# ------------------------------------------------- SE, fusion and PPM --
def test_squeeze_excitation_and_fusion_match_jax():
    x, z = rand((2, 32, 7, 9), 9), rand((2, 32, 7, 9), 10)
    jm = je.SqueezeAndExcitation()
    v = init_tree(jm, nhwc(x), seed=11)
    sd = {}
    convert._se(sd, "m", v["params"])
    tm = load(te.SqueezeAndExcitation(32), {k[2:]: t for k, t in sd.items()},
              False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), nchw(jm.apply(v, nhwc(x))), **FWD)

    jf = je.SqueezeAndExciteFusionAdd()
    v = init_tree(jf, nhwc(x), nhwc(z), seed=12)
    sd = {}
    for name, k in (("se_rgb", 0), ("se_depth", 1)):
        convert._se(sd, name, v["params"][f"SqueezeAndExcitation_{k}"])
    tf = load(te.SqueezeAndExciteFusionAdd(32), sd, False)
    with torch.no_grad():
        got = tf(torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(),
                               nchw(jf.apply(v, nhwc(x), nhwc(z))), **FWD)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("plane", [(8, 10), (2, 2)])
def test_pyramid_pooling_matches_jax(plane, train):
    """Bins (1, 5): at 8x10 (ESANet's 1/32 plane at 228x304) the 5x5 pool
    overlaps its windows; at 2x2 every window holds one pixel."""
    x = rand((2, 64) + plane, 13)
    jm = je.PyramidPoolingModule(16)
    v = init_tree(jm, nhwc(x), train=True, seed=14)

    def to_sd(stats):
        sd = {}
        for i in range(2):
            convert._conv_bn_act(sd, f"features.{i}.1",
                                 v["params"][f"ConvBNActESA_{i}"],
                                 stats[f"ConvBNActESA_{i}"])
        convert._conv_bn_act(sd, "final_conv", v["params"]["ConvBNActESA_2"],
                             stats["ConvBNActESA_2"])
        return sd

    tm = load(te.PyramidPoolingModule(64, 16), to_sd(v["batch_stats"]),
              train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want, stats = jax_apply(jm, v, nhwc(x), train=train)
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)
    if train:
        assert_running_stats(tm, to_sd(jax.tree.map(np.asarray, stats)))


# ------------------------------------------------------------ ESANets --
ESA_CASES = [
    # (H, W, pyramid_supervision, upsampling, SE, train)
    (64, 64, True, "learned-3x3-zeropad", "SE-add", True),
    (64, 64, True, "learned-3x3-zeropad", "SE-add", False),
    (72, 96, False, "learned-3x3", "SE-add", False),
    (72, 96, True, "bilinear", "None", False),
    (72, 96, True, "nearest", "None", True),
]


@pytest.mark.parametrize("H,W,ps,up,se,train", ESA_CASES)
def test_esanet_one_modality_matches_jax(H, W, ps, up, se, train):
    """Narrow decoders (16) behind the full resnet18 torso; 72x96 puts 9x12,
    5x6 and 3x3 planes under the decoder, whose upsamplings crop (3 -> 5,
    5 -> 9). Train mode with pyramid supervision returns (out, s8, s16,
    s32), eval mode out alone; the running statistics after a train-mode
    pass."""
    kw = dict(num_classes=5, channels_decoder=(16, 16, 16), upsampling=up,
              weighting_in_encoder=se, pyramid_supervision=ps)
    x = rand((2, 3, H, W), 15)
    jm = je.ESANetOneModality(**kw)
    v = init_tree(jm, nhwc(x), train=True, seed=16)
    sd = convert.esanet_state_dict_from_jax(v["params"], v["batch_stats"])
    tm = load(te.ESANetOneModality(**kw), sd, train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want, stats = jax_apply(jm, v, nhwc(x), train=train)
    if not train:
        assert got.shape == (2, 5, H, W)
        np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)
        return
    want64, _ = jax_apply(jm, v, nhwc(x), train=True, f64=True)
    if not ps:
        got, want, want64 = (got,), (want,), (want64,)
    assert len(got) == (4 if ps else 1)
    for i, (g, w, w64) in enumerate(zip(got, want, want64)):
        assert g.shape == nchw(w).shape
        assert_train_close(g.numpy(), nchw(w), nchw(w64), f"output {i}")
    back = convert.esanet_state_dict_from_jax(
        v["params"], jax.tree.map(np.asarray, stats))
    assert_running_stats(tm, back)


def test_esanet_two_modality_matches_jax():
    """The RGB and depth torsos fused by SE after the stems and each stage,
    eval mode (the train-mode blocks are those of ESANetOneModality)."""
    kw = dict(num_classes=4, channels_decoder=(16, 16, 16))
    x, z = rand((2, 3, 64, 64), 17), rand((2, 1, 64, 64), 18)
    jm = je.ESANet(**kw)
    v = init_tree(jm, nhwc(x), nhwc(z), train=True, seed=19)
    sd = convert.esanet_state_dict_from_jax(v["params"], v["batch_stats"],
                                            two_modality=True)
    tm = load(te.ESANet(**kw), sd, False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(z))
    want, _ = jax_apply(jm, v, nhwc(x), nhwc(z), train=False)
    assert got.shape == (2, 4, 64, 64)
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)
