"""The G_A2B variants and the PatchGAN options of the port against their
Flax twins, on the CPU at narrow widths, through ``utils/convert.py``:
``AdaIN`` and ``INFuse`` alone and as ``fuse_depth_in_rgb_decoder``,
``add`` skips in either branch, and the PatchGAN's ``activation``
(``LeakyReLU``, ``relu``, ``None``) and ``norm_cfg`` (JAX builds BatchNorm
whatever it says, and so does the port). Outputs, input gradients and the
variants' own parameter gradients.

Tolerance rtol 1e-3 / atol 1e-4 is that of
``tests/test_torch_rdf_generator.py``: f32 convolutions summed in another
order by XLA and ATen. Gradients are held to 1e-3 of their largest
magnitude (as ``tests/test_torch_losses.py`` holds the PatchGAN's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models import PatchGANDiscriminator
from rdfc_gan_torch.models import RDFGenerator as TorchRDFGenerator
from rdfc_gan_torch.models.layers import AdaIN, INFuse
from rdfc_gan_torch.utils.convert import (patchgan_state_dict_from_jax,
                                          rdf_generator_state_dict_from_jax)
from rdfc_gan_tpu.models import discriminators as jdisc
from rdfc_gan_tpu.models import layers as jlayers
from rdfc_gan_tpu.models.rdf_generator import RDFGenerator as FlaxRDFGenerator

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
ENC = (16, 16, 16, 16, 16, 16)
DEC = (16, 16, 16, 16)
KEYS = ("depth_map_1", "confidence_map_1", "depth_map_2", "confidence_map_2",
        "pred_depth")


def _nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _close_grad(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max() + 1e-6,
                               err_msg=what)


def _pair(seed, shape_c, shape_s):
    r = np.random.RandomState(seed)
    return (r.normal(1.0, 2.0, shape_c).astype(np.float32),
            r.normal(-0.5, 0.7, shape_s).astype(np.float32))


def test_adain_matches_flax():
    """Unbiased variance with eps before the root: output and both input
    gradients."""
    c, s = _pair(0, (2, 5, 6, 7), (2, 5, 6, 7))
    w = np.random.RandomState(1).normal(size=c.shape).astype(np.float32)
    tc, ts = (torch.from_numpy(a).requires_grad_() for a in (c, s))
    out = AdaIN()(tc, ts)
    (out * torch.from_numpy(w)).sum().backward()

    def f(c, s):
        return jlayers.AdaIN().apply({}, c, s)

    want = f(_nhwc(c), _nhwc(s))
    np.testing.assert_allclose(out.detach().numpy(), _nchw(want), rtol=RTOL,
                               atol=ATOL)
    gc, gs = jax.grad(lambda c, s: jnp.sum(f(c, s) * _nhwc(w)),
                      argnums=(0, 1))(_nhwc(c), _nhwc(s))
    _close_grad(tc.grad.numpy(), _nchw(gc), "d content")
    _close_grad(ts.grad.numpy(), _nchw(gs), "d style")


def test_infuse_matches_flax():
    """concat -> instance norm (the plain versions of the IN kernels here)
    -> 1x1 conv: output, input gradients and the conv's gradients."""
    c, s = _pair(2, (2, 6, 9, 11), (2, 6, 9, 11))
    w = np.random.RandomState(3).normal(size=c.shape).astype(np.float32)
    jm = jlayers.INFuse(in_channel=6)
    v = jm.init(jax.random.PRNGKey(0), _nhwc(c), _nhwc(s))
    m = INFuse(6)
    sd = {}
    from rdfc_gan_torch.utils.convert import _conv
    _conv(sd, "conv", jax.tree.map(np.asarray, v["params"]["Conv_0"]))
    m.load_state_dict(sd, strict=True)
    tc, ts = (torch.from_numpy(a).requires_grad_() for a in (c, s))
    out = m(tc, ts)
    (out * torch.from_numpy(w)).sum().backward()

    def f(p, c, s):
        return jm.apply({"params": p}, c, s)

    np.testing.assert_allclose(out.detach().numpy(),
                               _nchw(f(v["params"], _nhwc(c), _nhwc(s))),
                               rtol=RTOL, atol=ATOL)
    gp, gc, gs = jax.grad(lambda p, c, s: jnp.sum(f(p, c, s) * _nhwc(w)),
                          argnums=(0, 1, 2))(v["params"], _nhwc(c),
                                             _nhwc(s))
    _close_grad(tc.grad.numpy(), _nchw(gc), "d content")
    _close_grad(ts.grad.numpy(), _nchw(gs), "d style")
    _close_grad(m.conv.weight.grad.numpy(),
                np.asarray(gp["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
                "d kernel")
    _close_grad(m.conv.bias.grad.numpy(), gp["Conv_0"]["bias"], "d bias")


VARIANTS = {
    "IN": dict(fuse_depth_in_rgb_decoder="IN"),
    "AdaIN": dict(fuse_depth_in_rgb_decoder="AdaIN"),
    "add": dict(rgb_skip_connection_type="add",
                depth_skip_connection_type="add"),
    "IN_rgb_add": dict(fuse_depth_in_rgb_decoder="IN",
                       rgb_skip_connection_type="add"),
}


def _kw(variant):
    return dict(rgb_channels_encoder=ENC, depth_channels_encoder=ENC,
                rgb_channels_decoder=DEC, depth_channels_decoder=DEC,
                use_nlspn_refine=False, **VARIANTS[variant])


def _random_flax_tree(variant, seed, H, W):
    fm = FlaxRDFGenerator(**_kw(variant))
    v = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 1)), jnp.zeros((1, H, W, 3)), train=False))
    r = np.random.RandomState(seed)

    def fill(path, a):
        leaf = jax.tree_util.keystr(path)
        lo, hi = {"'scale'": (0.5, 1.5), "'var'": (0.5, 2.0),
                  "'mean'": (-0.5, 0.5)}.get(leaf[leaf.rfind("["):][1:-1],
                                              (-0.15, 0.15))
        return r.uniform(lo, hi, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(v))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_variant_matches_flax(variant):
    """A random Flax tree carried to the port: the five outputs, the
    gradients of a weighted sum of them in the three inputs, and (INFuse)
    in the fuse layers' 1x1 convs."""
    H, W = 32, 48
    tree = _random_flax_tree(variant, 5, H, W)
    fuse = VARIANTS[variant].get("fuse_depth_in_rgb_decoder", "WAdaIN")
    sd = rdf_generator_state_dict_from_jax(tree["params"],
                                           tree["batch_stats"],
                                           use_nlspn_refine=False, fuse=fuse)
    g = TorchRDFGenerator(**_kw(variant))
    res = g.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("fuse_layer5.") for k in res.missing_keys)
    g.eval()
    r = np.random.RandomState(6)
    x = [r.normal(size=(2, c, H, W)).astype(np.float32) for c in (3, 1, 3)]
    x[1] = np.abs(x[1])
    wts = {k: r.normal(size=(2, 1, H, W)).astype(np.float32) for k in KEYS}
    tx = [torch.from_numpy(a).requires_grad_() for a in x]
    got = g(*tx)
    sum(((got[k] * torch.from_numpy(wts[k])).sum() for k in KEYS)).backward()

    fm = FlaxRDFGenerator(**_kw(variant))
    v = {"params": jax.tree.map(jnp.asarray, tree["params"]),
         "batch_stats": jax.tree.map(jnp.asarray, tree["batch_stats"])}

    def f(p, *ins):
        return fm.apply({"params": p, "batch_stats": v["batch_stats"]},
                        *ins, train=False)

    def loss(p, *ins):
        out = f(p, *ins)
        return sum(jnp.sum(out[k] * _nhwc(wts[k])) for k in KEYS)

    jx = [_nhwc(a) for a in x]
    want = jax.jit(f)(v["params"], *jx)
    for k in KEYS:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   _nchw(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(v["params"], *jx)
    # rgb feeds nothing when the normal is given: no gradient either side
    assert tx[0].grad is None and not np.asarray(grads[1]).any()
    for name, t, gj in zip(("depth", "normal"), tx[1:], grads[2:]):
        _close_grad(t.grad.numpy(), _nchw(gj), f"d {name}")
    if fuse == "IN":
        for i in range(4):
            gk = grads[0][f"fuse_layers_{i}"]["Conv_0"]
            conv = getattr(g, f"fuse_layer{i + 1}").conv
            _close_grad(conv.weight.grad.numpy(),
                        np.asarray(gk["kernel"]).transpose(3, 2, 0, 1),
                        f"fuse_layer{i + 1} kernel")
            _close_grad(conv.bias.grad.numpy(), gk["bias"],
                        f"fuse_layer{i + 1} bias")


def test_add_skips_take_no_skip_channels():
    """As the JAX module builds them: a decoder and the heads after an
    ``add`` skip take the decoder's width only."""
    g = TorchRDFGenerator(**_kw("add"))
    ed = g.rgb_branch_encoder_decoder
    assert ed.de4[0].in_channels == DEC[0]
    assert g.rgb_pred_dec1[0].in_channels == DEC[-1]
    assert g.id_dec1[0].in_channels == DEC[-1]
    assert g.fuse_layer2.style.linear.weight_orig.shape == (2 * DEC[0],
                                                            DEC[0])
    with pytest.raises(NotImplementedError):
        TorchRDFGenerator(fuse_depth_in_rgb_decoder="SPADE")


CH = (8, 16, 16, 16, 1)


@pytest.mark.parametrize("activation,norm_cfg", [
    ("LeakyReLU", None), ("relu", None), (None, None),
    ("relu", {"type": "IN2d"})])
@pytest.mark.parametrize("train", [False, True])
def test_patchgan_options_match_flax(activation, norm_cfg, train):
    """Output, input gradient and every conv's gradient; in train mode the
    batch statistics and the running update too."""
    r = np.random.RandomState(7)
    x = r.normal(size=(2, 1, 32, 48)).astype(np.float32)
    w = r.normal(size=(2, 1, 2, 4)).astype(np.float32)
    jd = jdisc.PatchGANDiscriminator(out_channels=CH, activation=activation,
                                     norm_cfg=norm_cfg)
    v = jd.init(jax.random.PRNGKey(3), _nhwc(x), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(
        lambda a: r.uniform(0.5, 1.5, a.shape).astype(np.float32),
        v["batch_stats"])
    D = PatchGANDiscriminator(out_channels=CH, activation=activation,
                              norm_cfg=norm_cfg)
    D.load_state_dict(patchgan_state_dict_from_jax(params, stats))
    D.train(train)
    tx = torch.from_numpy(x).requires_grad_()
    out = D(tx)
    (out * torch.from_numpy(w)).sum().backward()

    def f(p, x):
        return jd.apply({"params": p, "batch_stats": stats}, x, train=train,
                        mutable=["batch_stats"] if train else False)

    want = f(params, _nhwc(x))
    want, new_stats = (want if train else (want, None))
    np.testing.assert_allclose(out.detach().numpy(), _nchw(want), rtol=RTOL,
                               atol=ATOL)
    gp, gx = jax.grad(lambda p, x: jnp.sum(
        (f(p, x)[0] if train else f(p, x)) * _nhwc(w)),
        argnums=(0, 1))(params, _nhwc(x))
    _close_grad(tx.grad.numpy(), _nchw(gx), "d input")
    for i, m in enumerate(D.model):
        _close_grad(m.conv.weight.grad.numpy(),
                    np.asarray(gp[f"Conv_{i}"]["kernel"]).transpose(
                        3, 2, 0, 1), f"Conv_{i}")
        if m.bn is not None and train:
            js = new_stats["batch_stats"][f"BatchNorm_{i - 1}"]
            np.testing.assert_allclose(m.bn.running_mean.numpy(),
                                       js["mean"], rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(m.bn.running_var.numpy(),
                                       js["var"], rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError):
        PatchGANDiscriminator(out_channels=CH, activation="gelu")
