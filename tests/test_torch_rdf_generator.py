"""Parity of the port's RDFGenerator (NLSPN on) with the JAX package, both
ways through the weight converters, on the CPU at narrow widths.

Tolerance rtol 1e-3 / atol 1e-4 is that of
``tests/test_ckpt_convert_flagship.py``: f32 convolutions summed in another
order by XLA and ATen.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models import RDFGenerator as TorchRDFGenerator
from rdfc_gan_torch.utils.convert import rdf_generator_state_dict_from_jax
from rdfc_gan_tpu.models.rdf_generator import RDFGenerator as FlaxRDFGenerator
from rdfc_gan_tpu.utils.torch_convert import convert_rdf_generator

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

ENC = (16, 16, 16, 16, 16, 16)
DEC = (16, 16, 16, 16)
NLSPN = dict(prop_kernel=3, prop_time=4, affinity="TGASS",
             affinity_gamma=0.5, conf_prop=True, preserve_input=False)
KEYS = ("depth_map_1", "confidence_map_1", "depth_map_2", "confidence_map_2",
        "pred_depth")
SIZES = [(32, 48), (36, 52)]  # divisible by 16; overhangs trimmed at skips


def _kw(impl="auto"):
    return dict(rgb_channels_encoder=ENC, depth_channels_encoder=ENC,
                rgb_channels_decoder=DEC, depth_channels_decoder=DEC,
                use_nlspn_refine=True, nlspn_configs=NLSPN, nlspn_impl=impl)


def _inputs(seed, H, W):
    r = np.random.RandomState(seed)
    rgb = r.normal(size=(2, 3, H, W)).astype(np.float32)
    dep = np.abs(r.normal(size=(2, 1, H, W))).astype(np.float32)
    nrm = r.normal(size=(2, 3, H, W)).astype(np.float32)
    return rgb, dep, nrm


def _random_torch_generator(seed, impl="auto"):
    torch.manual_seed(seed)
    g = TorchRDFGenerator(**_kw(impl))
    with torch.no_grad():
        for n, p in g.named_parameters():
            if n.endswith(("aff_scale_const", ".w", ".b", ".w_conf")):
                continue
            p.uniform_(-0.15, 0.15)
        for m in g.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
        oa = g.nlspn_refine_module.prop_layer.conv_offset_aff
        oa.weight.uniform_(-0.1, 0.1)
        oa.bias.uniform_(-0.5, 0.5)
    return g.eval()


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _flax_apply(tree, impl, rgb, dep, nrm):
    fm = FlaxRDFGenerator(**_kw(impl))
    v = {"params": jax.tree.map(jnp.asarray, tree["params"]),
         "batch_stats": jax.tree.map(jnp.asarray, tree["batch_stats"])}
    apply = jax.jit(lambda v, *x: fm.apply(v, *x, train=False))
    return apply(v, _nhwc(rgb), _nhwc(dep), _nhwc(nrm))


def _assert_outputs(got_torch, want_jax):
    for k in KEYS:
        np.testing.assert_allclose(got_torch[k].numpy()[:, 0],
                                   np.asarray(want_jax[k])[..., 0],
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got_torch["nlspn_max_offset"]),
                               float(want_jax["nlspn_max_offset"]),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("impl,H,W", [("auto",) + SIZES[0],
                                       ("auto",) + SIZES[1],
                                       ("gather",) + SIZES[1]])
def test_port_weights_to_flax_give_same_outputs(impl, H, W):
    g = _random_torch_generator(0, impl)
    rgb, dep, nrm = _inputs(1, H, W)
    with torch.no_grad():
        got = g(torch.from_numpy(rgb), torch.from_numpy(dep),
                torch.from_numpy(nrm))
    assert float(got["nlspn_max_offset"]) > 0.1
    sd = {k: v.numpy() for k, v in g.state_dict().items()}
    tree = convert_rdf_generator(sd, use_nlspn_refine=True)
    _assert_outputs(got, _flax_apply(tree, impl, rgb, dep, nrm))


def _random_flax_tree(seed, H, W):
    """Random values in the Flax tree's structure (shapes from
    ``eval_shape``, so no forward runs to make it)."""
    fm = FlaxRDFGenerator(**_kw())
    v = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 1)), jnp.zeros((1, H, W, 3)), train=False))
    r = np.random.RandomState(seed)

    def fill(path, a):
        leaf = jax.tree_util.keystr(path)
        if "aff_scale_const" in leaf:
            return np.full(a.shape, 4.0, np.float32)
        lo, hi = {"'scale'": (0.5, 1.5), "'var'": (0.5, 2.0),
                  "'mean'": (-0.5, 0.5)}.get(leaf[leaf.rfind("["):][1:-1],
                                              (-0.15, 0.15))
        if "conv_offset_aff" in leaf:
            lo, hi = (-0.5, 0.5) if leaf.endswith("['bias']") else (-0.1, 0.1)
        return r.uniform(lo, hi, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(v))


def _load_from_jax(tree):
    g = TorchRDFGenerator(**_kw())
    sd = rdf_generator_state_dict_from_jax(tree["params"],
                                           tree["batch_stats"])
    res = g.load_state_dict(sd, strict=False)
    assert not res.unexpected_keys
    assert res.missing_keys and all(k.startswith("fuse_layer5.")
                                    for k in res.missing_keys)
    return g.eval(), sd


@pytest.mark.parametrize("H,W", SIZES)
def test_flax_weights_to_port_give_same_outputs(H, W):
    tree = _random_flax_tree(2, H, W)
    g, _ = _load_from_jax(tree)
    rgb, dep, nrm = _inputs(3, H, W)
    with torch.no_grad():
        got = g(torch.from_numpy(rgb), torch.from_numpy(dep),
                torch.from_numpy(nrm))
    assert float(got["nlspn_max_offset"]) > 0.1
    _assert_outputs(got, _flax_apply(tree, "auto", rgb, dep, nrm))


def test_converters_are_inverse():
    tree = _random_flax_tree(4, 32, 48)
    _, sd = _load_from_jax(tree)
    back = convert_rdf_generator({k: v.numpy() for k, v in sd.items()},
                                 use_nlspn_refine=True)
    flat_t, tdef_t = jax.tree.flatten(tree)
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_t == tdef_b
    for a, b in zip(flat_t, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_dict_is_the_reference_schema():
    """Same names and shapes as the reference mirror, so a reference
    ``.pth`` loads strictly."""
    from torch_ref_models import TorchRDFGenerator as RefGenerator

    ref = RefGenerator(rgb_channels_encoder=ENC, depth_channels_encoder=ENC,
                       rgb_channels_decoder=DEC, depth_channels_decoder=DEC,
                       use_nlspn_refine=True, nlspn_configs=NLSPN)
    port = TorchRDFGenerator(**_kw())
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    port.load_state_dict(ref.state_dict(), strict=True)
