"""Parity of the port's PSPNet (G_label) with the JAX package, on the CPU.

A narrow dilated-R50 PSPNet (planes 8/8/16/16, stem 8, 5 classes: the
``rdfc_gan_tiny.yaml`` sizes) is initialised in JAX in train mode, so that
it has the aux head, its BatchNorm leaves are drawn from a numpy seed, and
its trees go through ``pspnet_state_dict_from_jax`` into the port. Both run
in eval mode on one numpy input: the main logits, and with ``force_aux``
the main and aux logits. At 40x56 the stride-8 map is 5x7, so the pyramid
bins 2, 3 and 6 pool over overlapping and single-row windows. Tolerance
rtol 1e-3 / atol 1e-4, as the other port parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models.label_net import PSPNet as TorchPSPNet
from rdfc_gan_torch.models.resnet import make_stages
from rdfc_gan_torch.utils.convert import pspnet_state_dict_from_jax
from rdfc_gan_tpu.models.label_net import PSPNet as FlaxPSPNet
from test_torch_normal_net import randomize_norms

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

KW = dict(planes=(8, 8, 16, 16), stem_features=8)
H, W = 40, 56


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def nets():
    img = np.random.RandomState(0).uniform(-1, 1, (2, 3, H, W)).astype(
        np.float32)
    jm = FlaxPSPNet(5, **KW)
    v = jax.jit(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, train=True))(_nhwc(img))
    params = randomize_norms(v["params"], 1, scale=(0.3, 0.6))
    stats = randomize_norms(v["batch_stats"], 2)
    tm = TorchPSPNet(5, **KW).eval()
    tm.load_state_dict(pspnet_state_dict_from_jax(params, stats),
                       strict=True)
    return img, jm, params, stats, tm


@pytest.mark.parametrize("force_aux", [False, True])
def test_pspnet_matches_jax(nets, force_aux):
    img, jm, params, stats, tm = nets
    want = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, train=False,
        force_aux=force_aux))(params, stats, _nhwc(img))
    with torch.no_grad():
        got = tm(torch.from_numpy(img), force_aux=force_aux)
    if not force_aux:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 5, H, W)
        np.testing.assert_allclose(g.numpy(), _nchw(w), rtol=1e-3, atol=1e-4)


def test_dilated_stages_follow_the_reference():
    """Output stride 8: layer3 block 0 at dilation 1, then 2; layer4's
    multi-grid 4, 8, 16; only layer2 strides."""
    stages = make_stages("resnet50", 16, (8, 8, 16, 16), dilated=True)
    dil = [[b.conv2.dilation[0] for b in s] for s in stages]
    stride = [[b.conv2.stride[0] for b in s] for s in stages]
    assert dil == [[1, 1, 1], [1, 1, 1, 1], [1, 2, 2, 2, 2, 2], [4, 8, 16]]
    assert stride == [[1, 1, 1], [2, 1, 1, 1], [1] * 6, [1, 1, 1]]
