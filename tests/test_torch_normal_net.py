"""Parity of the port's NNET (G_normal) with the JAX package, on the CPU.

The JAX NNET at the ``rdfc_gan_tiny.yaml`` sizes (width 0.35, depth 0.3)
is initialised from a key, its BatchNorm parameters and statistics are
drawn from a numpy seed, its trees go through ``nnet_state_dict_from_jax``
into the port, and both run in eval mode on the same numpy input. At 40x76
the stride-2 chain reaches odd sizes (76 -> 38 -> 19 -> 10 -> 5 and
40 -> 20 -> 10 -> 5 -> 3), so the TF "SAME" pads are asymmetric at some
convs and symmetric at others, and the decoder resizes 3x5 -> 5x10, which
is no doubling. Tolerance rtol 1e-3 / atol 1e-4: f32 convolutions summed
in another order by XLA and ATen, and the align-corners resize as the same
matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models.normal_net import NNET as TorchNNET
from rdfc_gan_torch.models.normal_net import norm_normalize_kappa
from rdfc_gan_torch.utils.convert import nnet_state_dict_from_jax
from rdfc_gan_tpu.models import normal_net as jnn

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

WIDTH, DEPTH = 0.35, 0.3


def randomize_norms(tree, seed, scale=(0.8, 1.2)):
    """Numpy copy of a Flax (params or batch_stats) tree with every norm
    leaf (scale, bias of a BatchNorm, mean, var) drawn from ``seed``; the
    ``scale`` range keeps a deep net's outputs near 1."""
    r = np.random.RandomState(seed)
    ranges = {"var": (0.5, 1.5), "scale": scale, "mean": (-0.2, 0.2),
              "bias": (-0.1, 0.1)}

    def walk(t, bn):
        out = {}
        for k, v in t.items():
            if hasattr(v, "items"):
                out[k] = walk(v, k.startswith("BatchNorm"))
            elif k in ranges and (bn or k != "bias"):
                out[k] = r.uniform(*ranges[k], np.shape(v)).astype(
                    np.float32)
            else:
                out[k] = np.array(v, np.float32)
        return out

    return walk(tree, False)


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("H,W", [(40, 76), (32, 48)])
def test_nnet_matches_jax(H, W):
    img = np.random.RandomState(0).uniform(-1, 1, (2, 3, H, W)).astype(
        np.float32)
    jm = jnn.NNET(H, W, width=WIDTH, depth=DEPTH)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        _nhwc(img))
    params = randomize_norms(v["params"], 1)
    stats = randomize_norms(v["batch_stats"], 2)
    want = jax.jit(lambda p, s, x: jm.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats,
                                                          _nhwc(img))

    tm = TorchNNET(H, W, width=WIDTH, depth=DEPTH).eval()
    tm.load_state_dict(nnet_state_dict_from_jax(params, stats, DEPTH),
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert tuple(got.shape) == (2, 4, H, W)
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=1e-3,
                               atol=1e-4)


def test_norm_normalize_kappa_matches_jax():
    x = np.random.RandomState(3).normal(size=(2, 4, 5, 7)).astype(np.float32)
    x[0, :3, 0, 0] = 0.0  # a zero vector: eps inside the square root
    got = norm_normalize_kappa(torch.from_numpy(x))
    want = jnn.norm_normalize_kappa(_nhwc(x))
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=1e-5,
                               atol=1e-6)


def test_same_padding_follows_the_input_size():
    """TF SAME: a k5 s2 conv pads (2, 2) on 19 and (1, 2) on 38."""
    from rdfc_gan_torch.models.normal_net import Conv2dSame

    conv = Conv2dSame(1, 1, 5, 2)
    seen = []
    real = torch.nn.functional.pad

    def spy(x, pads):
        seen.append(tuple(pads))
        return real(x, pads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.functional, "pad", spy)
        conv(torch.zeros(1, 1, 19, 38))
    assert seen == [(1, 2, 2, 2)]
