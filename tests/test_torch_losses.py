"""Parity of the port's losses with the JAX package's, on the CPU: every
loss with and without a weight, every GANLoss mode, and the WGAN-GP
gradient penalty with JAX's interpolation draw handed in.

Tolerance: rtol 1e-5 / atol 1e-6 for the sums of elementwise f32 terms
(summed in another order); the gradient penalty goes through a PatchGAN
forward and backward, so it takes the forward tolerance of
``tests/test_ckpt_convert_flagship.py``, rtol 1e-3 / atol 1e-4.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch import losses as tl
from rdfc_gan_torch.models import PatchGANDiscriminator
from rdfc_gan_tpu import losses as jl
from rdfc_gan_tpu.models.discriminators import \
    PatchGANDiscriminator as JPatchGAN

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_ckpt import convert_patchgan  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed, shape=(2, 3, 5, 7)):
    r = np.random.RandomState(seed)
    return (r.normal(size=shape).astype(np.float32),
            r.normal(size=shape).astype(np.float32),
            r.uniform(0, 1, size=shape).astype(np.float32))


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "mse_loss",
                                  "binary_cross_entropy_loss"])
@pytest.mark.parametrize("weight", ["none", "full", "per_pixel"])
def test_weighted_losses_match_jax(name, weight):
    pred, target, w = _pair(0)
    if name == "binary_cross_entropy_loss":
        target = (target > 0).astype(np.float32)
    tw = jw = None
    if weight == "full":
        tw, jw = torch.from_numpy(w), _nhwc(w)
    elif weight == "per_pixel":  # one rank fewer: broadcast over channels
        tw, jw = torch.from_numpy(w[:, 0]), jnp.asarray(w[:, 0])
    got = getattr(tl, name)(torch.from_numpy(pred), torch.from_numpy(target),
                            weight=tw)
    want = getattr(jl, name)(_nhwc(pred), _nhwc(target), weight=jw)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_default_weight_is_not_a_plain_mean():
    """1/(numel + 1e-6), not F.mse_loss's 1/numel: the difference is below
    f32 resolution here, but the formula is the reference's."""
    pred, target, _ = _pair(1)
    got = tl.mse_loss(torch.from_numpy(pred), torch.from_numpy(target))
    n = pred.size
    np.testing.assert_allclose(
        float(got), float(((pred - target) ** 2).sum() / (n + 1e-6)),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla", "wgan", "wgangp"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    pred, _, _ = _pair(2, (2, 1, 6, 9))
    got = tl.GANLoss(mode)(torch.from_numpy(pred), real)
    want = jl.GANLoss(mode)(_nhwc(pred), real)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_gan_loss_gradients_match_jax():
    pred, _, _ = _pair(3, (2, 1, 6, 9))
    for mode in ("lsgan", "vanilla", "wgan"):
        p = torch.from_numpy(pred).requires_grad_(True)
        tl.GANLoss(mode)(p, True).backward()
        want = jax.grad(lambda x: jl.GANLoss(mode)(x, True))(_nhwc(pred))
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.moveaxis(np.asarray(want), -1, 1),
                                   **TOL, err_msg=mode)


def test_gradient_penalty_matches_jax_with_its_draw():
    """The penalty and its gradient in D's parameters, D in eval mode, the
    interpolation draw taken from JAX's key and handed to the port."""
    torch.manual_seed(0)
    ch = (8, 16, 16, 16, 1)
    D = PatchGANDiscriminator(out_channels=ch).eval()
    with torch.no_grad():
        for m in D.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    r = np.random.RandomState(4)
    real = r.normal(size=(2, 1, 32, 48)).astype(np.float32)
    fake = r.normal(size=(2, 1, 32, 48)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.uniform(key, (2, 1, 1, 1)))

    got = tl.gradient_penalty(D, torch.from_numpy(real),
                              torch.from_numpy(fake),
                              eps=torch.from_numpy(eps.copy()))
    got.backward()
    tree = convert_patchgan({k: v.detach().numpy().copy()
                             for k, v in D.state_dict().items()})
    jd = JPatchGAN(out_channels=ch)

    def gp(params):
        return jl.gradient_penalty(
            lambda x: jd.apply({"params": params,
                                "batch_stats": tree["batch_stats"]}, x,
                               train=False),
            _nhwc(real), _nhwc(fake), key)

    want, jgrads = jax.value_and_grad(gp)(
        jax.tree.map(jnp.asarray, tree["params"]))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-3,
                               atol=1e-4)
    for i, m in enumerate(D.model):
        g = np.asarray(jgrads[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(m.conv.weight.grad.numpy(), g, rtol=0,
                                   atol=1e-3 * np.abs(g).max() + 1e-6,
                                   err_msg=f"model.{i}.conv.weight")
