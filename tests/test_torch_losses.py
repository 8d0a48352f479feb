"""Parity of the port's losses with the JAX package's, on the CPU: every
loss with and without a weight, every GANLoss mode, the WGAN-GP gradient
penalty with JAX's interpolation draw handed in, and the flagship's
softmax cross-entropy, ``nor_loss`` (with its 0.999 gate),
``manhattan_loss`` and pepper noise (with JAX's draw handed in), values
and gradients.

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

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

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


# ------------------------------------------- the flagship's label and normal
def test_softmax_cross_entropy_matches_jax():
    r = np.random.RandomState(5)
    logits = r.normal(size=(2, 6, 5, 7)).astype(np.float32) * 2
    labels = r.randint(0, 6, size=(2, 5, 7)).astype(np.int32)
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tl.softmax_cross_entropy_loss(lt, torch.from_numpy(labels))
    got.backward()
    want, g = jax.value_and_grad(jl.softmax_cross_entropy_loss)(
        _nhwc(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.moveaxis(np.asarray(g),
                                                            -1, 1), **TOL)


def _normals(seed, shape=(2, 3, 6, 8)):
    r = np.random.RandomState(seed)
    return r.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mask_rank", [3, 4])
def test_nor_loss_matches_jax_with_its_gate(mask_rank):
    """(1 - cos) over the valid pixels; pixels whose cosine is beyond
    +-0.999 (here a quarter of them, set parallel or opposite to the
    target) are left out, on the detached cosine, as in JAX."""
    pred, target = _normals(6), _normals(7)
    pred[:, :, :3] = target[:, :, :3] * 2.0   # cos = +1: gated out
    pred[:, :, 3, :4] = -target[:, :, 3, :4]  # cos = -1: gated out
    mask = (np.random.RandomState(8).uniform(size=(2, 6, 8)) > 0.2
            ).astype(np.float32)
    if mask_rank == 4:
        mask = np.repeat(mask[:, None], 3, axis=1)
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = tl.nor_loss(pt, torch.from_numpy(target), torch.from_numpy(mask))
    got.backward()
    jm = jnp.asarray(mask if mask_rank == 3 else np.moveaxis(mask, 1, -1))
    want, g = jax.value_and_grad(jl.nor_loss)(_nhwc(pred), _nhwc(target), jm)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(pt.grad.numpy(), np.moveaxis(np.asarray(g),
                                                            -1, 1), **TOL)
    assert float(pt.grad[:, :, :3].abs().max()) == 0.0  # the gated rows
    # the gate counts too: with nothing gated the loss is another one
    ungated = tl.nor_loss(torch.from_numpy(_normals(6)),
                          torch.from_numpy(target), torch.from_numpy(mask))
    assert abs(float(ungated) - float(got.detach())) > 1e-3


@pytest.mark.parametrize("weight", [None, 3.5])
def test_manhattan_loss_matches_jax(weight):
    """floor (+y), wall (|cos y| -> 0) and ceiling (-y) on the argmax
    classes of the logits; weight None gives the unscaled terms (the
    reference returned None there)."""
    r = np.random.RandomState(9)
    normal = _normals(10)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    logits = r.normal(size=(2, 14, 6, 8)).astype(np.float32)
    labels = r.choice([3, 5, 12, 0], size=(2, 6, 8))
    logits[np.arange(2)[:, None, None], labels, np.arange(6)[None, :, None],
           np.arange(8)[None, None, :]] += 10.0
    nt = torch.from_numpy(normal).requires_grad_(True)
    got = tl.manhattan_loss(nt, torch.from_numpy(logits), None, 12, 5, 3,
                            weight)
    sum(got).backward()
    want, g = jax.value_and_grad(
        lambda n: sum(jl.manhattan_loss(n, _nhwc(logits), None, 12, 5, 3,
                                        weight)))(_nhwc(normal))
    parts = jl.manhattan_loss(_nhwc(normal), _nhwc(logits), None, 12, 5, 3,
                              weight)
    assert all(float(p.detach()) > 0 for p in got)
    for a, b in zip(got, parts):
        np.testing.assert_allclose(float(a.detach()), float(b), **TOL)
    np.testing.assert_allclose(nt.grad.numpy(), np.moveaxis(np.asarray(g),
                                                            -1, 1), **TOL)


def test_pepper_noise_matches_jax_with_its_draw():
    """The JAX draw (the batch uniform and the field, from the split of
    its key) handed to the port gives the same image; the gradient flows
    only through the pixels left as they were."""
    from rdfc_gan_torch.utils.image_ops import add_pepper_noise
    from rdfc_gan_tpu.utils.image_ops import add_pepper_noise as j_pepper

    img = np.random.RandomState(11).uniform(-0.9, 0.9, (2, 1, 16, 20)).astype(
        np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k_active, k_mask = jax.random.split(key)
        active = float(jax.random.uniform(k_active))
        u = np.asarray(jax.random.uniform(k_mask, (2, 16, 20, 1)))
        it = torch.from_numpy(img).requires_grad_(True)
        got = add_pepper_noise(it, torch.tensor(active),
                               torch.from_numpy(np.moveaxis(u, -1, 1).copy()))
        want = j_pepper(_nhwc(img), key)
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.moveaxis(np.asarray(want), -1, 1))
        got.sum().backward()
        changed = (got.detach() != it.detach()).numpy()
        assert changed.any() == (active < 0.9)
        np.testing.assert_array_equal(it.grad.numpy(), (~changed).astype(
            np.float32))
