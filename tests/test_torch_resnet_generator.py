"""Parity of the port's ResnetGenerator (the flagship's G_B2A) with the JAX
package, on the CPU, at the ``rdfc_gan_tiny.yaml`` sizes (ngf 8, 2 blocks,
IN2d): the forward and the gradients of the input and of every parameter,
from the port's seeded weights through the reference converter

(``tools/convert_torch_ckpt.py:convert_resnet_generator``); the port's
inverse converter; the state-dict names against the reference layout.

Tolerances: the forward rtol 1e-3 / atol 1e-4 (the other port parity
tests); gradients within 2e-4 of each tensor's largest entry plus 5e-6
(tests/test_torch_train_step.py), except the conv biases that feed an
instance norm, whose gradient is zero in exact arithmetic: on both sides
within 1e-5 of the largest gradient of the conv's weight.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfc_gan_torch.models import ResnetGenerator
from rdfc_gan_torch.models.layers import PReLU, reflect_pad
from rdfc_gan_torch.utils.convert import resnet_generator_state_dict_from_jax
from rdfc_gan_tpu.models.resnet_generator import \
    ResnetGenerator as JResnetGenerator

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_torch_ckpt import convert_resnet_generator  # noqa: E402

# Tier-1 runs several pytest workers on the machine's cores; with
# torch's default of one intra-op thread per core, each small op waits
# for threads the other workers keep off the cores (tens of times
# slower). One thread per worker.
torch.set_num_threads(1)

KW = dict(input_channels=1, output_channels=3, ngf=8, n_blocks=2)
H, W = 32, 48


def norm_fed_biases(module):
    """Names of the conv biases that feed a batch or instance norm
    directly: their gradient is zero in exact arithmetic (the norm removes
    any per-channel constant)."""
    from rdfc_gan_torch.models.layers import BatchNorm2d
    from rdfc_gan_torch.models.resnet_generator import InstanceNorm

    convs = (torch.nn.Conv2d, torch.nn.ConvTranspose2d)
    out = set()
    for prefix, m in module.named_modules():
        kids = list(m.named_children())
        for (a, conv), (_, nxt) in zip(kids, kids[1:]):
            if isinstance(conv, convs) and conv.bias is not None and \
                    isinstance(nxt, (BatchNorm2d, InstanceNorm)):
                out.add(f"{prefix}.{a}.bias".lstrip("."))
    return out


def _grad_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max() + 5e-6,
                               err_msg=name)


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    tm = ResnetGenerator(**KW)
    with torch.no_grad():  # PReLU slopes and biases off their init values
        for name, p in tm.named_parameters():
            if p.dim() <= 1:
                p.uniform_(-0.3, 0.3)
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    tree = convert_resnet_generator(sd, n_blocks=KW["n_blocks"])
    return tm, tree["params"]


def test_state_dict_is_the_reference_layout_and_converts_back(nets):
    from torch_ref_models import TorchResnetGenerator

    tm, params = nets
    ref = TorchResnetGenerator(in_ch=1, out_ch=3, ngf=8, n_blocks=2)
    assert {k: v.shape for k, v in tm.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    back = resnet_generator_state_dict_from_jax(
        jax.tree.map(np.asarray, params))
    sd = tm.state_dict()
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_forward_and_gradients_match_jax(nets):
    tm, params = nets
    r = np.random.RandomState(1)
    x = r.uniform(-1, 1, (2, 1, H, W)).astype(np.float32)
    wr = r.normal(size=(2, 3, H, W)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    tm.zero_grad()
    out = tm.train()(xt)
    (out * torch.from_numpy(wr)).sum().backward()

    jm = JResnetGenerator(**KW)

    def loss(p, xj):
        o = jm.apply({"params": p}, xj, train=True)
        return jnp.sum(o * jnp.asarray(wr.transpose(0, 2, 3, 1))), o

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert tuple(out.shape) == (2, 3, H, W)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=1e-4)
    _grad_close(xt.grad.numpy(), np.asarray(gx).transpose(0, 3, 1, 2), "x")
    want_sd = resnet_generator_state_dict_from_jax(
        jax.tree.map(np.asarray, gp))
    zero = norm_fed_biases(tm)
    assert len(zero) == 9  # every conv bias but the head's
    n = 0
    for name, p in tm.named_parameters():
        got, want = p.grad.numpy(), want_sd[name].numpy()
        if name in zero:
            # zero in exact arithmetic: rounding noise on both sides, seen
            # within 1.1e-6 of the largest gradient of the conv's weight
            scale = np.abs(want_sd[name[:-4] + "weight"].numpy()).max()
            assert max(np.abs(got).max(), np.abs(want).max()) \
                <= 1e-5 * scale, name
        else:
            _grad_close(got, want, name)
        n += 1
    assert n == len(want_sd) == 24


def test_reflect_pad_and_prelu():
    x = torch.arange(12.0).reshape(1, 1, 3, 4).requires_grad_(True)
    y = reflect_pad(x, 1)
    np.testing.assert_array_equal(
        y.detach().numpy()[0, 0],
        np.pad(x.detach().numpy()[0, 0], 1, mode="reflect"))
    y.sum().backward()  # border pixels are read twice or four times
    assert float(x.grad.sum()) == y.numel()
    a = PReLU()
    assert a.weight.shape == (1,) and float(a.weight.detach()) == 0.25
    z = torch.tensor([-2.0, 0.0, 3.0], dtype=torch.bfloat16)
    assert a(z).dtype == torch.bfloat16
    np.testing.assert_array_equal(a(z).float().detach().numpy(),
                                  [-0.5, 0.0, 3.0])

