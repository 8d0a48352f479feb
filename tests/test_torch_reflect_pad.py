"""The G_B2A reflect pad (``rdfc_gan_torch/models/layers.py``
``reflect_pad``): its values are ``F.pad``'s in a contiguous tensor, its
backward is the JAX VJP's fold (``rdfc_gan_tpu/models/layers.py``
``_reflect_fold``) bit for bit on the CPU, and on the card two backward
passes of a G_B2A are bit-equal (the CUDA backward of ``F.pad`` adds with
atomics). The JAX package is imported inside the CPU test only: the card's
machine has no flax."""

import numpy as np
import pytest
import torch

from rdfc_gan_torch.models import ResnetGenerator
from rdfc_gan_torch.models.layers import reflect_pad

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)


@pytest.mark.parametrize("shape,pad", [((2, 3, 9, 11), 1), ((2, 1, 16, 24), 3),
                                       ((1, 2, 4, 5), 3), ((2, 4, 7, 6), 2)])
def test_reflect_pad_backward_is_the_jax_fold(shape, pad):
    """The pad's values are ``F.pad``'s in a contiguous tensor; its
    gradient is the JAX VJP's (``_reflect_fold`` over H, then W), bit for
    bit in f32, also where the two border strips overlap (pad = W - 1)."""
    import jax.numpy as jnp

    from rdfc_gan_tpu.models.layers import _reflect_fold

    r = np.random.RandomState(sum(shape) + pad)
    x = r.normal(size=shape).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    y = reflect_pad(tx, pad)
    assert y.is_contiguous() and y.stride()[-1] == 1
    assert y.stride()[1] == y.shape[2] * y.shape[3]
    np.testing.assert_array_equal(
        y.detach().numpy(), torch.nn.functional.pad(
            torch.from_numpy(x), (pad,) * 4, mode="reflect").numpy())
    g = r.normal(size=y.shape).astype(np.float32)
    y.backward(torch.from_numpy(g))
    want = _reflect_fold(_reflect_fold(jnp.asarray(g.transpose(0, 2, 3, 1)),
                                       pad, 1), pad, 2)
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(want).transpose(0, 3, 1, 2))


@pytest.mark.gpu
def test_g_b2a_backward_repeats_on_card():
    """Two bf16 forward + backward passes of a G_B2A (the flagship's ngf 64,
    6 blocks, at 64x96) give bit-equal input and parameter gradients
    under deterministic cuDNN: the reflect pads add their border gradients
    in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from rdfc_gan_torch.utils import set_random_seed

    set_random_seed(0, deterministic=True)
    net = ResnetGenerator(input_channels=1, output_channels=3).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((4, 1, 64, 96), device="cuda", generator=gen)
    w = torch.randn((4, 3, 64, 96), device="cuda", generator=gen)

    def grads():
        net.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = net(xi)
        (out.float() * w).sum().backward()
        return [xi.grad] + [p.grad.clone() for p in net.parameters()]

    a, b = grads(), grads()
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v), i
