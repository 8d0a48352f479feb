"""The PSP pooling of G_label (``models/label_net.AdaptiveAvgPool``):
``AdaptiveAvgPool2d`` written as pooling matmuls, so that its gradient on
the card is the same on every run (torch's CUDA backward adds overlapping
windows with atomics; the JAX package's pooling is deterministic). No JAX
here, so the gpu test runs on the card machine too.
"""

import numpy as np
import pytest
import torch

from rdfc_gan_torch.models.label_net import AdaptiveAvgPool

# one intra-op thread per Tier-1 worker (see tests/test_torch_label_net.py)
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(2, 8, 28, 38), (1, 3, 5, 7)])
@pytest.mark.parametrize("b", [1, 2, 3, 6])
def test_adaptive_pool_is_torchs_adaptive_avg_pool(shape, b):
    """The PSP pooling (pooling matmuls, so that its CUDA backward has no
    atomics) computes ``AdaptiveAvgPool2d(b)`` and its gradient, to f32
    rounding: overlapping windows (28 / 3, 38 / 6) and bins past the
    map's size (6 > 5) included."""
    r = np.random.RandomState(3)
    x = torch.from_numpy(r.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(r.normal(size=shape[:2] + (b, b)).astype(
        np.float32))
    outs = []
    for pool in (AdaptiveAvgPool(b), torch.nn.AdaptiveAvgPool2d(b)):
        xt = x.clone().requires_grad_(True)
        y = pool(xt)
        y.backward(g)
        outs.append((y.detach(), xt.grad))
    for a, want in zip(*outs):
        torch.testing.assert_close(a, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_adaptive_pool_gradient_repeats_on_card():
    """On the card the PSP pooling's gradient is the same bits on every
    run (``AdaptiveAvgPool2d``'s is not where windows overlap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 512, 28, 38), device="cuda", generator=gen)
    grads = []
    for _ in range(5):
        for b in (1, 2, 3, 6):
            xt = x.clone().requires_grad_(True)
            y = AdaptiveAvgPool(b)(xt)
            y.backward(torch.ones_like(y))
            grads.append(xt.grad)
    for k in range(4, len(grads)):
        assert torch.equal(grads[k], grads[k % 4])
