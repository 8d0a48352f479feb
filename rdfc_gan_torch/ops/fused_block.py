"""The train-mode ResNet BasicBlock with an identity shortcut as one
``torch.autograd.Function`` on the fused conv kernels (port of
attic/fused_block.py:basic_block_fused, which chained the TPU kernels, with
the rounding of the JAX package's live block, rdfc_gan_tpu/models/
resnet.py:BasicBlock and models/layers.py:_bn_train_fwd_impl):

    out = relu(bn2(conv2(relu(bn1(conv1(x))))) + x)

in x's type T. Each BN takes f32 batch statistics of its input as stored
in T: mean = E[y], var = max(E[y^2] - mean^2, 0), a = gamma rsqrt(var +
eps), b = beta - mean a (f32), and applies T(T(y T(a)) + T(b)); the
residual is added in T. The weights, gammas and betas are rounded to T,
as autocast's conv and the JAX train step's cast of every parameter do;
their gradients are f32.

Forward: conv1 with its moments; BN1 folded into conv2's prologue with the
ReLU; conv2 with its moments; the epilogue. Backward: one reduction pass
for BN2's sums, then ``conv3x3_bwd`` for conv2 (BN2's finalize, ReLU',
BN1's sums), then for conv1 (BN1's finalize, the residual's gradient as the
carry). It returns the batch means and biased variances for the module's
running statistics.

At a world size above 1 (``parallel``) the statistics are the global
batch's, as the JAX block's under ``axis_name``: the f64 (2, C) moment
totals of each conv are summed over the ranks between the kernel launches
(conv1's before conv2's forward launch) and divided by the global count,
and in the backward BN2's sums before conv2's ``conv3x3_bwd`` and BN1's
between the two. The sums stay f64 across the wire. The gamma and beta
gradients stay this rank's sums, which the gradient all-reduce adds.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel import all_reduce_sum, world_size
from .kernels.conv_block_kernel import conv3x3_bwd, conv3x3_fwd


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _over_batch(m: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) f64 per-image sums -> (2, C), added over b in turn."""
    tot = m[0]
    for b in range(1, m.shape[0]):
        tot = tot + m[b]
    return tot


def _global(s: torch.Tensor) -> torch.Tensor:
    """``s`` summed over the ranks, in a new tensor (``s`` itself at world
    1)."""
    return s if world_size() == 1 else all_reduce_sum(s.clone())


def _stats(mom: torch.Tensor, n: int):
    """(mean, var) f32 of the conv output from its f64 moments, over the
    global batch; ``n`` is the global count."""
    tot = _global(_over_batch(mom))
    mean = (tot[0] / n).float()
    var = torch.clamp_min((tot[1] / n).float() - mean * mean, 0.0)
    return mean, var


def _affine(mean, var, gamma, beta, eps, dt):
    """(inverse std, a, b) f32 of a train-mode BN, gamma and beta rounded
    to the activation type dt first (models.layers.BatchNorm2d)."""
    inv = torch.rsqrt(var + eps)
    a = gamma.detach().to(dt).float() * inv
    return inv, a, beta.detach().to(dt).float() - mean * a


def _finalize(a, s, n, mean, inv):
    """BN-backward rows (A, C1, C2, MU, IS) from the per-channel sums s =
    (sum dn, sum dn * xhat): dy = A dn - C1 - xhat C2."""
    ad = a.double()
    return torch.stack([a, (ad * s[0] / n).float(), (ad * s[1] / n).float(),
                        mean, inv])


class _BasicBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, g1, b1, w2, g2, b2, eps):
        B, C, H, W = x.shape
        n = B * H * W * world_size()
        dt = x.dtype
        y1, mom1 = conv3x3_fwd(x, w1)
        m1, v1 = _stats(mom1, n)
        inv1, a1, c1 = _affine(m1, v1, g1, b1, eps, dt)
        y2, mom2 = conv3x3_fwd(y1, w2, a1, c1, "relu")
        m2, v2 = _stats(mom2, n)
        inv2, a2, c2 = _affine(m2, v2, g2, b2, eps, dt)
        out = torch.relu(y2 * _col(a2.to(dt)) + _col(c2.to(dt)) + x)
        ctx.save_for_backward(x, w1, w2, y1, y2, out, m1, inv1, a1, c1, m2,
                              inv2, a2)
        ctx.mark_non_differentiable(m1, v1, m2, v2)
        return out, m1, v1, m2, v2

    @staticmethod
    def backward(ctx, d_out, *_):
        (x, w1, w2, y1, y2, out, m1, inv1, a1, c1, m2, inv2,
         a2) = ctx.saved_tensors
        B, C, H, W = x.shape
        n = B * H * W * world_size()
        dt = x.dtype
        dn2 = torch.where(out > 0, d_out.to(dt),
                          torch.zeros((), dtype=dt, device=x.device))
        dn2 = dn2.contiguous()
        xhat2 = (y2.float() - _col(m2)) * _col(inv2)
        dd = dn2.double()
        s2 = torch.stack([dd.sum((0, 2, 3)),
                          (dd * xhat2.double()).sum((0, 2, 3))])
        dn1, dw2, sums1 = conv3x3_bwd(dn2, y1, w2, a1, c1, "relu", y=y2,
                                      fin=_finalize(a2, _global(s2), n, m2,
                                                    inv2),
                                      xh=(m1, inv1))
        s1 = _over_batch(sums1)
        dx, dw1, _ = conv3x3_bwd(dn1, x, w1, y=y1,
                                 fin=_finalize(a1, _global(s1), n, m1, inv1),
                                 carry=dn2)
        return (dx, dw1.to(w1.dtype), s1[1].float(), s1[0].float(),
                dw2.to(w2.dtype), s2[1].float(), s2[0].float(), None)


def basic_block(x: torch.Tensor, w1, g1, b1, w2, g2, b2, eps: float = 1e-5
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x: (B, C, H, W) f32 or bf16; w1, w2: (C, C, 3, 3); g, b: (C,) BN
    scale and shift. Returns (out in x's type, (mean1, var1, mean2, var2)
    f32, the batch statistics for the running update)."""
    out, m1, v1, m2, v2 = _BasicBlock.apply(x.contiguous(), w1, g1, b1, w2,
                                            g2, b2, eps)
    return out, (m1, v1, m2, v2)
