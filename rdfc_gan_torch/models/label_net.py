"""PSPNet, the semantic-label net G_label (port of
rdfc_gan_tpu/models/label_net.py; reference lib/models/generator/
label_net/): the deep stem and a dilated ResNet (output stride 8), a
pyramid pooling module with bins 1, 2, 3, 6, a 1x1 class conv and an
align-corners resize back to the input size. In train mode, or with
``force_aux``, it also returns the auxiliary head on layer3.

State-dict names are the reference's (labels_model.py:44-96):
``initial.*`` (``DeepStem``), ``layer1..4``, ``master_branch.0.stages.{i}.
{1,2}``, ``master_branch.0.bottleneck.{0,1}``, ``master_branch.1`` and
``auxiliary_branch.{0,1,4}``. The pooling (``AdaptiveAvgPool``) is
torch's ``AdaptiveAvgPool2d``, whose windows [floor(i H / b),
ceil((i + 1) H / b)) the JAX ``_adaptive_avg_pool`` copies, written as
two pooling matmuls: ``AdaptiveAvgPool2d``'s CUDA backward adds the
overlapping windows' gradients with atomics, in an order that changes from
run to run, and the JAX package's gradient is deterministic.

The two ``Dropout2d(0.1)`` layers (after the PSP bottleneck and in the aux
head) are the JAX ``nn.Dropout(0.1, broadcast_dims=(1, 2))``: one keep flag
per (b, c), x / 0.9 where kept, the identity in eval mode. In train mode
``forward`` takes the keep masks (``keep``, shapes from
``dropout_shapes``); without them each layer draws its own from torch's
global generator. The JAX flagship step applies G_label twice with one
dropout key, so both applications drop the same channels; the engine
hands the same masks to both.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..parallel import spatial
from .layers import BatchNorm2d, bilinear_resize
from .resnet import DeepStem, make_stages


class Dropout2d(nn.Module):
    """Channel dropout: where(keep, x / (1 - p), 0) with ``keep`` (B, C, 1,
    1) bool, set by the owner for one forward, or drawn as uniform < 1 - p
    when it is None."""

    def __init__(self, p: float = 0.1):
        super().__init__()
        self.p = p
        self.keep: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        keep = self.keep
        if keep is None:
            keep = torch.rand((x.shape[0], x.shape[1], 1, 1),
                              device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def _pool_matrix(src: int, out: int) -> np.ndarray:
    """(out, src): row i averages the window [floor(i src / out),
    ceil((i + 1) src / out)), never empty."""
    m = np.zeros((out, src), np.float32)
    for i in range(out):
        lo, hi = (i * src) // out, -(-((i + 1) * src) // out)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


class AdaptiveAvgPool(nn.Module):
    """``AdaptiveAvgPool2d(b)`` as one f32 contraction with the row and the
    column pooling matrices, rounded once to x's type: the same windows,
    and a backward of matrix products, the same on every run. Under a
    width-sharded forward each rank contracts its image columns with
    theirs of the global matrix and the sums are summed over the row."""

    def __init__(self, b: int):
        super().__init__()
        self.b = b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = spatial.plane_size(x)
        ph, pw = _pool_matrix(H, self.b), _pool_matrix(W, self.b)
        if spatial.active() is not None:
            # this rank's image columns, then the partial sums summed over
            # the row: the bins come out whole on every rank
            x, pw = spatial.width_matrix(pw, x)
        ph, pw = (torch.from_numpy(m).to(x.device) for m in (ph, pw))
        out = torch.einsum("ih,bchw,jw->bcij", ph, x.float(), pw)
        if spatial.active() is not None:
            out = spatial.width_sum(out)
        return out.to(x.dtype)


class PSPModule(nn.Module):
    def __init__(self, cin: int, bin_sizes: Sequence[int] = (1, 2, 3, 6)):
        super().__init__()
        c = cin // len(bin_sizes)
        self.stages = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(b),
                          nn.Conv2d(cin, c, 1, bias=False),
                          BatchNorm2d(c, eps=1e-5), nn.ReLU())
            for b in bin_sizes)
        self.bottleneck = nn.Sequential(
            nn.Conv2d(cin + c * len(bin_sizes), c, 1),
            BatchNorm2d(c, eps=1e-5), nn.ReLU(), Dropout2d(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = spatial.plane_size(x)
        # a bin's map is whole on every rank of a width-sharded forward
        pyramids = [x] + [bilinear_resize(s(x), size, align_corners=True,
                                          replicated=True)
                          for s in self.stages]
        return self.bottleneck(torch.cat(pyramids, dim=1))


class PSPNet(nn.Module):
    def __init__(self, num_classes: int = 14, backbone_depth: int = 50,
                 planes: Sequence[int] = (64, 128, 256, 512),
                 stem_features: int = 64):
        super().__init__()
        p = list(planes)
        self.initial = DeepStem(stem_features)
        self.layer1, self.layer2, self.layer3, self.layer4 = make_stages(
            f"resnet{backbone_depth}", 2 * stem_features, p, dilated=True)
        exp = self.layer4[0].expansion
        self.master_branch = nn.Sequential(
            PSPModule(p[3] * exp), nn.Conv2d(p[3] * exp // 4, num_classes, 1))
        self.auxiliary_branch = nn.Sequential(
            nn.Conv2d(p[2] * exp, p[3], 3, padding=1, bias=False),
            BatchNorm2d(p[3], eps=1e-5), nn.ReLU(), Dropout2d(0.1),
            nn.Conv2d(p[3], num_classes, 1))

    def _dropouts(self) -> Tuple[Dropout2d, Dropout2d]:
        return self.master_branch[0].bottleneck[3], self.auxiliary_branch[3]

    def dropout_shapes(self, batch: int) -> Tuple[tuple, tuple]:
        """The (B, C, 1, 1) shapes of the two keep masks."""
        return tuple((batch, d_in.out_channels, 1, 1) for d_in in (
            self.master_branch[0].bottleneck[0], self.auxiliary_branch[0]))

    def forward(self, x: torch.Tensor, force_aux: bool = False,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """x (B, 3, H, W) -> class logits (B, num_classes, H, W); with the
        aux head (train mode or ``force_aux``) the list [main, aux].
        ``keep``: the two dropouts' keep masks for a train-mode forward."""
        drops = self._dropouts()
        for d, k in zip(drops, keep or (None, None)):
            d.keep = k
        try:
            return self._forward(x, force_aux)
        finally:
            for d in drops:
                d.keep = None

    def _forward(self, x: torch.Tensor, force_aux: bool):
        size = spatial.plane_size(x)
        h = self.layer2(self.layer1(self.initial(x)))
        x_aux = self.layer3(h)
        out = bilinear_resize(self.master_branch(self.layer4(x_aux)), size,
                              align_corners=True)
        if self.training or force_aux:
            return [out, bilinear_resize(self.auxiliary_branch(x_aux), size,
                                         align_corners=True)]
        return out
