"""CycleGAN-style ResnetGenerator, the flagship's G_B2A: depth -> RGB (port
of rdfc_gan_tpu/models/resnet_generator.py; reference lib/models/generator/
resnet_generator.py:6-100), NCHW.

Reflect-padded 7x7 stem (LeakyReLU 0.01), two stride-2 3x3 downs (PReLU),
``n_blocks`` residual blocks (reflect pad, 3x3, norm, LeakyReLU 0.01,
reflect pad, 3x3, norm, plus the input), two transposed-conv ups with the
``ConvTranspose2d(3, 2, 1, 1)`` geometry (PReLU), a reflect-padded 7x7 head
and tanh. Under ``IN2d`` (the shipped config) every norm is the instance
norm of ``ops/kernels/norm_kernel`` (the IN kernels on the card) and the
convs carry a bias; under ``BN`` the norms are ``BatchNorm2d`` and the convs
have none. The output convs carry a bias either way.

State-dict names are the reference's single ``model`` Sequential
(tools/torch_ref_models.py:TorchResnetGenerator): ``model.1`` the stem,
``model.4`` / ``model.7`` the downs and ``model.6`` / ``model.9`` their
PReLUs, ``model.{10 + i}.conv_block.{1,5}`` the blocks, ``model.{10 + n}``
/ ``model.{13 + n}`` the ups and ``model.{12 + n}`` / ``model.{15 + n}``
their PReLUs, ``model.{17 + n}`` the head. Conv weights start N(0, 0.02)
(layers.py:gan_kernel_init), biases at zero. ``packed_width`` is a TPU
layout and is read and ignored; ``use_dropout`` is read and ignored, as
the JAX block ignores it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels.norm_kernel import instance_norm
from ..registry import GENERATORS
from .layers import BatchNorm2d, PReLU, reflect_pad


class ReflectionPad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.pad)


class InstanceNorm(nn.Module):
    """Affine-free instance norm, eps 1e-5 (nn.InstanceNorm2d's defaults)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _norm(kind: str, c: int) -> nn.Module:
    if kind.lower() == "in2d":
        return InstanceNorm()
    return BatchNorm2d(c, eps=1e-5)


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
          bias: bool = True) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride, padding, bias=bias)
    nn.init.normal_(conv.weight, 0.0, 0.02)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "IN2d"):
        super().__init__()
        bias = norm.lower() == "in2d"
        self.conv_block = nn.Sequential(
            ReflectionPad(1), _conv(dim, dim, 3, bias=bias), _norm(norm, dim),
            nn.LeakyReLU(0.01), ReflectionPad(1),
            _conv(dim, dim, 3, bias=bias), _norm(norm, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    def __init__(self, input_channels: int = 1, output_channels: int = 3,
                 ngf: int = 64, norm_layer: str = "IN2d",
                 use_dropout: bool = False, n_blocks: int = 6,
                 padding_type: str = "reflect", axis_name=None,
                 packed_width: bool = False):
        super().__init__()
        if padding_type != "reflect":
            raise NotImplementedError(f"padding_type {padding_type!r}: the "
                                      f"port builds reflect padding only")
        if norm_layer.lower() not in ("in2d", "bn", "bn2d"):
            raise NotImplementedError(f"norm_layer {norm_layer!r}")
        bias = norm_layer.lower() == "in2d"
        layers = [ReflectionPad(3), _conv(input_channels, ngf, 7, bias=bias),
                  _norm(norm_layer, ngf), nn.LeakyReLU(0.01)]
        for i in range(2):
            m = 2 ** i
            layers += [_conv(ngf * m, ngf * m * 2, 3, 2, 1, bias=bias),
                       _norm(norm_layer, ngf * m * 2), PReLU()]
        layers += [ResnetBlock(ngf * 4, norm_layer) for _ in range(n_blocks)]
        for i in range(2):
            m = 2 ** (2 - i)
            up = nn.ConvTranspose2d(ngf * m, ngf * m // 2, 3, 2, 1, 1,
                                    bias=bias)
            nn.init.normal_(up.weight, 0.0, 0.02)
            if bias:
                nn.init.zeros_(up.bias)
            layers += [up, _norm(norm_layer, ngf * m // 2), PReLU()]
        layers += [ReflectionPad(3), _conv(ngf, output_channels, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, input_channels, H, W), H and W divisible by 4 -> (B,
        output_channels, H, W) in [-1, 1]."""
        return self.model(x)


GENERATORS.register("ResnetGenerator")(ResnetGenerator)
