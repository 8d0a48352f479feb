"""The precisions the reference can run in: ``f32`` (full f32, TF32 off:
the reference itself), and the controls one step below what a
configuration states, which the comparison deciding ``correct`` has to
fail, on any device:

  * ``tf32`` below an f32 path: the inputs and weights of every
    convolution and matrix product rounded to TF32 (10 mantissa bits, to
    nearest), as the tensor cores' TF32 mode reads them, the products
    summed in f32;
  * ``fp8`` below a bf16 autocast path, as bf16 autocast is below f32:
    the inputs and weights of every convolution and matrix product scaled
    by 448 over their largest magnitude, rounded to float8 e4m3 and
    scaled back, and in the backward the gradient that reaches the
    product's output rounded to e5m2 the same way (the operand of both
    backward products), as fp8 training casts them; everything else
    stays f32, as autocast keeps it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

PRECISIONS = ("f32", "tf32", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _through(t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``r`` in the forward, the identity's gradient in the backward (the
    rounding is the operand's, the products' gradients are f32)."""
    return t + (r - t).detach()


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value, kept in f32 (ties away from zero)."""
    bits = t.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return _through(t, bits.view(torch.float32).to(t.dtype))


def _scaled_fp8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` scaled by ``top`` over its largest magnitude, rounded to the
    float8 ``dtype`` and scaled back."""
    d = t.detach().float()
    scale = top / d.abs().max().clamp_min(1e-30)
    return ((d * scale).to(dtype).float() / scale).to(t.dtype)


def grad_e5m2(g: torch.Tensor) -> torch.Tensor:
    """A gradient rounded to e5m2 with its own per-tensor scale."""
    return _scaled_fp8(g, torch.float8_e5m2, E5M2_MAX)


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    return _through(t, _scaled_fp8(t, torch.float8_e4m3fn, E4M3_MAX))


class _RoundedOperands(TorchFunctionMode):
    """Round the first two operands (input, weight) of every convolution
    and matrix product with ``rounding``; with ``grad`` also round the
    gradient that reaches each product's output (a hook on it)."""

    OPS = (F.conv2d, F.conv_transpose2d, F.linear, torch.matmul,
           torch.Tensor.matmul, torch.Tensor.__matmul__, torch.einsum)

    def __init__(self, rounding, grad=None):
        super().__init__()
        self.rounding = rounding
        self.grad = grad

    def _round(self, a):
        if isinstance(a, torch.Tensor) and a.dtype.is_floating_point:
            return self.rounding(a)
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum:
            args = (args[0],) + tuple(self._round(a) for a in args[1:])
        elif func in self.OPS:
            args = tuple(self._round(a) if i < 2 else a
                         for i, a in enumerate(args))
        else:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if self.grad is not None and out.requires_grad:
            out.register_hook(self.grad)
        return out


@contextlib.contextmanager
def precision(name: str):
    """Run the block in ``name``: f32, tf32 or fp8; TF32 is off in the
    library either way."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r} not in {PRECISIONS}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if name == "f32":
            yield
        elif name == "tf32":
            with _RoundedOperands(round_tf32):
                yield
        else:
            with _RoundedOperands(round_e4m3, grad_e5m2):
                yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
