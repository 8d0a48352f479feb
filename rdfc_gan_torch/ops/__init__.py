"""NLSPN ops: offsets/affinities, the stencil and gather propagations,
and the CUDA kernels behind them; the general deformable ops (DCNv2's
gather and convolution, the deformable PS-ROI pooling)."""

# first: it registers the served kernels' ops, and its nlspn_kernel
# imports nlspn_stencil, which imports its mask_kernel
from . import kernels  # noqa: F401
from .deform import (bilinear_sample, deform_gather, kernel_grid_offsets,
                     modulated_deform_conv)
from .deform_roi import deform_psroi_pooling
from .nlspn import (NLSPNParamsSpec, nlspn_propagate, nlspn_refine,
                    precompute_taps)
from .nlspn_stencil import nlspn_refine_stencil

__all__ = [
    "bilinear_sample",
    "deform_gather",
    "modulated_deform_conv",
    "kernel_grid_offsets",
    "NLSPNParamsSpec",
    "nlspn_propagate",
    "precompute_taps",
    "deform_psroi_pooling",
    "nlspn_refine",
    "nlspn_refine_stencil",
]
