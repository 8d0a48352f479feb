"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions.

Importing this package registers the dispatcher ops of the served path
(``rdfc_gan_torch::shift_mask_scatter``, ``::nlspn_propagate`` and
``::instance_norm_fwd``): a host that loads an exported program of the
port imports it first."""

from . import build, mask_kernel, norm_kernel  # noqa: F401
from . import nlspn_kernel  # noqa: F401  (after mask_kernel: it imports it)
