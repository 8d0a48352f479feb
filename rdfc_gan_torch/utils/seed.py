"""Deterministic seeding (reference: lib/utils/seed_all.py:6-22; the JAX
package's ``utils/seed.py:15`` signature): the host-side python/numpy RNGs
of the data pipeline and torch's generators. With ``deterministic`` cuDNN
picks deterministic algorithms and benchmark mode is off, as the
reference's seed_all does. Every rank seeds with the same seed, as JAX
replicates one key: the ranks build the same nets, and the per-step draws
are the global batch's on each."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int, deterministic: bool = False):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
