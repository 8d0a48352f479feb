"""Profiling and timing harness (port of rdfc_gan_tpu/utils/profiling.py).

  * ``trace(dir)``: a ``torch.profiler`` session (CPU, and CUDA when a card
    is present) around the block, written as a Chrome trace
    ``dir/trace_<pid>_<n>.json`` (open it in chrome://tracing or Perfetto);
    a no-op when ``dir`` is falsy;
  * ``fps_harness``: images per second over ``n_images`` after ``warmup``
    calls, each call followed by a device synchronize (the reference's
    ``--cal_fps`` protocol, RDF-GAN/lib/tools/main.py:318-350);
  * ``StepTimer``: rolling step-time statistics for the train loop.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable, Iterable, Optional

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block into a Chrome trace under ``log_dir``; no-op when
    ``log_dir`` is falsy. The block's device work is synchronized before
    the trace is written."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def fps_harness(forward: Callable, batches: Iterable, n_images: int = 300,
                warmup: int = 5) -> float:
    """img/s of ``forward(batch)`` over ``n_images`` images after ``warmup``
    discarded calls, cycling through ``batches``; each call is followed by
    a device synchronize. A batch's size is its ``rgb``'s first dimension."""
    it = iter(batches)
    batch = next(it)
    for _ in range(warmup):
        forward(batch)
        _sync()
    done = 0
    t0 = time.perf_counter()
    while done < n_images:
        try:
            batch = next(it)
        except StopIteration:
            it = iter(batches)
            batch = next(it)
        forward(batch)
        _sync()
        done += batch["rgb"].shape[0]
    return done / (time.perf_counter() - t0)


class StepTimer:
    """Rolling mean/max step time over the last ``window`` ticks; host-side,
    negligible overhead."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(len(self.times), 1)

    @property
    def max_ms(self) -> float:
        return 1e3 * max(self.times) if self.times else 0.0
