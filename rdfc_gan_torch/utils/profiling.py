"""Profiling and timing harness (port of rdfc_gan_tpu/utils/profiling.py).

  * ``trace(dir)``: a ``torch.profiler`` session (CPU, and CUDA when a card
    is present) around the block, written as a Chrome trace
    ``dir/trace_<pid>_<n>.json`` (open it in chrome://tracing or Perfetto);
    a no-op when ``dir`` is falsy;
  * ``span(name)``: a named range of the program (``rdfc.serve``, one per
    served net, ``rdfc.nlspn_block``, the train step's loss and update
    phases) that a profiler session records beside its own events, on
    its clock; a shared no-op context when no session records;
  * ``fps_harness``: images per second over ``n_images`` after ``warmup``
    calls, each call followed by a device synchronize (the reference's
    ``--cal_fps`` protocol, RDF-GAN/lib/tools/main.py:318-350).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable, Iterable, Optional

import torch
from torch.profiler import record_function

_TRACES = itertools.count()
_NULL = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler session records, else a
    shared no-op context. ``record_function`` costs about 11 us an enter
    and exit even with no session on; the guard, a fraction of a
    microsecond. An export outside a profiler session takes no span into
    its graph (strict export folds the guard to False). Names start with
    ``rdfc.``, which no ATen op's name does."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NULL


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
