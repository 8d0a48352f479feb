"""Served nets replayed as CUDA graphs (``torch.cuda.CUDAGraph``), so that a
request on the card is its input copy, one graph launch a net and its
output copies, and not the thousand-odd kernel launches a net's Python
issues one by one.

A served call is a list of stages, ``(span, fn)``: ``fn(*inputs, out)`` runs
one net on the call's inputs and on what earlier stages wrote into the dict
``out``, and writes its own maps there. ``run_stages`` runs them eagerly,
each inside its span (``utils.profiling.span``). ``ServedGraphs`` keeps,
for each input key, one graph a stage, and replays them.

When it engages (``ServedGraphs.engages``), decided only from what the call
shows: every input is a contiguous CUDA tensor, autograd is off, no
``torch.export`` or compile trace is running, and the current stream is
not itself being captured. The caller keeps any other path eager (a
width-sharded call, whose exchanges go through the host).

For each key, in order:

  1. the first call runs the stages eagerly on a side stream, so that
     cuDNN's plans and workspaces, cuBLAS's workspace and the hand
     kernels' lazy set-up are made outside any capture. A call in which
     the host waited on the device (a synchronizing CUDA operation, as
     ``torch.cuda.set_sync_debug_mode`` reports it: a host-built tensor
     copied to the card, an ``.item()``) cannot be captured, so its key
     stays eager;
  2. the next call copies its inputs into static inputs and captures each
     stage as one graph on that side stream, all of a key's graphs in one
     memory pool, in call order; a later stage's graph reads an earlier
     one's static outputs where they lie;
  3. every call replays the graphs in the same order, each inside its
     stage's span and a ``rdfc.graph_replay`` span, and returns device
     clones of the static outputs: the next call overwrites the static
     outputs, never a map a caller holds.

A key is the inputs' shapes, dtypes and device, the caller's own key (the
flagship's ``depth_only``), the identity of the served nets (a net swapped
for another object is captured anew) and the settings that choose kernels
or precisions (cuDNN's ``enabled``, ``benchmark``, ``deterministic`` and
TF32 flags, matmul's TF32, ``torch.use_deterministic_algorithms``, and
whether autocast is on for CUDA and to which dtype): a call under
deterministic cuDNN, or under autocast, replays only what was captured
under it. The warm-up and the capture run with autocast's cast cache off,
since a graph that read a cached cast would read it after the caller's
autocast block freed it. ``KEYS`` (4) keys are kept, the least recently
used dropped first, so that a validation set's short last batch pins no
memory for good.

A graph replays the kernels chosen at capture on the parameters' and
buffers' storage as it was then. Writes into that storage in place are
seen: an optimizer step, BatchNorm's running statistics,
``load_state_dict``, the only ways the engines and drivers load weights.
A parameter rebound to new storage (``.to`` another device,
``load_state_dict(assign=True)``) is not, and needs a new engine.

The hand kernels count their launches in ``ops.kernels.build.LAUNCHES``
as their wrappers run: in an eager call and in a capture, which records
each launch once, and not in a replay, which runs no wrapper.
``ServedGraphs.replayed`` counts the calls served by graphs captured in
an earlier call, so a caller relates the two.
"""

from __future__ import annotations

import collections
import contextlib
import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..utils.profiling import span

REPLAY = "rdfc.graph_replay"
# what torch's sync debug mode says of each synchronizing CUDA operation
SYNC_WARNING = "called a synchronizing CUDA operation"

Stage = Tuple[str, Callable[..., None]]


def run_stages(stages: Sequence[Stage], inputs: Sequence[torch.Tensor]
               ) -> dict:
    """The stages run eagerly in order, each inside its span; returns what
    they wrote."""
    out: dict = {}
    for name, fn in stages:
        with span(name):
            fn(*inputs, out)
    return out


def _kernel_flags() -> tuple:
    """The settings by which cuDNN, cuBLAS and ATen choose the kernels a
    capture records."""
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"))


@contextlib.contextmanager
def _no_cast_cache():
    """Autocast's cache of cast weights off inside the block."""
    was = torch.is_autocast_cache_enabled()
    torch.set_autocast_cache_enabled(False)
    try:
        yield
    finally:
        torch.set_autocast_cache_enabled(was)


def _tensors(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in _tensors(x)]
    return []


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, (tuple, list)):
        return type(v)(_clone(x) for x in v)
    return v


class _Entry:
    """One key's graphs: the nets they read (held, so their identities
    stay unique while the key lives), the static inputs and outputs and
    the graphs in call order; ``eager`` where the key's first call
    synchronized the host."""

    def __init__(self, nets: Tuple[torch.nn.Module, ...], eager: bool):
        self.nets = nets
        self.eager = eager
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self.out: dict = {}
        self.graphs: List[Tuple[str, torch.cuda.CUDAGraph]] = []


class ServedGraphs:
    """The served stages captured once a key and replayed (the module's
    docstring has the rules)."""

    KEYS = 4

    def __init__(self):
        self._entries: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        # calls served by graphs captured in an earlier call
        self.replayed = 0

    @staticmethod
    def engages(*inputs: torch.Tensor) -> bool:
        """Whether a call on ``inputs`` takes the graphs."""
        return (not torch.compiler.is_compiling()
                and not torch.is_grad_enabled()
                and all(t.is_cuda and t.is_contiguous() for t in inputs)
                and not torch.cuda.is_current_stream_capturing())

    def __len__(self) -> int:
        """Keys held, captured or eager."""
        return len(self._entries)

    def __call__(self, key: tuple, nets: Sequence[torch.nn.Module],
                 stages: Sequence[Stage], inputs: Sequence[torch.Tensor]
                 ) -> dict:
        """The stages' outputs for ``inputs`` (see the module's docstring):
        warmed up, captured or replayed by key. ``nets`` are the modules
        the stages read."""
        nets = tuple(nets)
        key = (tuple((t.shape, t.dtype) for t in inputs), inputs[0].device,
               key, tuple(map(id, nets)), _kernel_flags())
        entry = self._entries.get(key)
        if entry is None:
            out, synced = self._warm_up(stages, inputs)
            self._entries[key] = _Entry(nets, eager=synced)
            while len(self._entries) > self.KEYS:
                self._entries.popitem(last=False)
            return out
        self._entries.move_to_end(key)
        if entry.eager:
            return run_stages(stages, inputs)
        with torch.cuda.device(inputs[0].device):
            if entry.graphs:
                self.replayed += 1
            else:
                try:
                    self._capture(entry, stages, inputs)
                except BaseException:
                    # no half-captured key is ever replayed
                    del self._entries[key]
                    raise
            return self._replay(entry, inputs)

    def _side(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _warm_up(self, stages, inputs) -> Tuple[dict, bool]:
        """The stages run eagerly on the side stream, with the host's
        waits on the device reported; returns (outputs, whether any)."""
        device = inputs[0].device
        side = self._side(device)
        cur = torch.cuda.current_stream(device)
        side.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught, \
                torch.cuda.stream(side), _no_cast_cache():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = run_stages(stages, inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(side)
        for t in _tensors(list(out.values())):
            # made on the side stream, read on this one
            t.record_stream(cur)
        synced = any(str(w.message).startswith(SYNC_WARNING)
                     for w in caught)
        return out, synced

    def _capture(self, entry: _Entry, stages, inputs):
        entry.inputs = tuple(t.clone() for t in inputs)
        side = self._side(inputs[0].device)
        pool = torch.cuda.graph_pool_handle()
        with _no_cast_cache():
            for name, fn in stages:
                g = torch.cuda.CUDAGraph()
                # thread_local: another thread's CUDA calls (a loader's)
                # neither fail nor spoil the capture
                with torch.cuda.graph(g, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    fn(*entry.inputs, entry.out)
                entry.graphs.append((name, g))

    @staticmethod
    def _replay(entry: _Entry, inputs) -> dict:
        for static, t in zip(entry.inputs, inputs):
            static.copy_(t)
        for name, g in entry.graphs:
            with span(name), span(REPLAY):
                g.replay()
        return {k: _clone(v) for k, v in entry.out.items()}
