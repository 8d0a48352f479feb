"""Build and load the hand-written CUDA kernels of ``rdfc_gan_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into ``rdfc_gan_torch/_build/lib<name>-<hash>.so``
(the hash is of the source, the headers of ``csrc`` and the flags, so an
edited source or header is rebuilt) and loaded with ``ctypes``.
``build_all`` starts one ``nvcc`` per source at once. Nothing here runs at
import: the CPU tests import every module.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
to it right after a launch succeeds and nowhere else. One source may hold
two kernels: ``nlspn_propagate.cu`` is counted as ``nlspn_propagate`` (the
served chain) and ``nlspn_propagate_x`` (the chain that also stores X),
``instance_norm.cu`` as ``instance_norm_fwd`` and ``instance_norm_bwd`` (and
the forward's split for a width-sharded plane, ``instance_norm_moments``
and ``instance_norm_apply``),
``conv3x3_bf16.cu`` (the bf16 conv block) as ``conv3x3_fwd`` and
``conv3x3_bwd``, ``conv_block.cu`` (its f32 case) as ``conv3x3_fwd_f32`` and
``conv3x3_bwd_f32``.

The three kernels of the served path (the shift-mask scatter, the served
chain and the instance norm's forward) are also dispatcher ops of the
``OP_NAMESPACE`` namespace (``define_op``), so that ``torch.export``
keeps them in an exported program; their count is taken inside the op's
CUDA implementation, so a run of such a program counts its launches too.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("shift_mask_scatter", "shift_mask_gather", "nlspn_propagate",
           "nlspn_reverse_chain", "shift_correlation", "instance_norm",
           "conv_block", "conv3x3_bf16")

LAUNCHES: collections.Counter = collections.Counter()
OP_NAMESPACE = "rdfc_gan_torch"
# ptxas report (registers, shared memory, spills) of each built kernel,
# kept beside its library as lib<name>-<hash>.so.log
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# the dispatcher library that defines the served kernels' ops (its ops go
# when it is collected)
_OPS = torch.library.Library(OP_NAMESPACE, "DEF")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "shift_mask_scatter": {
        "shift_mask_scatter":
            [_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I, _P]},
    "shift_mask_gather": {
        "shift_mask_gather":
            [_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _I, _I, _P]},
    "nlspn_propagate": {
        "nlspn_propagate":
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "nlspn_chain_plan": [_I, _I, _I, _I, _I, _I, _P]},
    "nlspn_reverse_chain": {
        "nlspn_reverse_chain":
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _P],
        "nlspn_reverse_chain_plan": [_I, _I, _I, _I, _I, _I, _P]},
    "shift_correlation": {
        "shift_correlation":
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        "shift_correlation_plan": [_I, _I, _I, _I, _P]},
    "instance_norm": {
        "instance_norm_fwd": [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P],
        "instance_norm_fwd_plan": [_I, _I, _P],
        "instance_norm_bwd_plan": [_I, _I, _P],
        "instance_norm_bwd": [_P, _P, _P, _P, _I, _I, _I, _P],
        "instance_norm_moments": [_P, _P, _I, _I, _I, _P],
        "instance_norm_apply": [_P, _P, _P, _P, _I, _I, _I, _P]},
    "conv_block": {
        "conv3x3_fwd": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
        "conv3x3_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "conv3x3_bf16": {
        "conv3x3_bf16_pack": [_P, _P, _I, _I, _I, _I, _P],
        "conv3x3_bf16_fwd": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _P],
        "conv3x3_bf16_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P]},
}


def reset_launches():
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of rdfc_gan_torch cannot be built on this machine")
    return path


def _target(name: str) -> str:
    """The library's path, named by a hash of its source, the headers of
    ``csrc`` (any of them may be included) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current build, all at once.
    Returns {name: path of the shared library}. Raises on any failure."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n in names:
        if os.path.exists(targets[n]):
            if os.path.exists(targets[n] + ".log"):
                with open(targets[n] + ".log") as f:
                    BUILD_LOGS[n] = f.read()
            continue
        tmp = f"{targets[n]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(out)
        os.replace(f"{tmp}.log", targets[n] + ".log")
        os.replace(tmp, targets[n])  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Raises
    when no CUDA device is present: a kernel is never run without a card."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    require_card(name)
    path = build_all([name])[name]
    lib = ctypes.CDLL(path)
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def require_card(name: str):
    """Raise when no CUDA device is present: a kernel is never run without
    a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device; none found")


def check(lib: ctypes.CDLL, name: str, code: int):
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"kernel {name!r} failed to launch: {msg} ({code})")


def stream_handle() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def define_op(schema: str, cuda, cpu, fake):
    """Define the dispatcher op ``OP_NAMESPACE::<schema>``: ``cuda`` is its
    CUDA kernel (the launch), ``cpu`` its CPU kernel (the plain version),
    ``fake`` the outputs' shapes and types for a meta or fake (traced)
    tensor. Registered through ``torch.library.Library``, whose dispatch
    calls the kernel directly: ``torch.library.custom_op`` adds a Python
    wrapper to every call. Returns the op's overload, called as a
    function."""
    name = schema.split("(", 1)[0]
    _OPS.define(schema)
    _OPS.impl(name, cuda, "CUDA")
    _OPS.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{OP_NAMESPACE}::{name}", fake, lib=_OPS)
    return getattr(getattr(torch.ops, OP_NAMESPACE), name).default


def require_cuda(name: str, *tensors: torch.Tensor):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be a CUDA tensor, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
