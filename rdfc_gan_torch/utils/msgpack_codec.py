"""msgpack as ``flax.serialization`` writes a state tree, without msgpack or
flax: the payload of the JAX package's ``.ckpt`` (``utils.jax_checkpoint``).

Types: maps (str keys), str, bin, ints, floats, nil, bools, arrays (read
as lists) and flax's three ext types:

  1  an ndarray: the msgpack of (shape, dtype name, C-order bytes);
  2  a Python complex: the msgpack of (real, imag);
  3  a numpy scalar: an ndarray of shape ().

flax splits an array of more than ``MAX_CHUNK_SIZE`` bytes into a map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
{"0": flat part, ...}}``; ``unpackb`` joins such a map back into one array,
and ``pack`` writes it, so a file this module writes reads back in flax.

``unpackb`` takes a ``memoryview`` and returns arrays that are views into
it (``np.frombuffer``): no per-byte loop and no second copy of the payload.
``bfloat16``, which numpy lacks, arrives as a ``torch.bfloat16`` tensor
through an int16 view. ``pack`` streams to a writer leaf by leaf; it
writes numpy arrays and CPU torch tensors (bf16 as ``bfloat16``), and
encodes every value in the format msgpack-python's packer picks for it, so
the bytes equal flax's ``to_bytes`` of the same tree with the same key
order.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
# the width of a length that follows each variable-size type byte
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H",
        0xc9: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H",
        0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


# ------------------------------------------------------------- decoding --
class _Reader:
    def __init__(self, buf: memoryview, raw: bool):
        self.buf = buf
        self.pos = 0
        self.raw = raw  # str as bytes (flax's ndarray payloads)

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        data = self._take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self._map(b & 0x0f)
        if b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return self._str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self._unpack(_FIXED[b])
        if b in _FIXEXT:
            return self._ext(self._unpack(">b"), _FIXEXT[b])
        if b not in _LEN:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")
        n = self._unpack(_LEN[b])
        if b <= 0xc6:
            return self._take(n) if self.raw else bytes(self._take(n))
        if b <= 0xc9:
            return self._ext(self._unpack(">b"), n)
        if b <= 0xdb:
            return self._str(n)
        if b <= 0xdd:
            return [self.value() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, code: int, n: int):
        data = self._take(n)
        if code == EXT_COMPLEX:
            re, im = _Reader(data, raw=False).value()
            return complex(re, im)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one flax "
                             f"writes")
        shape, name, payload = _Reader(data, raw=True).value()
        arr = _array(name.decode("ascii"), payload, tuple(shape))
        if code == EXT_NPSCALAR:
            return arr[()] if isinstance(arr, np.ndarray) else arr
        return arr


def _array(name: str, payload: memoryview, shape: tuple):
    """A view of ``payload`` as an array of dtype ``name``; bf16 as a torch
    tensor."""
    if name == "bfloat16":
        a = np.frombuffer(payload, np.int16)
        if not (a.flags.aligned and a.flags.writeable):
            a = a.copy()
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(payload, np.dtype(name)).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if parts and isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def unpackb(buf) -> Any:
    """The tree of one msgpack value that fills ``buf`` (bytes, bytearray
    or memoryview); arrays are views into it."""
    r = _Reader(memoryview(buf).cast("B"), raw=False)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes follow the msgpack "
                         f"value")
    return out


# ------------------------------------------------------------- encoding --
def _int(o: int) -> bytes:
    if -0x20 <= o <= 0x7f:
        return struct.pack(">b" if o < 0 else ">B", o)
    if o > 0:
        for b, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                            (0xce, ">I", 0xffffffff),
                            (0xcf, ">Q", 0xffffffffffffffff)):
            if o <= top:
                return bytes([b]) + struct.pack(fmt, o)
    else:
        for b, fmt, bottom in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if o >= bottom:
                return bytes([b]) + struct.pack(fmt, o)
    raise OverflowError(f"{o} does not fit msgpack's 64-bit ints")


def _head(n: int, fix: int, fix_max: int, sized) -> bytes:
    """A container's or a string's header: the fix form below ``fix_max``
    entries, else the first (type byte, width) of ``sized`` that holds n."""
    if n < fix_max:
        return bytes([fix | n])
    for b, fmt, top in sized:
        if n <= top:
            return bytes([b]) + struct.pack(fmt, n)
    raise ValueError(f"{n} entries exceed msgpack's 32-bit lengths")


_U = ((">B", 0xff), (">H", 0xffff), (">I", 0xffffffff))


def _str_head(n):
    return _head(n, 0xa0, 32, [(0xd9 + i, f, t) for i, (f, t) in
                               enumerate(_U)])


def _bin_head(n):
    return _head(n, 0, 0, [(0xc4 + i, f, t) for i, (f, t) in enumerate(_U)])


def _array_head(n):
    return _head(n, 0x90, 16, [(0xdc, ">H", 0xffff),
                               (0xdd, ">I", 0xffffffff)])


def _map_head(n):
    return _head(n, 0x80, 16, [(0xde, ">H", 0xffff),
                               (0xdf, ">I", 0xffffffff)])


def _ext_head(code: int, n: int) -> bytes:
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fix is not None:
        return bytes([fix]) + struct.pack(">b", code)
    for b, (fmt, top) in zip((0xc7, 0xc8, 0xc9), _U):
        if n <= top:
            return bytes([b]) + struct.pack(fmt, n) + struct.pack(">b", code)
    raise ValueError(f"an ext of {n} bytes exceeds msgpack's 32-bit lengths")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _str_head(len(data)) + data


def _float(o: float) -> bytes:
    return b"\xcb" + struct.pack(">d", o)


def _as_numpy(x):
    """(dtype name, C-contiguous numpy array to take the bytes of)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        x = t.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        x = x.copy(order="C")
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not written")
    return x.dtype.name, x


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _write_array(write: Callable, x, code: int = EXT_NDARRAY):
    name, a = _as_numpy(x)
    inner = (_array_head(3) + _array_head(len(a.shape))
             + b"".join(_int(int(d)) for d in a.shape) + _str(name)
             + _bin_head(a.nbytes))
    write(_ext_head(code, len(inner) + a.nbytes))
    write(inner)
    write(memoryview(a.reshape(-1).view(np.uint8)))


def _write_chunked(write: Callable, x):
    """flax's ``_chunk``: the flat array cut into MAX_CHUNK_SIZE-byte
    parts."""
    flat = x.reshape(-1)
    if isinstance(x, torch.Tensor):
        n, itemsize = x.numel(), x.element_size()
    else:
        n, itemsize = x.size, x.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    shape = {str(i): int(d) for i, d in enumerate(x.shape)}
    chunks = {str(j): flat[i:i + step]
              for j, i in enumerate(range(0, n, step))}
    write(_map_head(3))
    write(_str(CHUNKED))
    write(b"\xc3")
    write(_str("shape"))
    pack(shape, write)
    write(_str("chunks"))
    write(_map_head(len(chunks)))
    for k, c in chunks.items():
        write(_str(k))
        _write_array(write, c)


def pack(obj: Any, write: Callable[[bytes], Any]):
    """Write ``obj``'s msgpack through ``write``, leaf by leaf. Maps keep
    their key order; an array of more than MAX_CHUNK_SIZE bytes that is a
    map's value (or the whole tree) is written chunked, as flax does."""
    if isinstance(obj, dict):
        write(_map_head(len(obj)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r}: a state dict has str keys")
            write(_str(k))
            if (isinstance(v, (np.ndarray, torch.Tensor))
                    and _nbytes(v) > MAX_CHUNK_SIZE):
                _write_chunked(write, v)
            else:
                pack(v, write)
        return
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            _write_chunked(write, obj)
        else:
            _write_array(write, obj)
    elif obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        write(_int(obj))
    elif type(obj) is float:
        write(_float(obj))
    elif type(obj) is str:
        write(_str(obj))
    elif type(obj) is bytes:
        write(_bin_head(len(obj)) + obj)
    elif type(obj) is list:
        write(_array_head(len(obj)))
        for v in obj:
            pack(v, write)
    elif isinstance(obj, np.generic):
        _write_array(write, np.asarray(obj), EXT_NPSCALAR)
    elif type(obj) is complex:
        inner = _array_head(2) + _float(obj.real) + _float(obj.imag)
        write(_ext_head(EXT_COMPLEX, len(inner)) + inner)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as flax's "
                        f"msgpack")


def packb(obj: Any) -> bytes:
    """``pack`` into bytes."""
    parts = []
    pack(obj, parts.append)
    return b"".join(bytes(p) for p in parts)
