"""PNG reading and writing without OpenCV, as the datasets use
``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` and ``cv2.imwrite``.

Read: 8- and 16-bit grayscale, RGB and RGBA, non-interlaced, all five row
filters; the zlib stream through the standard library. ``imread`` returns
what ``cv2.IMREAD_UNCHANGED`` returns: (H, W) for grayscale, colour in BGR
or BGRA order, uint8 or uint16 (16-bit samples are stored big-endian).
``bgr2rgb`` flips the channel order (``cv2.COLOR_BGR2RGB``). Gray-alpha,
sub-byte gray and interlaced files raise ``ValueError``; so does a palette
file, which ``imread`` would have to expand to colours: ``read_indexed``
reads one (colour type 3, bit depths 1, 2, 4 and 8) as its index array, as
PIL's ``np.array(Image.open(path))`` does, and every other type as
``decode_png`` gives it (colour in the file's order, as PIL).

Write: the same types, from (H, W), (H, W, 1), BGR or BGRA arrays, as
``cv2.imwrite`` takes them. Each row gets the filter of least absolute sum
(libpng's heuristic) unless one is asked for.

The row unfiltering is the decode's one sequential loop (Sub, Average and
Paeth make each byte depend on the one to its left), so it runs in host
C++: ``csrc/host/png_unfilter.cpp``, compiled by the host compiler (``c++``,
or ``$CXX``) into ``rdfc_gan_torch/_build/`` at first use and loaded with
ctypes. A build or load failure raises. ``unfilter_plain`` is the same
function in numpy and Python, the reference the native one is held to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from typing import Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_HOST_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "host", "png_unfilter.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "_build")
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# colour type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_LIB: Optional[ctypes.CDLL] = None


def _native() -> ctypes.CDLL:
    """The loaded unfilter library, built on first use. Raises
    RuntimeError when the compiler or the load fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    cxx = os.environ.get("CXX", "c++")
    with open(_HOST_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode())
    target = os.path.join(_BUILD_DIR,
                          f"libpng_unfilter-{digest.hexdigest()[:12]}.so")
    if not os.path.exists(target):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        try:
            res = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _HOST_SRC],
                                 capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"png_unfilter: cannot run the host compiler "
                               f"{cxx!r}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"png_unfilter: {cxx} exit {res.returncode}\n"
                               f"{res.stderr}")
        os.replace(tmp, target)  # atomic: concurrent builders agree
    try:
        lib = ctypes.CDLL(target)
    except OSError as e:
        raise RuntimeError(f"png_unfilter: cannot load {target}: {e}") from e
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_longlong
    _LIB = lib
    return lib


def unfilter(data: bytes, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The unfiltered (height, rowbytes) uint8 rows of ``data`` (height rows
    of a filter byte and rowbytes filtered bytes), in host C++."""
    src = np.frombuffer(data, np.uint8)
    if src.size != height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected "
                         f"{height * (rowbytes + 1)}")
    out = np.empty((height, rowbytes), np.uint8)
    bad = _native().png_unfilter(src.ctypes.data, out.ctypes.data, height,
                                 rowbytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type "
                         f"{src[(bad - 1) * (rowbytes + 1)]} not in 0-4")
    return out


def unfilter_plain(data: bytes, height: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """``unfilter`` in numpy (None, Sub, Up) and Python (Average, Paeth)."""
    src = np.frombuffer(data, np.uint8)
    if src.size != height * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected "
                         f"{height * (rowbytes + 1)}")
    rows = src.reshape(height, rowbytes + 1)
    out = np.empty((height, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.uint8)
    for y in range(height):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            out[y] = cur
        elif ftype == 1:
            out[y] = np.cumsum(cur.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            out[y] = cur + prior
        elif ftype in (3, 4):
            line, up = cur.tolist(), prior.tolist()
            res = [0] * rowbytes
            for i in range(rowbytes):
                a = res[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                res[i] = (line[i] + pred) & 0xFF
            out[y] = res
        else:
            raise ValueError(f"PNG row {y}: filter type {ftype} not in 0-4")
        prior = out[y]
    return out


def _read_chunks(buf: bytes):
    if buf[:8] != _SIG:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before its IEND chunk")


def _palette_indices(data: bytes, h: int, w: int, depth: int,
                     plain: bool) -> np.ndarray:
    """The (h, w) uint8 palette indices of a colour type 3 image: rows of
    ceil(w * depth / 8) bytes, each byte's pixels from its high bits."""
    rowbytes = (w * depth + 7) // 8
    rows = (unfilter_plain if plain else unfilter)(data, h, rowbytes, 1)
    if depth == 8:
        return rows[:, :w].copy()
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[..., None] >> shifts) & np.uint8((1 << depth) - 1)
    return np.ascontiguousarray(vals.reshape(h, rowbytes * per)[:, :w])


def decode_png(buf: bytes, plain: bool = False,
               indexed: bool = False) -> np.ndarray:
    """Decode PNG bytes to an array in the file's channel order (RGB,
    RGBA). ``plain`` unfilters with ``unfilter_plain``. A palette file
    gives its (H, W) uint8 index array with ``indexed``, else raises."""
    header, idat = None, []
    for kind, body in _read_chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if ctype == 3 and indexed and depth in (1, 2, 4, 8) and not (
            comp or filt):
        return _palette_indices(zlib.decompress(b"".join(idat)), h, w,
                                depth, plain)
    if ctype not in _CHANNELS or depth not in (8, 16) or comp or filt:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is "
                         f"not supported (8/16-bit gray, RGB or RGBA only)")
    cn, nbytes = _CHANNELS[ctype], depth // 8
    bpp = cn * nbytes
    data = zlib.decompress(b"".join(idat))
    rows = (unfilter_plain if plain else unfilter)(data, h, w * bpp, bpp)
    if nbytes == 2:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    return img.reshape(h, w, cn) if cn > 1 else img.reshape(h, w)


def imread(path: str, plain: bool = False) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` for the supported types:
    grayscale (H, W), colour BGR or BGRA. Raises on a missing or
    unsupported file (cv2 returns None there)."""
    with open(path, "rb") as f:
        img = decode_png(f.read(), plain=plain)
    if img.ndim == 3:
        img = np.ascontiguousarray(
            img[..., [2, 1, 0, 3][:img.shape[2]]])
    return img


def read_indexed(path: str, plain: bool = False) -> np.ndarray:
    """PIL's ``np.array(Image.open(path))`` of a PNG: a palette file's
    (H, W) uint8 index array; gray (H, W) and colour in the file's order
    (RGB, RGBA), uint8 or uint16, as ``decode_png`` gives them."""
    with open(path, "rb") as f:
        return decode_png(f.read(), plain=plain, indexed=True)


def bgr2rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2RGB)`` for an (H, W, 3) image."""
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"bgr2rgb takes an (H, W, 3) image, got "
                         f"{img.shape}")
    return np.ascontiguousarray(img[..., ::-1])


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int,
                ftype: Optional[int] = None) -> np.ndarray:
    """The (H, 1 + rowbytes) filtered rows of raw (H, rowbytes) uint8 rows:
    filter ``ftype`` on every row, or per row the filter of least sum of
    absolute signed bytes."""
    r = rows.astype(np.int16)
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    ul = np.zeros_like(r)
    ul[1:, bpp:] = r[:-1, :-bpp]
    cands = np.stack([r, r - left, r - up, r - ((left + up) >> 1),
                      r - _paeth(left, up, ul)]).astype(np.uint8)
    if ftype is None:
        cost = np.abs(cands.view(np.int8).astype(np.int32)).sum(-1)
        choice = cost.argmin(0)
    else:
        if ftype not in range(5):
            raise ValueError(f"PNG filter type {ftype} not in 0-4")
        choice = np.full(rows.shape[0], ftype)
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = choice
    out[:, 1:] = cands[choice, np.arange(rows.shape[0])]
    return out


def encode_png(img: np.ndarray, ftype: Optional[int] = None) -> bytes:
    """PNG bytes of a uint8 / uint16 image in the file's channel order:
    (H, W) or (H, W, 1) gray, (H, W, 3) RGB, (H, W, 4) RGBA."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    cn = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(cn)
    if ctype is None or img.ndim not in (2, 3):
        raise ValueError(f"PNG takes (H, W[, 1|3|4]) images, got {img.shape}")
    h, w = img.shape[:2]
    nbytes = img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(">u2") if nbytes == 2 else img)
    rows = raw.view(np.uint8).reshape(h, w * cn * nbytes)
    data = zlib.compress(filter_rows(rows, cn * nbytes, ftype).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * nbytes, ctype, 0, 0, 0)
    return (_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data)
            + chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray, ftype: Optional[int] = None):
    """``cv2.imwrite`` of a PNG: (H, W) or (H, W, 1) gray, BGR or BGRA,
    uint8 or uint16. ``ftype`` forces one row filter (0-4)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    data = encode_png(img, ftype)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
