"""The OpenCV image operations of the data pipelines, in numpy, matching
``cv2`` for the types and shapes the datasets use (uint8, uint16, float32;
one or three channels).

- ``resize``: ``INTER_LINEAR``, ``INTER_NEAREST`` and ``INTER_CUBIC``
  (``cv2.resize``). Linear follows OpenCV's separable path: source
  coordinates ``(d + 0.5) * scale - 0.5`` rounded to f32, edge pixels
  clamped; uint8 runs its 11-bit fixed-point coefficients with OpenCV's
  vertical pass (its SIMD rounding over whole vectors, its scalar rounding
  in the tail); uint16 and f32 run in f32. Nearest takes ``floor(d * src /
  dst)``, which is not ``F.interpolate``'s rule at every size. Cubic (f32
  and f64, any channel count; ``resizeGeneric_``): the same coordinates,
  A = -0.75 coefficients computed in f32 (OpenCV's coefficient type for
  both), each of the four taps clamped to the image (border replication);
  the row pass sums its taps left to right, each product rounded, in the
  image's type; the column pass does so in f64, and in f32 runs OpenCV's
  4-lane vector loop (the taps from the last to the first, a multiply and
  an add each) over the first ``w * cn - w * cn % 4`` values of a row and
  the left-to-right sum in the rest. Found by experiment against ``cv2``
  5.0.0: bit-equal for f64; for f32 bit-equal with OpenCV's own code
  (``cv2.ipp.setUseIPP(False)``), while its IPP build hands f32 with 1, 3
  or 4 channels to IPP's cubic, which rounds otherwise.
- ``filter2d``: ``cv2.filter2D(img, -1, kernel)`` on uint8 with
  ``BORDER_REFLECT_101`` and the centred anchor: the kernel's nonzero taps
  in row-major order (OpenCV keeps only those), summed in f32, then
  rounded to even and saturated. For the normalised motion kernels of
  ``utils.data_augmentation.add_noise`` (one row or one column of 1/k, k
  odd, which OpenCV runs through its DFT path from k = 15) the exact sum is
  never within 1/30 of a rounding tie, so every summation order rounds
  alike: bit-equal with ``cv2`` there.
- ``cvt_bgr2hls`` / ``cvt_hls2bgr``: ``cv2.cvtColor`` with
  ``COLOR_BGR2HLS`` / ``COLOR_HLS2BGR`` on uint8 (H in [0, 180)):
  ``x / 255`` in f32, OpenCV's float HLS formulas, then ``x * 255``
  rounded. BGR -> HLS: the hue a fused multiply-add onto 0, 120 or 240,
  then halved; where red leads and green < blue, 360 goes into the
  multiply-add in OpenCV's 8-lane vector loop (the first ``w - w % 8``
  pixels of a row) and is added after it in its scalar code (the rest);
  the saturation's ``2 - (max + min)`` is ``2 - max - min`` in the
  scalar code. HLS -> BGR: one formula throughout. Bit-equal with ``cv2``
  over every colour of each.
- ``rotation_matrix`` = ``cv2.getRotationMatrix2D``; ``warp_affine`` with
  ``INTER_NEAREST`` or ``INTER_LINEAR`` and a constant 0 border: the map
  is inverted in f64 and walked in OpenCV's 10-bit fixed point; linear
  weights come from OpenCV's 32 x 32 bilinear table.
- ``gaussian_blur``: f32, odd square kernel, ``BORDER_REFLECT_101``: rows
  then columns, each a chain of fused multiply-adds in f32 as OpenCV's
  vector loops run it, and of separately rounded ones in their scalar
  tails; bit-equal at every width.
- ``apply_colormap``: ``cv2.applyColorMap`` for PLASMA, VIRIDIS and JET
  (BGR out), from OpenCV's tables (``colormaps.py``).
- ``dilate``: ``cv2.dilate`` with a rectangle of ones (a max filter).

``tests/test_torch_image_io.py`` holds each against ``cv2`` and states the
tolerance where one is not bit-equal.
"""

from __future__ import annotations

import math

import numpy as np

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_CUBIC = 2
COLORMAP_JET = 2
COLORMAP_VIRIDIS = 16
COLORMAP_PLASMA = 15

_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_WARP_LANES = 16  # pixels a vector step of OpenCV's warp kernels takes
# columns a vector step of OpenCV's f32 row and column filters takes
_ROW_LANES, _COL_LANES = 4, 8
# values a vector step of OpenCV's f32 cubic column pass takes; pixels a
# vector step of its BGR -> HLS loop takes
_CUBIC_LANES, _HLS_LANES = 4, 8
_CUBIC_A = np.float32(-0.75)


def _round_even(x):
    """cvRound: to nearest, ties to even (the FPU's default)."""
    return np.rint(x)


def _linear_coords(src: int, dst: int, f32: bool):
    """Per output index: the left source index and its fraction,
    ``(d + 0.5) * src / dst - 0.5`` less its floor, in f64, or rounded to
    f32 first (``f32``, OpenCV's fixed-point path)."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    if f32:
        f = f.astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float64)


def _fma32(a, b, c):
    """f32 a * b + c rounded once (a * b is exact in f64)."""
    return (a.astype(np.float64) * b + c.astype(np.float64)).astype(
        np.float32)


def _resize_nearest(img, dsize):
    h, w = img.shape[:2]
    dw, dh = dsize
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(
        np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(
        np.int64), h - 1)
    return img[ys][:, xs]


def _resize_linear(img, dsize):
    h, w = img.shape[:2]
    dw, dh = dsize
    fixed = img.dtype == np.uint8
    sx, fx = _linear_coords(w, dw, fixed)
    sy, fy = _linear_coords(h, dh, fixed)
    # columns clamped with their fraction zeroed; rows clamped, fractions
    # kept (OpenCV's row clip)
    lo, hi = sx < 0, sx >= w - 1
    fx[lo | hi] = 0
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    sy0 = np.clip(sy, 0, h - 1)
    sy1 = np.clip(sy + 1, 0, h - 1)
    x = img if img.ndim == 3 else img[..., None]
    if fixed:
        # 11-bit coefficients; the vertical pass rounds as OpenCV's vector
        # loop: ((b0 (S0 >> 4)) >> 16 + (b1 (S1 >> 4)) >> 16 + 2) >> 2
        def coef(frac):
            pair = np.stack([1.0 - frac, frac]).astype(np.float32)
            return _round_even(pair.astype(np.float64) * _COEF_SCALE
                               ).astype(np.int64)

        ia, ib = coef(fx), coef(fy)
        xi = x.astype(np.int64)
        rows = (xi[:, sx] * ia[0][None, :, None]
                + xi[:, sx1] * ia[1][None, :, None])
        b0, b1 = ib[0][:, None, None], ib[1][:, None, None]
        out = (((b0 * (rows[sy0] >> 4)) >> 16)
               + ((b1 * (rows[sy1] >> 4)) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        # f32: each pass S0 + (S1 - S0) * t in one fused multiply-add
        xf = x.astype(np.float32)
        ax = fx.astype(np.float32)[None, :, None]
        ay = fy.astype(np.float32)[:, None, None]
        rows = _fma32(xf[:, sx1] - xf[:, sx], ax, xf[:, sx])
        out = _fma32(rows[sy1] - rows[sy0], ay, rows[sy0])
        if img.dtype == np.uint16:
            out = np.clip(_round_even(out), 0, 65535).astype(np.uint16)
        elif img.dtype != np.float32:
            raise ValueError(f"resize takes uint8, uint16 or float32, got "
                             f"{img.dtype}")
    return out if img.ndim == 3 else out[..., 0]


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """``interpolateCubic`` in f32: the four weights (4, n) of fractions
    ``x``."""
    f, a = np.float32, _CUBIC_A
    x = x.astype(f)
    x1, y = x + f(1), f(1) - x
    c0 = ((a * x1 - f(5) * a) * x1 + f(8) * a) * x1 - f(4) * a
    c1 = ((a + f(2)) * x - (a + f(3))) * x * x + f(1)
    c2 = ((a + f(2)) * y - (a + f(3))) * y * y + f(1)
    return np.stack([c0, c1, c2, f(1) - c0 - c1 - c2]).astype(f)


def _cubic_axis(src: int, dst: int):
    """Per output index the four source indices (clamped) and weights."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
         - 0.5).astype(np.float32)
    s = np.floor(f)
    idx = np.clip(s.astype(np.int64)[None, :] + np.arange(-1, 3)[:, None], 0,
                  src - 1)
    return idx, _cubic_coeffs(f - s)


def _resize_cubic(img, dsize):
    t = img.dtype.type
    dw, dh = dsize
    h = img.shape[0]
    x = img.reshape(img.shape[0], img.shape[1], -1)
    cn = x.shape[2]
    ix, cx = _cubic_axis(img.shape[1], dw)
    iy, cy = _cubic_axis(h, dh)
    rows = None
    for k in range(4):
        p = (x[:, ix[k]] * cx[k].astype(t)[None, :, None]).astype(t)
        rows = p if rows is None else (rows + p).astype(t)
    S = [rows.reshape(h, dw * cn)[iy[k]] for k in range(4)]
    b = [cy[k].astype(t)[:, None] for k in range(4)]
    out = None
    for k in range(4):
        p = (S[k] * b[k]).astype(t)
        out = p if out is None else (out + p).astype(t)
    if t is np.float32:
        body = dw * cn - dw * cn % _CUBIC_LANES
        vec = (S[3][:, :body] * b[3]).astype(t)
        for k in (2, 1, 0):
            vec = ((S[k][:, :body] * b[k]).astype(t) + vec).astype(t)
        out[:, :body] = vec
    return out.reshape((dh, dw) + img.shape[2:])


def resize(img: np.ndarray, dsize, interpolation: int = INTER_LINEAR
           ) -> np.ndarray:
    """``cv2.resize(img, dsize=(w, h), interpolation=...)``; an (H, W, 1)
    image comes back (h, w), as cv2 returns it, for INTER_CUBIC."""
    img = np.ascontiguousarray(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, (dw, dh))
    if interpolation == INTER_CUBIC:
        if img.dtype not in (np.float32, np.float64):
            raise ValueError(f"INTER_CUBIC takes float32 or float64, got "
                             f"{img.dtype}")
        out = (img.copy() if (dw, dh) == (w, h)
               else _resize_cubic(img, (dw, dh)))
        return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out
    if interpolation != INTER_LINEAR:
        raise ValueError(f"interpolation {interpolation}: only INTER_NEAREST, "
                         f"INTER_LINEAR and INTER_CUBIC")
    if (dw, dh) == (w, h):
        return img.copy()
    return _resize_linear(img, (dw, dh))


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) f64 matrix; ``center`` is
    rounded to f32 as OpenCV's Point2f holds it."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * math.pi / 180
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def _invert_affine(m):
    m = np.asarray(m, np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1] = a11, m[1] * -d
    m[3], m[4] = m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(img: np.ndarray, m: np.ndarray, dsize,
                flags: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize=(w, h), flags=...)`` with
    ``BORDER_CONSTANT`` 0, for ``INTER_NEAREST`` and ``INTER_LINEAR``.

    As OpenCV's warp kernels run it: the map inverted in f64 and rounded
    to f32; each output pixel's source coordinate in f32, ``sx = fma(x, M0,
    y * M1 + M2)`` (likewise sy) in the vector body of a row, and
    ``fma(x, M0, y * M1) + M2`` in its scalar tail, the last ``w % 16``
    columns; nearest takes the pixel at the rounded coordinate (ties to
    even); linear takes the four about its floor, outside ones 0, and
    blends them in f32 fused multiply-adds, along x then along y,
    rounding to the integer type at the end."""
    img = np.ascontiguousarray(img)
    if flags not in (INTER_NEAREST, INTER_LINEAR):
        raise ValueError(f"flags {flags}: only INTER_NEAREST and "
                         f"INTER_LINEAR")
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    M = _invert_affine(m).astype(np.float32)
    xs = np.broadcast_to(np.arange(dw, dtype=np.float32)[None, :], (dh, dw))
    ys = np.broadcast_to(np.arange(dh, dtype=np.float32)[:, None], (dh, dw))
    body = xs < dw - dw % _WARP_LANES

    def coord(m0, m1, m2):
        vec = _fma32(xs, m0, ys * m1 + m2)
        tail = _fma32(xs, m0, ys * m1) + m2
        return np.where(body, vec, tail)

    sx, sy = coord(*M[:3]), coord(*M[3:])
    x = img if img.ndim == 3 else img[..., None]

    def take(iy, ix):
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = x[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        return np.where(ok[..., None], v, np.zeros_like(v))

    if flags == INTER_NEAREST:
        out = take(_round_even(sy).astype(np.int64),
                   _round_even(sx).astype(np.int64))
        return out if img.ndim == 3 else out[..., 0]
    fx, fy = np.floor(sx), np.floor(sy)
    ax = (sx - fx).astype(np.float32)[..., None]
    ay = (sy - fy).astype(np.float32)[..., None]
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    p00, p01, p10, p11 = (take(iy + dy, ix + dx).astype(np.float32)
                          for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, v1 - v0, v0)
    if img.dtype != np.float32:
        info = np.iinfo(img.dtype)
        out = np.clip(_round_even(out), info.min, info.max).astype(img.dtype)
    return out if img.ndim == 3 else out[..., 0]


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma, cv2.CV_32F)``: normalized in
    f64, then rounded to f32."""
    if sigma <= 0:
        sigma = ((ksize - 1) * 0.5 - 1) * 0.3 + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (t * (1.0 / t.sum())).astype(np.float32)


def _mul_add32(a, b, c):
    """f32 c + a * b with the product and the sum each rounded."""
    return (c + (a * b).astype(np.float32)).astype(np.float32)


def gaussian_blur(img: np.ndarray, ksize, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigma)`` for an f32 (H, W) image with
    ``BORDER_REFLECT_101``: the row pass sums its taps left to right, the
    column pass the centre tap then each mirrored pair, each term one f32
    fused multiply-add in OpenCV's vector loops (4 columns a step in the
    row pass, 8 in the column pass) and a separately rounded multiply and
    add in their scalar tails (the last ``w % 4`` and ``w % 8``
    columns)."""
    k = int(ksize[0]) if isinstance(ksize, (tuple, list)) else int(ksize)
    if img.dtype != np.float32 or img.ndim != 2 or k % 2 == 0:
        raise ValueError("gaussian_blur takes an f32 (H, W) image and an "
                         "odd kernel size")
    kern = gaussian_kernel(k, sigma)
    r = k // 2
    h, w = img.shape
    row_body, col_body = w - w % _ROW_LANES, w - w % _COL_LANES

    def step(x, f, acc, body):
        out = _fma32(x, f, acc)
        out[:, body:] = _mul_add32(x[:, body:], f, acc[:, body:])
        return out

    pad = np.pad(img, ((0, 0), (r, r)), mode="reflect")  # reflect 101
    acc = np.zeros_like(img)
    for j in range(k):
        acc = step(pad[:, j:j + w], kern[j], acc, row_body)
    pad = np.pad(acc, ((r, r), (0, 0)), mode="reflect")
    out = pad[r:r + h] * kern[r]
    for j in range(1, r + 1):
        out = step(pad[r + j:r + j + h] + pad[r - j:r - j + h], kern[r + j],
                   out, col_body)
    return out


def dilate(img: np.ndarray, ksize) -> np.ndarray:
    """``cv2.dilate(img, np.ones((kh, kw)))``: the max over a kh x kw
    window centred on each pixel, the outside ignored."""
    kh, kw = int(ksize[0]), int(ksize[1])
    h, w = img.shape[:2]
    lo = np.iinfo(img.dtype).min if img.dtype.kind in "ui" else -np.inf
    pad = np.pad(img, ((kh // 2, kh - 1 - kh // 2),
                       (kw // 2, kw - 1 - kw // 2)), constant_values=lo)
    out = np.full_like(img, lo)
    for dy in range(kh):
        for dx in range(kw):
            np.maximum(out, pad[dy:dy + h, dx:dx + w], out=out)
    return out


def apply_colormap(gray: np.ndarray, colormap: int) -> np.ndarray:
    """``cv2.applyColorMap`` of a uint8 (H, W) image: (H, W, 3) BGR."""
    from .colormaps import TABLES

    if gray.dtype != np.uint8 or gray.ndim != 2:
        raise ValueError("apply_colormap takes a uint8 (H, W) image")
    if colormap not in TABLES:
        raise ValueError(f"colormap {colormap}: only PLASMA, VIRIDIS, JET")
    return TABLES[colormap][gray]


def filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, kernel)`` for a uint8 (H, W) or (H, W, C)
    image (an (H, W, 1) one comes back (H, W), as cv2 returns it):
    ``BORDER_REFLECT_101``, the anchor at the kernel's centre."""
    if img.dtype != np.uint8:
        raise ValueError(f"filter2d takes uint8, got {img.dtype}")
    k = np.asarray(kernel, np.float32)
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    x = img.reshape(img.shape[0], img.shape[1], -1)
    h, w = x.shape[:2]
    # numpy's "reflect" is OpenCV's REFLECT_101, folded as often as needed
    pad = np.pad(x, ((ay, kh - 1 - ay), (ax, kw - 1 - ax), (0, 0)),
                 mode="reflect")
    acc = np.zeros(x.shape, np.float32)
    for i, j in zip(*np.nonzero(k)):
        acc = acc + (pad[i:i + h, j:j + w].astype(np.float32) * k[i, j])
    out = np.clip(_round_even(acc), 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 or x.shape[2] == 1 else out


# OpenCV's sector table of HLS -> RGB: (b, g, r) from (p2, p1, tab2, tab3)
_HLS_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def cvt_bgr2hls(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2HLS)`` of a uint8 (H, W, 3) BGR
    image: (H, W, 3) uint8 H (0-179), L, S."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("cvt_bgr2hls takes a uint8 (H, W, 3) image")
    f = np.float32
    x = img.astype(f) * f(1.0 / 255)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff, vsum = vmax - vmin, vmax + vmin
    l = vsum * f(0.5)
    ok = diff > f(np.finfo(f).eps)
    rmax, gmax = vmax == r, vmax == g
    num = np.where(rmax, g - b, np.where(gmax, b - r, r - g))
    base = np.where(rmax, f(0), np.where(gmax, f(120), f(240))).astype(f)
    vec = img.shape[1] - img.shape[1] % _HLS_LANES
    with np.errstate(divide="ignore", invalid="ignore"):
        # 2 - (max + min) in the vector loop, 2 - max - min in the scalar
        far = f(2) - vmax - vmin
        far[:, :vec] = (f(2) - vsum)[:, :vec]
        s = diff / np.where(l < f(0.5), vsum, far)
        step = f(60) / diff
        hue = _fma32(num, step, base)
        # the vector loop adds 360 inside its multiply-add, the scalar
        # code after the product where it went negative
        hv = _fma32(num, step, np.full_like(num, 360))
        hue[:, :vec] = np.where(rmax & (g < b), hv, hue)[:, :vec]
        tail = hue[:, vec:]
        hue[:, vec:] = np.where(tail < 0, tail + f(360), tail)
    hue = np.where(ok, hue * f(0.5), f(0))
    s = np.where(ok, s, f(0)).astype(f)
    out = np.stack([hue, l * f(255), s * f(255)], -1)
    return np.clip(_round_even(out), 0, 255).astype(np.uint8)


def cvt_hls2bgr(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HLS2BGR)`` of a uint8 (H, W, 3) H
    (0-179), L, S image: (H, W, 3) uint8 BGR."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("cvt_hls2bgr takes a uint8 (H, W, 3) image")
    f = np.float32
    h = img[..., 0].astype(f)
    l = img[..., 1].astype(f) * f(1.0 / 255)
    s = img[..., 2].astype(f) * f(1.0 / 255)
    p2 = np.where(l <= f(0.5), l * (f(1) + s), l + s - l * s).astype(f)
    p1 = f(2) * l - p2
    h = h * f(6.0 / 180)
    h = np.where(h >= f(6), h - f(6), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f)
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (f(1) - h),
                    p1 + (p2 - p1) * h], -1).astype(f)
    bgr = np.take_along_axis(tab, _HLS_SECTORS[sector], -1)
    bgr = np.where((s == 0)[..., None], l[..., None], bgr)
    return np.clip(_round_even(bgr * f(255)), 0, 255).astype(np.uint8)
