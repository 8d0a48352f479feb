"""The OpenCV image operations of the data pipelines, in numpy, matching
``cv2`` for the types and shapes the datasets use (uint8, uint16, float32;
one or three channels).

- ``resize``: ``INTER_LINEAR`` and ``INTER_NEAREST`` (``cv2.resize``).
  Linear follows OpenCV's separable path: source coordinates
  ``(d + 0.5) * scale - 0.5`` rounded to f32, edge pixels clamped; uint8
  runs its 11-bit fixed-point coefficients with OpenCV's vertical pass
  (its SIMD rounding over whole vectors, its scalar rounding in the tail);
  uint16 and f32 run in f32. Nearest takes ``floor(d * src / dst)``, which
  is not ``F.interpolate``'s rule at every size.
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
COLORMAP_JET = 2
COLORMAP_VIRIDIS = 16
COLORMAP_PLASMA = 15

_COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS
_WARP_LANES = 16  # pixels a vector step of OpenCV's warp kernels takes
# columns a vector step of OpenCV's f32 row and column filters takes
_ROW_LANES, _COL_LANES = 4, 8


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


def resize(img: np.ndarray, dsize, interpolation: int = INTER_LINEAR
           ) -> np.ndarray:
    """``cv2.resize(img, dsize=(w, h), interpolation=...)``."""
    img = np.ascontiguousarray(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, (dw, dh))
    if interpolation != INTER_LINEAR:
        raise ValueError(f"interpolation {interpolation}: only INTER_NEAREST "
                         f"and INTER_LINEAR")
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
