"""The depth-corruption utilities ``folder_dataset`` needs (port of the
part of rdfc_gan_tpu/utils/data_augmentation.py it uses; reference
lib/utils/data_augmentation.py): ``ellipse_dropout``, with
``cv2.ellipse(img, center, axes, angle, 0, 360, color, thickness=-1)``'s
fill ported bit for bit, and ``exr_loader``, which raises.

The fill follows OpenCV's drawing code for a filled whole ellipse with
8-connected edges: the angle rounded to whole degrees; ``ellipse2Poly``'s
polygon from OpenCV's table of sines in f32 (a point every 90, 30, 18 or 5
degrees as the larger axis is under 3, 10, 15 pixels or not), in 16.16
fixed point, repeated points dropped; then ``FillConvexPoly``: each edge
drawn as an 8-connected fixed-point line (``Line2``, clipped to the image
as ``clipLine`` clips it), and the scanlines between the left and the right
edge filled, each edge stepped by a rounded fixed-point slope.
``tests/test_torch_more_datasets.py`` holds it against ``cv2.ellipse``
over thousands of random draws.
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's SinTable: sin of 0..450 degrees to 7 decimals, as f32
SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


def exr_loader(path: str) -> np.ndarray:
    """EXR depth is not read by the port: the build of OpenCV the JAX
    package is held against can neither write nor read EXR, so there is no
    reference to match. Raises ``ValueError`` naming the file."""
    raise ValueError(f"{path}: EXR depth is not supported by rdfc_gan_torch "
                     f"(no reference reader to match); store depth as "
                     f"uint16 millimetre PNG")


def _cdiv(a: int, b: int) -> int:
    """C integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _ellipse_poly(cx: int, cy: int, ax: int, ay: int, angle: int, delta: int):
    """``ellipse2Poly`` of a whole ellipse in 16.16 fixed point (doubles),
    then rounded as ``EllipseEx`` rounds it, repeats dropped."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha = SIN_TABLE[450 - angle]  # cos, f32
    beta = SIN_TABLE[angle]
    pts, prev = [], None
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = ax * SIN_TABLE[450 - a]
        y = ay * SIN_TABLE[a]
        px = cx + x * alpha - y * beta
        py = cy + x * beta + y * alpha
        qx = int(np.rint(px / XY_ONE)) << XY_SHIFT
        qy = int(np.rint(py / XY_ONE)) << XY_SHIFT
        qx += int(np.rint(px - qx))
        qy += int(np.rint(py - qy))
        if (qx, qy) != prev:
            pts.append((qx, qy))
            prev = (qx, qy)
    return pts


def _clip_line(w: int, h: int, x1, y1, x2, y2):
    """``clipLine`` on the 16.16 image size: the clipped ends, or None."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line2(img: np.ndarray, p1, p2, color):
    """``Line2``: an 8-connected line between 16.16 points."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img: np.ndarray, v, color):
    """``FillConvexPoly`` of 16.16 points, 8-connected edges."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xs_, ys_ = [p[0] for p in v], [p[1] for p in v]
    imin = int(np.argmin(ys_))
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xmin = (min(xs_) + delta) >> XY_SHIFT
    xmax = (max(xs_) + delta) >> XY_SHIFT
    ymin = (min(ys_) + delta) >> XY_SHIFT
    ymax = (max(ys_) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx_ = [imin, imin]
    ye = [ymin, ymin]
    di = [1, npts - 1]
    ex = [-XY_ONE, -XY_ONE]
    edx = [0, 0]
    y = ymin
    edges = npts
    while True:
        for i in range(2):
            if y >= ye[i]:
                idx0 = idx_[i]
                idx = idx0 + di[i]
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        ye[i] = ty
                        edx[i] = _cdiv((xe - xs) * 2 + (ty - y),
                                       2 * (ty - y))
                        ex[i] = xs
                        idx_[i] = idx
                        break
                    idx0 = idx
                    idx += di[i]
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if ex[0] > ex[1] else (0, 1)
            x1 = (ex[left] + delta) >> XY_SHIFT
            x2 = (ex[right] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center, axes, angle: float, color):
    """``cv2.ellipse(img, center, axes, angle, 0, 360, color, -1)`` in
    place, for an (H, W) image."""
    cx, cy = (int(c) << XY_SHIFT for c in center)
    ax, ay = (abs(int(a)) << XY_SHIFT for a in axes)
    delta = (max(ax, ay) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 \
        else 5
    v = _ellipse_poly(cx, cy, ax, ay, int(np.rint(angle)), delta)
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    _fill_convex_poly(img, v, color)
    return img


def ellipse_dropout(depth: np.ndarray, rng: np.random.Generator,
                    num_ellipses: int = 10,
                    max_axis: int = 20) -> np.ndarray:
    """Zero out random ellipses — the cleargrasp ellipse-dropout corruption
    (data_augmentation.py:102-114): the same draws, the same fill."""
    out = depth.copy()
    h, w = depth.shape[:2]
    mask = np.ones((h, w), np.uint8)
    for _ in range(int(rng.integers(1, num_ellipses + 1))):
        center = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        axes = (int(rng.integers(1, max_axis)), int(rng.integers(1, max_axis)))
        angle = float(rng.uniform(0, 180))
        fill_ellipse(mask, center, axes, angle, 0)
    return out * mask.reshape(h, w, *([1] * (depth.ndim - 2)))

