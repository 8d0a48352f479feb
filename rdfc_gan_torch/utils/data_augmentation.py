"""Depth-image utility and sensor-corruption library (port of
rdfc_gan_tpu/utils/data_augmentation.py; reference
lib/utils/data_augmentation.py, cleargrasp heritage): depth I/O and
colour maps, point clouds, and the corruption family (gaussian and
gamma noise, motion blur, HLS jitter, ellipse dropouts). Each function
has the JAX function's name, signature, defaults and
``np.random.Generator`` draw order, so the same seed gives the same
array. The OpenCV and PIL calls of the JAX module go through the port's
image layer, held against those libraries by
``tests/test_torch_image_io.py`` and ``tests/test_torch_data_augmentation.py``:
``cv_ops.filter2d`` (``add_noise``'s motion blur), ``cv_ops.cvt_bgr2hls``
/ ``cvt_hls2bgr`` (``chromatic_transform``), ``cv_ops.resize`` with
``INTER_CUBIC`` (``add_noise_to_xyz``), ``cv_ops.apply_colormap``
(``depth2rgb``), ``image_io.imwrite`` (``save_uint16_png``),
``image_io.read_indexed`` (``imread_indexed``) and ``fill_ellipse`` below
(``ellipse_dropout`` and the two ``dropout_random_ellipses_*``).

EXR is neither read nor written: the build of OpenCV the JAX package is
held against can do neither, so there is no reference to match;
``exr_loader`` and ``exr_saver`` raise ``ValueError`` naming the file.

``fill_ellipse`` is ``cv2.ellipse(img, center, axes, angle, 0, 360, color,
thickness=-1)``'s fill, ported bit for bit. It follows OpenCV's drawing
code for a filled whole ellipse with 8-connected edges: the angle rounded
to whole degrees; ``ellipse2Poly``'s polygon from OpenCV's table of sines
in f32 (a point every 90, 30, 18 or 5 degrees as the larger axis is under
3, 10, 15 pixels or not), in 16.16 fixed point, repeated points dropped;
then ``FillConvexPoly``: each edge drawn as an 8-connected fixed-point line
(``Line2``, clipped to the image as ``clipLine`` clips it), and the
scanlines between the left and the right edge filled, each edge stepped by
a rounded fixed-point slope. ``tests/test_torch_more_datasets.py`` holds it
against ``cv2.ellipse`` over thousands of random draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cv2.COLORMAP_JET (data.cv_ops, which is imported inside the functions:
# the data package imports this module)
COLORMAP_JET = 2

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's SinTable: sin of 0..450 degrees to 7 decimals, as f32
SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


def exr_loader(path: str, ndim: int = 3) -> np.ndarray:
    """EXR depth is not read by the port (module docstring). Raises
    ``ValueError`` naming the file."""
    raise ValueError(f"{path}: EXR depth is not supported by rdfc_gan_torch "
                     f"(no reference reader to match); store depth as "
                     f"uint16 millimetre PNG")


def exr_saver(path: str, arr: np.ndarray):
    """EXR is not written by the port (module docstring). Raises
    ``ValueError`` naming the file."""
    raise ValueError(f"{path}: EXR is not supported by rdfc_gan_torch (no "
                     f"reference writer to match); save depth with "
                     f"save_uint16_png")


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




# ------------------------------------------------------------- colormaps ---
def depth2rgb(depth: np.ndarray, min_depth: Optional[float] = None,
              max_depth: Optional[float] = None,
              color_mode: int = COLORMAP_JET,
              reverse_scale: bool = False) -> np.ndarray:
    """Colormap a depth image to uint8 RGB (H, W, 3): depth scaled to
    [0, 1] between ``min_depth`` and ``max_depth`` (its own min and max by
    default), to uint8 by truncation, through the colour map (JET,
    VIRIDIS or PLASMA)."""
    from ..data import cv_ops, image_io

    d = np.asarray(depth, np.float32)
    lo = d.min() if min_depth is None else min_depth
    hi = d.max() if max_depth is None else max_depth
    norm = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    if reverse_scale:
        norm = 1.0 - norm
    gray = (norm * 255).astype(np.uint8)
    if gray.ndim == 3 and gray.shape[2] == 1:
        gray = gray[..., 0]
    return image_io.bgr2rgb(cv_ops.apply_colormap(gray, color_mode))


def scale_depth(depth: np.ndarray, scale: float = 1000.0) -> np.ndarray:
    """meters -> uint16 millimeters (or custom scale)."""
    return np.clip(depth * scale, 0, 65535).astype(np.uint16)


# ----------------------------------------------------------- point clouds --
def depth_to_point_cloud(depth: np.ndarray, fx: float, fy: float,
                         cx: float, cy: float,
                         rgb: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Back-project a depth map (meters) to an (N, 3) point cloud of its
    valid (z > 1e-6) pixels, with their colours when ``rgb`` is given."""
    h, w = depth.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    z = depth.reshape(-1)
    x = ((xs.reshape(-1) - cx) / fx) * z
    y = ((ys.reshape(-1) - cy) / fy) * z
    pts = np.stack([x, y, z], axis=1)
    valid = z > 1e-6
    cols = rgb.reshape(-1, 3)[valid] if rgb is not None else None
    return pts[valid], cols


def write_point_cloud(path: str, points: np.ndarray,
                      colors: Optional[np.ndarray] = None):
    """ASCII PLY writer (the reference's open3d dependency replaced)."""
    n = points.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.6f} {points[i, 1]:.6f} {points[i, 2]:.6f}"
            if colors is not None:
                c = colors[i].astype(int)
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")


# ------------------------------------------------------------ corruptions --
def add_gaussian_noise(depth: np.ndarray, rng: np.random.Generator,
                       sigma_frac: float = 0.01) -> np.ndarray:
    """Depth-proportional gaussian sensor noise on the valid pixels."""
    noise = rng.normal(0.0, 1.0, depth.shape).astype(np.float32)
    return np.where(depth > 0, depth * (1.0 + sigma_frac * noise), depth)


def save_uint16_png(path: str, image: np.ndarray):
    """Write a uint16 PNG (data_augmentation.py:105-118: refuses
    non-uint16 input instead of converting it)."""
    from ..data import image_io

    arr = np.asarray(image)
    if arr.dtype != np.uint16:
        raise ValueError(f"expected uint16, got {arr.dtype}")
    image_io.imwrite(path, arr)


def normalize_depth_img(depth: np.ndarray, dtype=np.uint8,
                        min_depth: float = 0.0,
                        max_depth: float = 1.0) -> np.ndarray:
    """Scale a float depth map into the full range of an integer dtype
    (data_augmentation.py:121-153): values outside [min, max] clamp,
    invalid (<= 0) pixels map to 0."""
    d = np.asarray(depth, np.float32)
    lo, hi = float(min_depth), float(max_depth)
    full = np.iinfo(dtype).max
    norm = np.clip((d - lo) / max(hi - lo, 1e-8), 0.0, 1.0) * full
    norm = np.where(d > 0, norm, 0)
    return norm.astype(dtype)


def unscale_depth(depth: np.ndarray, scale: float = 1000.0) -> np.ndarray:
    """uint16 millimeters -> float32 meters (inverse of scale_depth)."""
    return np.asarray(depth, np.float32) / scale


def add_noise(image: np.ndarray, rng: np.random.Generator,
              level: float = 0.1) -> np.ndarray:
    """RGB corruption (data_augmentation.py:302-328): 90% additive gaussian
    noise at a random sigma, 10% axis-aligned motion blur (a uint8
    image)."""
    from ..data import cv_ops

    if rng.random() < 0.9:
        sigma = rng.random() * rng.uniform(0, level) * 256
        gauss = sigma * rng.standard_normal(image.shape[:2])
        noisy = image + gauss[..., None]
        return np.clip(noisy, 0, 255).astype(np.uint8)
    size = int(rng.choice([3, 5, 7, 9, 11, 15]))
    k = np.zeros((size, size), np.float32)
    if rng.random() < 0.5:
        k[(size - 1) // 2, :] = 1.0
    else:
        k[:, (size - 1) // 2] = 1.0
    return cv_ops.filter2d(image, k / size).astype(np.uint8)


def chromatic_transform(image: np.ndarray, rng: np.random.Generator,
                        label: Optional[np.ndarray] = None,
                        d_h: Optional[float] = None,
                        d_s: Optional[float] = None,
                        d_l: Optional[float] = None) -> np.ndarray:
    """Random hue / luminosity / saturation jitter of a uint8 BGR image in
    HLS space (data_augmentation.py:332-358); labelled pixels keep their
    colours."""
    from ..data import cv_ops

    if d_h is None:
        d_h = (rng.random() - 0.5) * 0.1 * 180
    if d_l is None:
        d_l = (rng.random() - 0.5) * 0.2 * 256
    if d_s is None:
        d_s = (rng.random() - 0.5) * 0.2 * 256
    hls = cv_ops.cvt_bgr2hls(image)
    h, l, s = hls[..., 0], hls[..., 1], hls[..., 2]
    new = np.stack(((h + d_h) % 180, np.clip(l + d_l, 0, 255),
                    np.clip(s + d_s, 0, 255)), -1).astype(np.uint8)
    out = cv_ops.cvt_hls2bgr(new)
    if label is not None:
        iy, ix = np.where(label > 0)
        out[iy, ix, :] = image[iy, ix, :]
    return out


def build_matrix_of_indices(height: int, width: int) -> np.ndarray:
    """[H, W, 2] array with B[..., 0] = y, B[..., 1] = x
    (data_augmentation.py:361-365)."""
    return np.indices((height, width), dtype=np.float32).transpose(1, 2, 0)


def compute_xyz(depth: np.ndarray, camera_params: dict) -> np.ndarray:
    """Ordered [H, W, 3] point cloud from a metric depth image
    (data_augmentation.py:368-388)."""
    idx = build_matrix_of_indices(camera_params["yres"],
                                  camera_params["xres"])
    z = depth
    x = (idx[..., 1] - camera_params["cx"]) * z / camera_params["fx"]
    y = (idx[..., 0] - camera_params["cy"]) * z / camera_params["fy"]
    return np.stack([x, y, z], axis=-1)


def _dropout_ellipses(mask: np.ndarray, rng: np.random.Generator,
                      noise_params: dict, seed_from_zero: bool,
                      paint: int) -> np.ndarray:
    """Poisson-many ellipses centred on the mask's zero (or nonzero)
    pixels, gamma-drawn axes, whole-degree angles, filled with ``paint``
    (a constant, so drawing straight into the copy is the reference's
    temporary mask and scatter)."""
    out = mask.copy()
    n = rng.poisson(noise_params["ellipse_dropout_mean"])
    pool = np.array(np.where(out == 0 if seed_from_zero else out > 0)).T
    if n == 0 or pool.shape[0] == 0:
        return out
    centers = pool[rng.choice(pool.shape[0], size=n)]
    xr = rng.gamma(noise_params["ellipse_gamma_shape"],
                   noise_params["ellipse_gamma_scale"], size=n)
    yr = rng.gamma(noise_params["ellipse_gamma_shape"],
                   noise_params["ellipse_gamma_scale"], size=n)
    angles = rng.integers(0, 360, size=n)
    out = np.ascontiguousarray(out)
    for i in range(n):
        fill_ellipse(out, tuple(centers[i][::-1].astype(int)),
                     (int(round(xr[i])), int(round(yr[i]))),
                     int(angles[i]), int(paint))
    return out


def dropout_random_ellipses_4corruptmask(mask: np.ndarray,
                                         rng: np.random.Generator,
                                         noise_params: dict) -> np.ndarray:
    """Grow a corruption mask by random ellipses seeded at its zero pixels
    (DexNet-2.0 heritage, data_augmentation.py:391-424)."""
    return _dropout_ellipses(mask, rng, noise_params, seed_from_zero=True,
                             paint=1)


def dropout_random_ellipses_4mask(valid_mask: np.ndarray,
                                  rng: np.random.Generator,
                                  noise_params: dict) -> np.ndarray:
    """Drop random ellipses out of a validity mask
    (data_augmentation.py:427-462)."""
    return _dropout_ellipses(valid_mask, rng, noise_params,
                             seed_from_zero=False, paint=0)


def add_noise_to_depth(depth: np.ndarray, rng: np.random.Generator,
                       noise_params: dict) -> np.ndarray:
    """Multiplicative gamma noise (data_augmentation.py:465-476)."""
    return depth * rng.gamma(noise_params["gamma_shape"],
                             noise_params["gamma_scale"])


def add_noise_to_xyz(xyz: np.ndarray, depth: np.ndarray,
                     rng: np.random.Generator,
                     noise_params: dict) -> np.ndarray:
    """Approximate Gaussian-process noise: a low-resolution gaussian,
    bicubic-upscaled, added at valid depth (data_augmentation.py:479-495;
    the noised copy is returned, where the reference's ``return`` gave
    None)."""
    from ..data import cv_ops

    out = xyz.copy()
    h, w, c = xyz.shape
    sh, sw = (np.array([h, w]) / noise_params["gp_rescale_factor"]).astype(int)
    noise = rng.normal(0.0, noise_params["gaussian_scale"], size=(sh, sw, c))
    noise = cv_ops.resize(noise, (w, h), interpolation=cv_ops.INTER_CUBIC)
    out[depth > 0, :] += noise[depth > 0, :]
    return out


def imread_indexed(path: str) -> np.ndarray:
    """A palette-indexed segmentation PNG as its index array
    (data_augmentation.py:498-502)."""
    from ..data import image_io

    return np.atleast_3d(image_io.read_indexed(path))[..., 0]
