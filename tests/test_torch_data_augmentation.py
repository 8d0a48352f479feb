"""The port's sensor-corruption and depth-I/O library
(``rdfc_gan_torch/utils/data_augmentation.py``) against the JAX package's,
and the image operations it needs against OpenCV and PIL, on the CPU.

- Every one of the 18 functions against its JAX twin from the same
  ``np.random.default_rng`` seed: the same array (integer and float
  outputs bit for bit: both sides run the same numpy arithmetic, and the
  image operations below are bit-equal) and the same generator state
  after the call (the same draws in the same order). Seeds cover both
  branches of ``add_noise`` and every blur size and axis, and
  ``chromatic_transform`` with and without ``label``.
- ``cv_ops.filter2d`` against ``cv2.filter2D`` (the motion kernels, over
  shapes and channel counts), ``cvt_bgr2hls`` / ``cvt_hls2bgr`` against
  ``cv2.cvtColor`` over every colour and at odd widths, ``resize`` with
  ``INTER_CUBIC`` against ``cv2.resize`` (f64 bit for bit; f32 bit for bit
  with OpenCV's own code, ``cv2.ipp.setUseIPP(False)``: the IPP build hands
  f32 with 1, 3 or 4 channels to IPP's cubic), and palette PNGs written by
  PIL at bit depths 1, 2, 4 and 8 against ``np.array(Image.open(...))``.
- ``save_uint16_png`` read back by ``cv2`` and by ``image_io.imread``;
  the PLY bytes of ``write_point_cloud``; EXR refused, naming the file.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from rdfc_gan_torch.data import cv_ops, image_io
from rdfc_gan_torch.utils import data_augmentation as tda
from rdfc_gan_tpu.utils import data_augmentation as jda

H, W = 48, 64
BLUR_SIZES = (3, 5, 7, 9, 11, 15)
NOISE = dict(ellipse_dropout_mean=5, ellipse_gamma_shape=5.0,
             ellipse_gamma_scale=1.0, gamma_shape=1000.0, gamma_scale=0.001,
             gaussian_scale=0.005, gp_rescale_factor=4)
CAM = dict(fx=500.0, fy=500.0, cx=32.0, cy=24.0, xres=W, yres=H)


def _add_noise_seeds():
    """A seed for the gaussian branch of ``add_noise`` and one for each
    blur size and axis, found by replaying its draws."""
    want = {("gauss",)} | {(k, ax) for k in BLUR_SIZES
                           for ax in ("row", "col")}
    found = {}
    for seed in range(5000):
        r = np.random.default_rng(seed)
        if r.random() < 0.9:
            key = ("gauss",)
        else:
            k = int(r.choice(list(BLUR_SIZES)))
            key = (k, "row" if r.random() < 0.5 else "col")
        found.setdefault(key, seed)
        if set(found) == want:
            return [found[k] for k in sorted(found, key=str)]
    raise AssertionError(f"no seed for {want - set(found)}")


def _depth(seed, shape=(H, W), holes=True):
    r = np.random.default_rng(1000 + seed)
    d = np.abs(r.normal(2.0, 0.7, shape)).astype(np.float32)
    if holes:
        d[r.random(shape) < 0.1] = 0.0
    return d


def _rgb(seed, shape=(H, W, 3)):
    return np.random.default_rng(2000 + seed).integers(
        0, 256, shape).astype(np.uint8)


def _cases():
    """(id, function name, seed, make) of every call: ``make(seed)``
    gives the positional arguments (the generator goes in after the
    first, after the second for ``add_noise_to_xyz``) and the keyword
    arguments."""
    c = []
    for s in _add_noise_seeds():
        c.append((f"add_noise-{s}", "add_noise", s,
                  lambda s: ((_rgb(s),), {})))
        c.append((f"add_noise-odd-{s}", "add_noise", s,
                  lambda s: ((_rgb(s, (31, 45, 3)),), {})))
    for s in range(3):
        c.append((f"chromatic-{s}", "chromatic_transform", s,
                  lambda s: ((_rgb(s, (H, W + s, 3)),), {})))
        c.append((f"chromatic-label-{s}", "chromatic_transform", s,
                  lambda s: ((_rgb(s),), dict(label=(
                      _rgb(s + 7, (H, W)) > 200).astype(np.uint8)))))
    c.append(("chromatic-given", "chromatic_transform", 0,
              lambda s: ((_rgb(s),), dict(d_h=-7.5, d_s=20.0, d_l=-30.0))))
    for s in range(2):
        c.append((f"gaussian-{s}", "add_gaussian_noise", s,
                  lambda s: ((_depth(s),), dict(sigma_frac=0.02))))
        c.append((f"depth-gamma-{s}", "add_noise_to_depth", s,
                  lambda s: ((_depth(s), NOISE), {})))
        c.append((f"xyz-{s}", "add_noise_to_xyz", s,
                  lambda s: ((jda.compute_xyz(_depth(s), CAM), _depth(s),
                              NOISE), {})))
    c.append(("xyz-228x304", "add_noise_to_xyz", 2,
              lambda s: ((jda.compute_xyz(_depth(s, (228, 304)), dict(
                  CAM, xres=304, yres=228)), _depth(s, (228, 304)),
                  dict(NOISE, gp_rescale_factor=3)), {})))
    for s, params in enumerate([NOISE, dict(NOISE, ellipse_dropout_mean=20,
                                            ellipse_gamma_scale=3.0),
                                dict(NOISE, ellipse_gamma_shape=0.5,
                                     ellipse_gamma_scale=0.8)]):
        c.append((f"drop-mask-{s}", "dropout_random_ellipses_4mask", s,
                  lambda s, p=params: (((_depth(s) > 0).astype(np.uint8),
                                        p), {})))
        c.append((f"drop-corrupt-{s}", "dropout_random_ellipses_4corruptmask",
                  s, lambda s, p=params: (((_depth(s) > 2.5).astype(
                      np.uint8), p), {})))
    return c


CASES = _cases()


@pytest.mark.parametrize("name,seed,make", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_corruption_matches_jax(name, seed, make):
    """The same array, dtype and shape, and the same draws."""
    args, kw = make(seed)
    at = 2 if name == "add_noise_to_xyz" else 1
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got = getattr(tda, name)(*args[:at], rt, *args[at:], **kw)
    want = getattr(jda, name)(*args[:at], rj, *args[at:], **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert rt.bit_generator.state == rj.bit_generator.state


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


PURE = {
    "depth2rgb": lambda: ((_depth(0),), {}),
    "depth2rgb-range-reverse": lambda: ((_depth(1),), dict(
        min_depth=0.5, max_depth=3.0, reverse_scale=True)),
    "depth2rgb-viridis-hw1": lambda: ((_depth(2)[..., None],), dict(
        color_mode=cv2.COLORMAP_VIRIDIS)),
    "depth2rgb-plasma": lambda: ((_depth(3),), dict(
        color_mode=cv2.COLORMAP_PLASMA)),
    "scale_depth": lambda: ((_depth(0),), {}),
    "scale_depth-far": lambda: ((_depth(1) * 40,), dict(scale=1000.0)),
    "unscale_depth": lambda: ((tda.scale_depth(_depth(0)),), {}),
    "normalize_depth_img": lambda: ((_depth(0),), dict(max_depth=4.0)),
    "normalize_depth_img-u16": lambda: ((_depth(1), np.uint16, 0.5, 3.0),
                                        {}),
    "depth_to_point_cloud": lambda: ((_depth(0), 500.0, 480.0, 32.0, 24.0),
                                     {}),
    "depth_to_point_cloud-rgb": lambda: ((_depth(1), 500.0, 480.0, 30.5,
                                          20.0), dict(rgb=_rgb(1))),
    "build_matrix_of_indices": lambda: ((H, W), {}),
    "compute_xyz": lambda: ((_depth(0), CAM), {}),
}


@pytest.mark.parametrize("case", sorted(PURE))
def test_pure_function_matches_jax(case):
    name = case.split("-")[0]
    args, kw = PURE[case]()
    _same(getattr(tda, name)(*args, **kw), getattr(jda, name)(*args, **kw))


@pytest.mark.parametrize("colors", [False, True])
def test_write_point_cloud_bytes(tmp_path, colors):
    pts, cols = jda.depth_to_point_cloud(_depth(0, (12, 16)), 50.0, 50.0,
                                         8.0, 6.0, rgb=_rgb(0, (12, 16, 3)))
    cols = cols if colors else None
    tda.write_point_cloud(str(tmp_path / "t.ply"), pts, cols)
    jda.write_point_cloud(str(tmp_path / "j.ply"), pts, cols)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("shape", [(H, W), (17, 23, 3)])
def test_save_uint16_png_round_trip(tmp_path, shape):
    """What ``save_uint16_png`` writes, ``cv2`` and ``image_io.imread``
    read back as the array; a non-uint16 array is refused as in JAX."""
    arr = np.random.default_rng(3).integers(0, 65536, shape).astype(
        np.uint16)
    p = str(tmp_path / "d.png")
    tda.save_uint16_png(p, arr)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), arr)
    np.testing.assert_array_equal(image_io.imread(p), arr)
    for mod in (tda, jda):
        with pytest.raises(ValueError, match="uint16"):
            mod.save_uint16_png(p, arr.astype(np.float32))


def test_exr_is_refused_naming_the_file(tmp_path):
    p = str(tmp_path / "depth.exr")
    for fn, args in ((tda.exr_saver, (p, _depth(0))), (tda.exr_loader, (p,))):
        with pytest.raises(ValueError, match="depth.exr"):
            fn(*args)


def _palette_png(path, bits, shape, seed):
    r = np.random.default_rng(seed)
    im = Image.fromarray(r.integers(0, 1 << bits, shape).astype(np.uint8),
                         mode="P")
    im.putpalette([int(v) for v in r.integers(0, 256, 3 << bits)])
    im.save(path, bits=bits)
    with open(path, "rb") as f:
        assert f.read(25)[24] == bits  # the IHDR bit depth
    return np.array(Image.open(path))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (13, 33), (48, 61)])
def test_palette_png_matches_pil(tmp_path, bits, shape):
    """A palette PNG as PIL writes it: ``image_io.read_indexed`` (native
    and plain unfilter) and ``imread_indexed`` give PIL's index array,
    ``imread`` refuses it (cv2 would expand it to colours)."""
    p = str(tmp_path / "p.png")
    want = _palette_png(p, bits, shape, seed=bits * 100 + shape[1])
    for plain in (False, True):
        _same(image_io.read_indexed(p, plain=plain), want)
    _same(tda.imread_indexed(p), jda.imread_indexed(p))
    with pytest.raises(ValueError, match="colour type 3"):
        image_io.imread(p)


@pytest.mark.parametrize("shape,dtype", [
    ((9, 14), np.uint8), ((9, 14), np.uint16), ((9, 14, 3), np.uint8),
    ((9, 14, 4), np.uint8)])
def test_imread_indexed_other_types_match_jax(tmp_path, shape, dtype):
    """Gray (8 and 16 bits) and colour PNGs: ``imread_indexed`` takes
    PIL's array (colour in RGB order) and its first channel, as the JAX
    function does."""
    arr = np.random.default_rng(5).integers(
        0, np.iinfo(dtype).max, shape).astype(dtype)
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, arr)
    _same(tda.imread_indexed(p), jda.imread_indexed(p))


# ------------------------------------------------------------ cv_ops --
@pytest.mark.parametrize("size", BLUR_SIZES)
@pytest.mark.parametrize("axis", ["row", "col"])
@pytest.mark.parametrize("shape", [(48, 64, 3), (3, 5, 3), (2, 40),
                                   (16, 16, 4), (9, 40, 1), (1, 30, 3),
                                   (30, 1, 2), (228, 304, 3)])
def test_filter2d_matches_cv2(size, axis, shape):
    """The motion kernels of ``add_noise`` (k x k, one middle row or
    column of 1/k) and their 1 x k / k x 1 forms."""
    k = np.zeros((size, size), np.float32)
    if axis == "row":
        k[(size - 1) // 2, :] = 1.0
    else:
        k[:, (size - 1) // 2] = 1.0
    img = np.random.default_rng(size).integers(0, 256, shape).astype(
        np.uint8)
    for kern in (k / size, (k[(size - 1) // 2:(size + 1) // 2] if axis ==
                            "row" else k[:, (size - 1) // 2:(size + 1) // 2])
                 / size):
        _same(cv_ops.filter2d(img, kern), cv2.filter2D(img, -1, kern))


def _cube():
    """Every 24-bit colour as a (4096, 4096, 3) uint8 image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("width", [4096, 1, 4])
def test_bgr2hls_every_colour(width):
    """Every colour, in rows of 4096 pixels (the vector loop), and in rows
    of 1 and 4 (OpenCV's scalar code)."""
    img = _cube().reshape(-1, width, 3)
    _same(cv_ops.cvt_bgr2hls(img), cv2.cvtColor(img, cv2.COLOR_BGR2HLS))


@pytest.mark.parametrize("width", [256, 1, 9])
def test_hls2bgr_every_hls(width):
    """Every (H < 180, L, S) triple, and H up to 255 at odd widths."""
    h, l, s = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                          indexing="ij")
    img = np.stack([h, l, s], -1).astype(np.uint8).reshape(-1, width, 3)
    _same(cv_ops.cvt_hls2bgr(img), cv2.cvtColor(img, cv2.COLOR_HLS2BGR))
    hi = np.random.default_rng(width).integers(0, 256, (63, width + 9, 3))
    hi = hi.astype(np.uint8)
    _same(cv_ops.cvt_hls2bgr(hi), cv2.cvtColor(hi, cv2.COLOR_HLS2BGR))


@pytest.mark.parametrize("w", [1, 5, 8, 9, 15, 17, 63, 304])
def test_hls_round_trip_at_odd_widths(w):
    img = np.random.default_rng(w).integers(0, 256, (29, w, 3)).astype(
        np.uint8)
    hls = cv_ops.cvt_bgr2hls(img)
    _same(hls, cv2.cvtColor(img, cv2.COLOR_BGR2HLS))
    _same(cv_ops.cvt_hls2bgr(hls), cv2.cvtColor(hls, cv2.COLOR_HLS2BGR))


CUBIC = [((12, 16, 3), (48, 64)), ((57, 76, 3), (228, 304)),
         ((5, 7, 1), (20, 31)), ((10, 10, 2), (33, 17)), ((20, 30, 4), (7, 9)),
         ((16, 16, 5), (64, 63)), ((1, 6, 3), (4, 12)), ((8, 8), (3, 30)),
         ((6, 9, 3), (6, 9))]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("src,dst", CUBIC)
def test_cubic_resize_matches_cv2(dtype, src, dst):
    img = np.random.default_rng(len(src) + dst[0]).normal(
        size=src).astype(dtype)
    dh, dw = dst
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(dtype == np.float64)  # f32: OpenCV's own code
    try:
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_CUBIC)
    finally:
        cv2.ipp.setUseIPP(ipp)
    _same(cv_ops.resize(img, (dw, dh), cv_ops.INTER_CUBIC), want)
    with pytest.raises(ValueError, match="INTER_CUBIC"):
        cv_ops.resize(img.astype(np.uint8), (dw, dh), cv_ops.INTER_CUBIC)
