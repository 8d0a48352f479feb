"""The port's image layer against OpenCV, on the CPU: the PNG codec
(``rdfc_gan_torch.data.image_io``, with its host C++ row unfilter) and the
resampling and colour maps of the data pipelines
(``rdfc_gan_torch.data.cv_ops``), at the shapes the pipelines produce:
480x640 cut to 420x555, rotated within +-5 degrees, resized to 240x317 and
cropped to 224x304 (NYUv2 train); 420x555 -> 224x304 (NYUv2 test); -> 256x256
(sparse, raw, SUN RGB-D).

Everything is bit-equal to ``cv2`` but one case: ``gaussian_blur`` in the
last ``width % 16`` columns of an image whose width is not a multiple of
16, where OpenCV's scalar tail sums the taps in an order that ``cv_ops``
does not reproduce; there the test allows 2 f32 ulps of the blurred value
(values in [0, 1]). Every width the pipelines blur (640, 304, 256) is a
multiple of 16, and those are held bit for bit.

``cv2`` is imported inside the tests that compare with it.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from rdfc_gan_torch.data import cv_ops, image_io

# Tier-1 runs several pytest workers on the machine's cores: one intra-op
# thread per worker.
torch.set_num_threads(1)

TYPES = {
    "gray8": ((37, 53), np.uint8),
    "gray16": ((37, 53), np.uint16),
    "bgr8": ((37, 53, 3), np.uint8),
    "bgra8": ((37, 53, 4), np.uint8),
    "bgr16": ((29, 31, 3), np.uint16),
}


def _image(kind, seed=0):
    shape, dt = TYPES[kind]
    r = np.random.RandomState(seed)
    return r.randint(0, np.iinfo(dt).max + 1, shape).astype(dt)


@pytest.mark.parametrize("ftype", [None, 0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", sorted(TYPES))
def test_png_round_trip(tmp_path, kind, ftype):
    """Written by the port with each row filter (or the adaptive choice),
    read back by the port (native and plain unfilter) and by OpenCV."""
    import cv2

    img = _image(kind)
    p = str(tmp_path / "x.png")
    image_io.imwrite(p, img, ftype)
    for got in (image_io.imread(p), image_io.imread(p, plain=True),
                cv2.imread(p, cv2.IMREAD_UNCHANGED)):
        assert got.dtype == img.dtype
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", sorted(TYPES))
def test_reads_opencv_files(tmp_path, kind):
    """Files OpenCV writes (libpng's own filters) read equal to
    ``cv2.imread(IMREAD_UNCHANGED)``; ``bgr2rgb`` is COLOR_BGR2RGB."""
    import cv2

    yy, xx = np.mgrid[0:120, 0:160]
    base = _image(kind)
    shape, dt = TYPES[kind]
    smooth = ((yy * 3 + xx * 5) % (np.iinfo(dt).max + 1)).astype(dt)
    smooth = smooth[:shape[0], :shape[1]]
    if len(shape) == 3:
        smooth = np.repeat(smooth[..., None], shape[2], -1)
    for img in (base, smooth):
        p = str(tmp_path / "cv.png")
        assert cv2.imwrite(p, img)
        want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        got = image_io.imread(p)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if kind == "bgr8":
            np.testing.assert_array_equal(
                image_io.bgr2rgb(got), cv2.cvtColor(want, cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain(bpp):
    """The host C++ unfilter against the numpy/Python one on random rows
    with random filter bytes (0-4)."""
    r = np.random.RandomState(bpp)
    h, rowbytes = 23, bpp * 19
    rows = r.randint(0, 256, (h, rowbytes + 1)).astype(np.uint8)
    rows[:, 0] = r.randint(0, 5, h)
    data = rows.tobytes()
    np.testing.assert_array_equal(
        image_io.unfilter(data, h, rowbytes, bpp),
        image_io.unfilter_plain(data, h, rowbytes, bpp))
    rows[7, 0] = 9
    for fn in (image_io.unfilter, image_io.unfilter_plain):
        with pytest.raises(ValueError, match="row 7: filter type 9"):
            fn(rows.tobytes(), h, rowbytes, bpp)


def _with_ihdr(buf: bytes, **fields) -> bytes:
    """``buf`` (a PNG from ``encode_png``) with IHDR fields replaced."""
    names = ("w", "h", "depth", "ctype", "comp", "filt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", buf[16:29])))
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *(vals[n] for n in names))
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return buf[:16] + body + crc + buf[33:]


def test_unsupported_pngs_raise(tmp_path):
    buf = image_io.encode_png(_image("gray8"))
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_png(_with_ihdr(buf, interlace=1))
    with pytest.raises(ValueError, match="colour type 3"):
        image_io.decode_png(_with_ihdr(buf, ctype=3))
    with pytest.raises(ValueError, match="bit depth 4"):
        image_io.decode_png(_with_ihdr(buf, depth=4))
    with pytest.raises(ValueError, match="bad CRC"):
        image_io.decode_png(buf[:20] + bytes([buf[20] ^ 0xFF]) + buf[21:])
    with pytest.raises(ValueError, match="signature"):
        image_io.decode_png(b"GIF89a" + buf[6:])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent fallback to the plain unfilter: a compiler that fails
    makes the read raise."""
    monkeypatch.setattr(image_io, "_LIB", None)
    monkeypatch.setattr(image_io, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    p = str(tmp_path / "x.png")
    image_io.imwrite(p, _image("gray8"))
    with pytest.raises(RuntimeError, match="png_unfilter"):
        image_io.imread(p)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the host compiler"):
        image_io.imread(p)


# ------------------------------------------------------------ cv_ops --
RESIZES = [((480, 640), (420, 555)), ((420, 555), (240, 317)),
           ((420, 555), (224, 304)), ((420, 555), (256, 256)),
           ((480, 640), (256, 256)), ((120, 160), (256, 256)),
           ((240, 317), (224, 304)), ((480, 640), (240, 320)),
           ((33, 47), (64, 80)),
           # the v1 pipelines: nyuv2_s2d's shorter side to int(240 s) for
           # s in [1, 1.5), the exact 2x of its test path above included;
           # ddrnet_human's round(480 s) x round(640 s), s in [1, 1.4]
           # (widths not a multiple of 16); folder_dataset's 256x256;
           # nyuv2_r2r's 420x555 border cut to 256x320
           ((480, 640), (241, 321)), ((480, 640), (263, 351)),
           ((480, 640), (300, 400)), ((480, 640), (359, 479)),
           ((480, 640), (487, 649)), ((480, 640), (530, 707)),
           ((480, 640), (583, 777)), ((480, 640), (672, 896)),
           ((100, 120), (256, 256)), ((420, 555), (256, 320))]
DTYPES = ["u8c3", "u8c1", "u16", "f32", "f32c3"]


def _typed(kind, hw, seed):
    r = np.random.RandomState(seed)
    h, w = hw
    return {"u8c3": lambda: r.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "u8c1": lambda: r.randint(0, 256, (h, w)).astype(np.uint8),
            "u16": lambda: r.randint(0, 10000, (h, w)).astype(np.uint16),
            "f32": lambda: r.uniform(0, 10, (h, w)).astype(np.float32),
            "f32c3": lambda: r.uniform(0, 1, (h, w, 3)).astype(np.float32),
            }[kind]()


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_opencv(src, dst, kind):
    """Linear and nearest, bit for bit."""
    import cv2

    img = _typed(kind, src, zlib.crc32(repr((src, dst, kind)).encode()))
    size = (dst[1], dst[0])
    for ours, theirs in ((cv_ops.INTER_LINEAR, cv2.INTER_LINEAR),
                         (cv_ops.INTER_NEAREST, cv2.INTER_NEAREST)):
        got = cv_ops.resize(img, size, interpolation=ours)
        want = cv2.resize(img, size, interpolation=theirs)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=str(ours))


@pytest.mark.parametrize("src,dst", [((480, 640), (480, 640)),
                                     ((480, 640), (240, 320)),
                                     ((480, 640), (583, 777)),
                                     ((37, 51), (64, 80))])
def test_f64_nearest_resize_matches_opencv(src, dst):
    """ddrnet_human's test path resizes its f64 depth (uint16 / 1000.0)
    nearest."""
    import cv2

    img = np.random.RandomState(dst[1]).uniform(0, 3, src)
    got = cv_ops.resize(img, (dst[1], dst[0]), cv_ops.INTER_NEAREST)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


ANGLES = [-5.0, -3.7, -0.25, 0.0, 1.3, 4.61, 5.0]
WARP_SHAPES = [(420, 555), (480, 640), (120, 160)]


@pytest.mark.parametrize("hw", WARP_SHAPES)
@pytest.mark.parametrize("angle", ANGLES)
def test_rotation_and_warp_match_opencv(angle, hw):
    """getRotationMatrix2D within a few ulps of the translation; warpAffine
    nearest and linear bit for bit (a nearest output that rounds a
    coordinate a last bit away from OpenCV's picks another pixel)."""
    import cv2

    h, w = hw
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    ours = cv_ops.rotation_matrix((w / 2, h / 2), angle, 1.0)
    np.testing.assert_allclose(ours, m, rtol=0, atol=4 * np.spacing(w))
    for i, kind in enumerate(DTYPES):
        img = _typed(kind, hw, i)
        for ours, theirs in ((cv_ops.INTER_NEAREST, cv2.INTER_NEAREST),
                             (cv_ops.INTER_LINEAR, cv2.INTER_LINEAR)):
            got = cv_ops.warp_affine(img, m, (w, h), ours)
            want = cv2.warpAffine(img, m, (w, h), flags=theirs)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {ours}")


@pytest.mark.parametrize("hw", [(480, 640), (224, 304), (256, 256),
                                (37, 41), (64, 317), (420, 555), (20, 13),
                                (15, 70)])
def test_gaussian_blur_matches_opencv(hw):
    """Spatter's blur: f32, 33x33, sigma 8, BORDER_REFLECT_101; bit for
    bit, the scalar tails of widths not a multiple of 4 or 8 included."""
    import cv2

    r = np.random.RandomState(hw[0])
    f = r.uniform(size=hw).astype(np.float32)
    np.testing.assert_array_equal(cv_ops.gaussian_kernel(33, 8),
                                  cv2.getGaussianKernel(33, 8, cv2.CV_32F)[:, 0])
    np.testing.assert_array_equal(cv_ops.gaussian_blur(f, (33, 33), 8),
                                  cv2.GaussianBlur(f, (33, 33), 8))


def test_dilate_matches_opencv():
    import cv2

    r = np.random.RandomState(1)
    m = (r.uniform(size=(57, 61)) > 0.93).astype(np.uint8)
    np.testing.assert_array_equal(cv_ops.dilate(m, (5, 5)),
                                  cv2.dilate(m, np.ones((5, 5), np.uint8)))


@pytest.mark.parametrize("name", ["PLASMA", "VIRIDIS", "JET"])
def test_colormap_tables_match_opencv(name):
    """All 256 values of each table, and a map of an image."""
    import cv2

    ours = getattr(cv_ops, f"COLORMAP_{name}")
    theirs = getattr(cv2, f"COLORMAP_{name}")
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(cv_ops.apply_colormap(ramp, ours),
                                  cv2.applyColorMap(ramp, theirs))
    img = np.random.RandomState(2).randint(0, 256, (40, 50)).astype(np.uint8)
    np.testing.assert_array_equal(cv_ops.apply_colormap(img, ours),
                                  cv2.applyColorMap(img, theirs))


def test_host_unfilter_builds_into_build_dir():
    """The native library lives under rdfc_gan_torch/_build, named by a hash
    of its source and flags."""
    lib = image_io._native()
    assert os.path.dirname(lib._name) == image_io._BUILD_DIR
    assert os.path.basename(lib._name).startswith("libpng_unfilter-")
