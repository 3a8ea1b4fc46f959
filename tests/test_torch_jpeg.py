"""The port's JPEG decoder (``data/jpeg.py``, ``native/jpeg.cc``) against
``tf.io.decode_jpeg(raw, channels=3)``, which the JAX package decodes
with, and the image decode of ``data/images.py`` against the JAX
package's ``_decode``.

Files: written by PIL (4:4:4, 4:2:2, 4:2:0, grayscale), by TF (4:4:4,
4:2:0, grayscale) and by the port's own writer (4:4:4, 4:2:0, 4:2:2,
4:4:0, grayscale), at quality 10, 50 and 95 and sizes 1x1, 17x400 and
33x47 (odd sizes, partial MCUs, a chroma plane of width 1 and 2), with
restart intervals, COM and APPn segments. Pixels: gradients plus Gaussian
noise from numpy seeds, and a 0/255 checkerboard for extreme
coefficients.

Tolerance: none. Every decode is byte-equal to TF's (which runs
libjpeg-turbo's SSE2 fast IDCT, its fancy upsampling and its integer
color tables; the port reproduces that arithmetic, 16-bit wrapping and
the final saturation included, so no byte differs on these files).
``decode_image`` is bit-equal to the JAX ``_decode``. Progressive,
arithmetic-coded, lossless, 12-bit, CMYK, truncated and non-JPEG input
raise ``ValueError`` naming the mode.
"""

import io
import os

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from esrecsys_tpu.data import images as jimages
from esrecsys_tpu_torch.data import images, jpeg

SIZES = [(1, 1), (17, 400), (33, 47)]
QUALITIES = [10, 50, 95]


def picture(h, w, seed=0, channels=3, noise=25.0):
    """A gradient with Gaussian noise, (h, w, channels) uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255.0 / max(w - 1, 1), y * 255.0 / max(h - 1, 1),
                     (x + y) * 3.0 % 256], -1)
    px = np.clip(base + rng.normal(0, noise, base.shape), 0,
                 255).astype(np.uint8)
    return px if channels == 3 else px[..., :1]


def tf_decode(data: bytes) -> np.ndarray:
    return tf.io.decode_jpeg(data, channels=3).numpy()


def pil_file(px, quality, mode, **kw) -> bytes:
    bio = io.BytesIO()
    if mode == "gray":
        Image.fromarray(px[..., 0], "L").save(bio, "JPEG", quality=quality,
                                              **kw)
    else:
        sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[mode]
        Image.fromarray(px).save(bio, "JPEG", quality=quality,
                                 subsampling=sub, **kw)
    return bio.getvalue()


def tf_file(px, quality, mode) -> bytes:
    return tf.io.encode_jpeg(px, quality=quality,
                             chroma_downsampling=mode == "4:2:0").numpy()


def assert_equal_to_tf(data: bytes):
    want = tf_decode(data)
    got = jpeg.decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_pil_files_decode_as_tf_does(size, quality, mode):
    px = picture(*size, seed=quality)
    assert_equal_to_tf(pil_file(px, quality, mode))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:0", "gray"])
def test_tf_files_decode_as_tf_does(size, quality, mode):
    px = picture(*size, seed=quality + 1,
                 channels=1 if mode == "gray" else 3)
    assert_equal_to_tf(tf_file(px, quality, mode))


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:0", "4:2:2", "4:4:0",
                                  "gray"])
@pytest.mark.parametrize("restart", [0, 1, 7])
def test_own_writer_files_decode_as_tf_does(mode, restart):
    """The writer's files, with and without restart intervals, decoded by
    TF equal the port's decode, and a smooth picture comes back within a
    few levels."""
    for (h, w), q in zip(SIZES + [(40, 3), (2, 2)], [10, 50, 95, 75, 90]):
        px = picture(h, w, seed=h * w, channels=1 if mode == "gray" else 3)
        data = jpeg.encode(px, q, "4:2:0" if mode == "gray" else mode,
                           restart)
        assert (b"\xff\xdd" in data) == (restart > 0)
        assert_equal_to_tf(data)
    big = picture(64, 80, channels=1 if mode == "gray" else 3, noise=0)
    got = jpeg.decode(jpeg.encode(big, 95, "4:2:0" if mode == "gray"
                                  else mode, restart))
    err = np.abs(got.astype(int) - np.broadcast_to(big, got.shape)).mean()
    assert err < 3, err


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 3},
                                {"restart_marker_rows": 1}])
def test_pil_restart_markers(kw):
    data = pil_file(picture(33, 47), 80, "4:2:0", **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_equal_to_tf(data)


def test_segments_are_skipped_and_extremes_saturate():
    """COM and APPn segments are skipped; a 0/255 checkerboard at quality
    100 drives the IDCT to its saturation and still decodes as TF does."""
    px = picture(24, 24)
    assert_equal_to_tf(pil_file(px, 90, "4:2:0", comment=b"a comment",
                                exif=b"Exif\x00\x00" + b"\x00" * 16))
    board = ((np.indices((64, 64)).sum(0) % 2) * 255).astype(np.uint8)
    for sub in ("4:4:4", "4:2:0"):
        assert_equal_to_tf(pil_file(np.repeat(board[..., None], 3, -1), 100,
                                    sub))


def test_header():
    data = tf_file(picture(33, 47), 90, "4:2:0")
    assert jpeg.header(data) == (33, 47, 3)
    assert jpeg.header(pil_file(picture(5, 7), 90, "gray")) == (5, 7, 1)


def _patched_sof(marker: int, precision: int = 8) -> bytes:
    data = bytearray(pil_file(picture(16, 16), 90, "4:2:0"))
    i = data.index(b"\xff\xc0")
    data[i + 1] = marker
    data[i + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("make,match", [
    (lambda: pil_file(picture(33, 47), 90, "4:2:0", progressive=True),
     r"progressive JPEG \(SOF2\)"),
    (lambda: tf.io.encode_jpeg(picture(33, 47), progressive=True).numpy(),
     r"progressive JPEG \(SOF2\)"),
    (lambda: _patched_sof(0xC9), r"arithmetic-coded JPEG \(SOF9\)"),
    (lambda: _patched_sof(0xC3), r"lossless JPEG \(SOF3\)"),
    (lambda: _patched_sof(0xC0, precision=12), r"12-bit samples"),
    (lambda: (lambda b: (Image.fromarray(picture(16, 16)).convert("CMYK")
                         .save(b, "JPEG"), b.getvalue())[1])(io.BytesIO()),
     "CMYK"),
    (lambda: b"\x89PNG\r\n", "not a JPEG"),
], ids=["progressive-pil", "progressive-tf", "arithmetic", "lossless",
        "12-bit", "cmyk", "png"])
def test_unsupported_modes_raise(make, match):
    with pytest.raises(ValueError, match=match):
        jpeg.decode(make())


@pytest.mark.parametrize("cut", [0.5, -2, 60])
def test_truncated_files_raise(cut):
    data = pil_file(picture(64, 64), 95, "4:2:0")
    n = int(len(data) * cut) if isinstance(cut, float) else (
        len(data) + cut if cut < 0 else cut)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode(data[:n])


@pytest.mark.parametrize("shape", [(37, 50), (7, 5), (1, 1), (32, 32)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("size", [32, 33, 6, 4])
def test_decode_image_equals_the_jax_decode(tmp_path, shape, size):
    """Odd and even crops and pads: the reference's
    ``resize_with_crop_or_pad`` offsets, zero padding before the scale."""
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(tf_file(picture(*shape, seed=size), 90, "4:2:0"))
    want = jimages._decode(tf, path, size).numpy()
    got = images.decode_image(path, size)
    assert got.dtype == np.float32 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_decode_image_offsets():
    """A 7x5 image taken to 6x6 keeps rows 0-5 (crop (7 - 6) // 2 = 0)
    and gets no column on the left and one on the right ((6 - 5) // 2 =
    0), the padding at -0.5."""
    px = picture(7, 5, channels=3)
    data = jpeg.encode(px, 95, "4:4:4")
    rgb = jpeg.decode(data)
    got = jpeg.decode_fit(data, 6, images.SCALE_LUT)
    np.testing.assert_array_equal(got[:, :5], images.SCALE_LUT[rgb[0:6]])
    assert (got[:, 5] == np.float32(-0.5)).all()
    got4 = jpeg.decode_fit(data, 4, images.SCALE_LUT)  # crop 1 row, 0 cols
    np.testing.assert_array_equal(got4, images.SCALE_LUT[rgb[1:5, 0:4]])


def test_parallel_decode_equals_serial(tmp_path):
    paths = []
    for i in range(24):
        p = tmp_path / f"{i}.jpg"
        p.write_bytes(jpeg.encode(picture(40 + i, 30 + 2 * i, seed=i), 80,
                                  "4:2:0", restart_interval=i % 3))
        paths.append(str(p))
    serial = np.stack([images.decode_image(p, 36) for p in paths])
    with images.decode_pool() as pool:
        parallel = images.decode_batch(pool, paths, 36)
    np.testing.assert_array_equal(parallel, serial)
    with pytest.raises(FileNotFoundError):
        images.decode_image(os.path.join(str(tmp_path), "missing.jpg"), 8)
