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

Arithmetic-coded files (sequential and progressive, with restart
intervals and DAC conditioning), written by ``tests/torch_jpeg_arith.py``
since no writer at hand makes them; TF decodes them.

Progressive files: PIL's and TF's writers (4:4:4, 4:2:2, 4:2:0,
grayscale, odd sizes, restart markers), and PIL's files with their last
scans dropped, whose unrefined coefficients libjpeg estimates (block
smoothing). Four-component files: PIL's CMYK writer (Adobe transform 0),
the same file without its Adobe segment, and with the transform byte set
to 2, which makes it a YCCK file (libjpeg converts its first three
components as YCbCr, then inverts them). The committed fixtures of
``tests/torch_fixtures/jpeg/`` (written by :func:`write_fixtures`) still
decode as TF does and as their stored TF decodes say.

Tolerance: none. Every decode is byte-equal to TF's (which runs
libjpeg-turbo's SSE2 fast IDCT, its fancy upsampling and its integer
color tables; the port reproduces that arithmetic, 16-bit wrapping and
the final saturation included, so no byte differs on these files).
``decode_image`` is bit-equal to the JAX ``_decode``. Lossless,
hierarchical and 12-bit files (Huffman- or arithmetic-coded) raise
``ValueError`` naming the mode, and TF refuses each of them too;
truncated and non-JPEG input raise as well.
"""

import io
import os
import sys

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from esrecsys_tpu.data import images as jimages
from esrecsys_tpu_torch.data import images, jpeg

from torch_jpeg_arith import write_arithmetic

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


def cmyk_file(px4, quality=90, **kw) -> bytes:
    """PIL's CMYK JPEG (an Adobe segment, transform 0) of (h, w, 4)."""
    bio = io.BytesIO()
    Image.fromarray(px4, "CMYK").save(bio, "JPEG", quality=quality, **kw)
    return bio.getvalue()


def cmyk_picture(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([picture(h, w, seed=seed),
                           rng.integers(0, 256, (h, w, 1), np.uint8)], -1)


def without_adobe(data: bytes) -> bytes:
    """The file with its APP14 (Adobe) segment cut out."""
    i = data.index(b"\xff\xee")
    return data[:i] + data[i + 2 + int.from_bytes(data[i + 2:i + 4], "big"):]


def with_transform(data: bytes, transform: int) -> bytes:
    """The file with its Adobe segment's color transform byte replaced."""
    b = bytearray(data)
    b[b.index(b"Adobe") + 11] = transform
    return bytes(b)


def scan_starts(data: bytes) -> list:
    """Offsets of the SOS markers (none occurs inside the entropy-coded
    data, where 0xFF is stuffed)."""
    return [i for i in range(len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


def first_scans(data: bytes, n: int) -> bytes:
    """A progressive file cut after its first n scans, then EOI."""
    return data[:scan_starts(data)[n]] + b"\xff\xd9"


def tf_refuses(data: bytes) -> bool:
    try:
        tf_decode(data)
    except (tf.errors.InvalidArgumentError, ValueError):
        return True
    return False


@pytest.mark.parametrize("make", [
    lambda: pil_file(picture(33, 47), 90, "4:2:0", progressive=True),
    lambda: tf.io.encode_jpeg(picture(33, 47), progressive=True).numpy(),
    lambda: cmyk_file(cmyk_picture(16, 16)),
    lambda: write_arithmetic(picture(16, 16), 90),
], ids=["progressive-pil", "progressive-tf", "cmyk", "arithmetic"])
def test_formerly_refused_modes_decode_as_tf_does(make):
    assert_equal_to_tf(make())


@pytest.mark.parametrize("size", [(1, 1), (17, 40), (33, 47)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sof9", "sof10"])
def test_arithmetic_files_decode_as_tf_does(size, mode, progressive):
    """Arithmetic-coded files (``tests/torch_jpeg_arith.py``'s writer):
    TF decodes them, to pixels as close to the picture as a Huffman-coded
    file of the same quality, and the port decodes them as TF does."""
    px = picture(*size, seed=size[0], noise=8.0)
    if mode == "gray":
        px = px[..., 0]
    data = write_arithmetic(px, 80, "4:2:0" if mode == "gray" else mode,
                            progressive=progressive)
    assert data[data.index(b"\xff\xc9" if not progressive
                           else b"\xff\xca") + 1] in (0xC9, 0xCA)
    assert_equal_to_tf(data)
    if size != (1, 1):
        huffman = jpeg.encode(px, 80, "4:2:0" if mode == "gray" else mode)
        err = np.abs(tf_decode(data).astype(int) - np.atleast_3d(px)).mean()
        ref = np.abs(tf_decode(huffman).astype(int)
                     - np.atleast_3d(px)).mean()
        assert err < ref + 0.5, (err, ref)


@pytest.mark.parametrize("kw", [dict(restart=3),
                                dict(restart=2, progressive=True),
                                dict(dac=(1, 3, 2)),
                                dict(dac=(0, 0, 63), progressive=True)],
                         ids=["restart", "restart-progressive", "dac",
                              "dac-progressive"])
def test_arithmetic_restarts_and_conditioning(kw):
    """Restart intervals (statistics and predictions reset at each
    marker) and DAC conditioning parameters (L, U, K)."""
    data = write_arithmetic(picture(41, 53, seed=4, noise=8.0), 85, **kw)
    assert (b"\xff\xdd" in data) == ("restart" in kw)
    assert (b"\xff\xcc" in data) == ("dac" in kw)
    assert_equal_to_tf(data)


@pytest.mark.parametrize("size", SIZES + [(120, 97)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_pil_progressive_files_decode_as_tf_does(size, quality, mode):
    data = pil_file(picture(*size, seed=quality), quality, mode,
                    progressive=True)
    assert b"\xff\xc2" in data
    assert_equal_to_tf(data)


@pytest.mark.parametrize("size", SIZES + [(120, 97)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("mode", ["4:4:4", "4:2:0", "gray"])
def test_tf_progressive_files_decode_as_tf_does(size, quality, mode):
    px = picture(*size, seed=quality + 2,
                 channels=1 if mode == "gray" else 3)
    data = tf.io.encode_jpeg(px, quality=quality, progressive=True,
                             chroma_downsampling=mode == "4:2:0").numpy()
    assert b"\xff\xc2" in data
    assert_equal_to_tf(data)


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 2},
                                {"restart_marker_rows": 1}],
                         ids=["blocks", "rows"])
def test_progressive_restart_markers(mode, kw):
    """Restart intervals inside progressive scans: EOB runs and DC
    predictions restart at every marker."""
    data = pil_file(picture(57, 83, seed=3), 85, mode, progressive=True,
                    **kw)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_equal_to_tf(data)


@pytest.mark.parametrize("mode", ["4:4:4", "4:2:2", "4:2:0", "gray",
                                  "cmyk"])
@pytest.mark.parametrize("size", [(64, 64), (33, 47), (50, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_block_smoothing(mode, size):
    """Files whose scans stop before every coefficient is refined to bit
    0: libjpeg-turbo 2.1 estimates the first nine AC coefficients from the
    DC values of a 5 x 5 block neighbourhood (and the DC too when no AC
    scan came), and TF decodes them so. Every cut of the scan script."""
    if mode == "cmyk":
        data = cmyk_file(cmyk_picture(*size, seed=5), 70, progressive=True)
    else:
        data = pil_file(picture(*size, seed=5), 70, mode, progressive=True)
    n = len(scan_starts(data))
    assert n > 2
    for keep in range(1, n):
        assert_equal_to_tf(first_scans(data, keep))


@pytest.mark.parametrize("variant", ["adobe", "no-adobe", "ycck",
                                     "unknown-transform"])
@pytest.mark.parametrize("kw", [{}, {"progressive": True},
                                {"subsampling": 2}],
                         ids=["baseline", "progressive", "4:2:0"])
def test_four_component_files_decode_as_tf_does(variant, kw):
    """TF decodes four components to CMYK and converts them itself: r =
    c * k / 255 for an Adobe file (inverted inks), (255 - k) * (255 - c)
    / 255 otherwise. A YCCK file (transform 2; libjpeg takes any
    transform but 0 as YCCK) is PIL's CMYK file with its transform byte
    set, so its components are reinterpreted, not re-encoded."""
    data = cmyk_file(cmyk_picture(33, 47, seed=7), 80, **kw)
    data = {"adobe": data, "no-adobe": without_adobe(data),
            "ycck": with_transform(data, 2),
            "unknown-transform": with_transform(data, 1)}[variant]
    assert_equal_to_tf(data)


def test_cmyk_formula_on_flat_blocks():
    """On flat 8x8-aligned blocks the IDCT is exact, so the components are
    PIL's inverted inks and TF's output is c * k / 255 of them."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (8, 16, 4), dtype=np.uint8)
    px = blocks.repeat(8, 0).repeat(8, 1)
    data = cmyk_file(px, 100)
    inks = 255 - px.astype(np.int64)
    want = inks[..., :3] * inks[..., 3:] // 255
    np.testing.assert_array_equal(tf_decode(data), want)
    np.testing.assert_array_equal(jpeg.decode(data), want)


@pytest.mark.parametrize("make,match", [
    (lambda: _patched_sof(0xC3), r"lossless JPEG \(SOF3\)"),
    (lambda: _patched_sof(0xC0, precision=12), r"12-bit samples"),
    (lambda: _patched_sof(0xC5), r"hierarchical JPEG \(SOF5\)"),
    (lambda: _patched_sof(0xCB), r"lossless JPEG \(SOF11"),
    (lambda: _patched_sof(0xCD), r"hierarchical JPEG \(SOF13"),
], ids=["lossless", "12-bit", "hierarchical", "lossless-arithmetic",
        "hierarchical-arithmetic"])
def test_modes_tf_refuses_raise(make, match):
    """libjpeg-turbo 2.1 (TF's) refuses these at the frame header, before
    any entropy-coded data, so a baseline file with its SOF marker or
    precision patched is such a file for both decoders."""
    data = make()
    assert tf_refuses(data)
    with pytest.raises(ValueError, match=match):
        jpeg.decode(data)


@pytest.mark.parametrize("make,match", [
    (lambda: b"\x89PNG\r\n", "not a JPEG"),
    (lambda: write_arithmetic(picture(16, 16), 90)[:-40],
     "truncated JPEG"),
], ids=["png", "truncated-arithmetic"])
def test_unsupported_modes_raise(make, match):
    with pytest.raises(ValueError, match=match):
        jpeg.decode(make())


@pytest.mark.parametrize("cut", [0.5, 0.9])
def test_truncated_progressive_files_raise_as_tf_does(cut):
    """TF refuses a progressive file cut inside a scan (it does not try
    to recover truncated files), and so does the port."""
    data = pil_file(picture(64, 64), 95, "4:2:0", progressive=True)
    data = data[:int(len(data) * cut)]
    assert tf_refuses(data)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode(data)


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


@pytest.mark.parametrize("maker", ["pil", "tf"])
def test_decode_image_of_a_progressive_file_equals_the_jax_decode(
        tmp_path, maker):
    path = str(tmp_path / "p.jpg")
    px = picture(37, 50, seed=4)
    data = (pil_file(px, 85, "4:2:0", progressive=True) if maker == "pil"
            else tf.io.encode_jpeg(px, quality=85,
                                   progressive=True).numpy())
    with open(path, "wb") as f:
        f.write(data)
    want = jimages._decode(tf, path, 33).numpy()
    np.testing.assert_array_equal(images.decode_image(path, 33), want)


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


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "jpeg")
# corpus-sized files: their TF decodes are kept as SHA-256 digests only
CORPUS_FIXTURES = ("corpus_prog_420_500x400.jpg",
                   "corpus_prog_444_320x400.jpg",
                   "corpus_cmyk_400x400.jpg")


def fixture_files() -> dict:
    """The committed fixture set (file name -> bytes), written by PIL, TF
    and ``tests/torch_jpeg_arith.py``: progressive files of each
    subsampling, with restart markers and with scans left unrefined,
    CMYK and YCCK files, arithmetic-coded ones, and three corpus-sized
    files (400 px wide) for the image pipeline on a card."""
    smooth = pil_file(picture(64, 64, seed=9), 70, "4:2:0",
                      progressive=True)
    cmyk = cmyk_file(cmyk_picture(33, 40, seed=11), 80)
    files = {
        "prog_pil_444_47x33.jpg": pil_file(picture(47, 33, seed=1), 90,
                                           "4:4:4", progressive=True),
        "prog_pil_422_61x50.jpg": pil_file(picture(61, 50, seed=2), 75,
                                           "4:2:2", progressive=True),
        "prog_pil_420_97x120.jpg": pil_file(picture(97, 120, seed=3), 85,
                                            "4:2:0", progressive=True),
        "prog_pil_gray_33x47.jpg": pil_file(picture(33, 47, seed=4), 60,
                                            "gray", progressive=True),
        "prog_pil_420_rst_57x83.jpg": pil_file(
            picture(57, 83, seed=5), 80, "4:2:0", progressive=True,
            restart_marker_blocks=2),
        "prog_tf_420_64x80.jpg": tf.io.encode_jpeg(
            picture(64, 80, seed=6), quality=80, progressive=True).numpy(),
        "prog_tf_gray_50x37.jpg": tf.io.encode_jpeg(
            picture(50, 37, seed=7, channels=1), quality=90,
            progressive=True).numpy(),
        "prog_pil_420_smooth_64x64.jpg": first_scans(smooth, 5),
        "cmyk_adobe_33x40.jpg": cmyk,
        "cmyk_no_adobe_33x40.jpg": without_adobe(cmyk),
        "ycck_33x40.jpg": with_transform(cmyk, 2),
        "cmyk_prog_40x33.jpg": cmyk_file(cmyk_picture(40, 33, seed=12), 75,
                                         progressive=True),
        "arith_sof9_420_33x47.jpg": write_arithmetic(
            picture(33, 47, seed=16, noise=8.0), 85, restart=4),
        "arith_sof10_444_40x33.jpg": write_arithmetic(
            picture(40, 33, seed=17, noise=8.0), 80, "4:4:4",
            progressive=True),
        CORPUS_FIXTURES[0]: pil_file(picture(500, 400, seed=13, noise=6.0),
                                     85, "4:2:0", progressive=True),
        CORPUS_FIXTURES[1]: tf.io.encode_jpeg(
            picture(320, 400, seed=14, noise=6.0), quality=85,
            progressive=True, chroma_downsampling=False).numpy(),
        CORPUS_FIXTURES[2]: cmyk_file(
            np.concatenate([picture(400, 400, seed=15, noise=6.0),
                            np.full((400, 400, 1), 40, np.uint8)], -1),
            85, progressive=True),
    }
    return files


def write_fixtures(directory: str = FIXTURES) -> None:
    """Write :func:`fixture_files` and ``tf_decodes.npz`` (each small
    file's TF decode under its name, compressed; each corpus-sized file's
    as the SHA-256 hex digest of its bytes under ``sha256/<name>``)."""
    import hashlib

    os.makedirs(directory, exist_ok=True)
    decodes = {}
    for name, data in fixture_files().items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
        rgb = tf_decode(data)
        if name in CORPUS_FIXTURES:
            decodes[f"sha256/{name}"] = np.array(
                hashlib.sha256(rgb.tobytes()).hexdigest())
        else:
            decodes[name] = rgb
    np.savez_compressed(os.path.join(directory, "tf_decodes.npz"), **decodes)


def _fixture_names():
    return sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))


@pytest.mark.parametrize("name", _fixture_names())
def test_fixtures_still_equal_tf(name):
    """Each committed fixture decodes as TF decodes it today, and as the
    stored decode (or digest) says; the card's host, which has no TF,
    holds the port against the stored decodes."""
    import hashlib

    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    want = tf_decode(data)
    with np.load(os.path.join(FIXTURES, "tf_decodes.npz")) as z:
        if name in CORPUS_FIXTURES:
            assert str(z[f"sha256/{name}"]) == hashlib.sha256(
                want.tobytes()).hexdigest()
        else:
            np.testing.assert_array_equal(z[name], want)
    np.testing.assert_array_equal(jpeg.decode(data), want)


if __name__ == "__main__":
    # python tests/test_torch_jpeg.py: rewrite the committed fixtures
    write_fixtures(sys.argv[1] if len(sys.argv) > 1 else FIXTURES)
