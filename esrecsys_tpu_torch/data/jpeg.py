"""Baseline JPEG decoding and writing for the image pipeline.

The reference decodes with ``tf.io.decode_jpeg(raw, channels=3)``
(``esrecsys_tpu/data/images.py:61-66``), which runs libjpeg-turbo with
its fast integer IDCT and fancy upsampling. The port has neither
TensorFlow nor PIL, so it decodes in its own C++ (``native/jpeg.cc``,
built with ``g++`` at first use; without ``g++`` every call raises
``RuntimeError``: a decoder in Python would take seconds an image and
become the step). The decode equals TF's on baseline files: the same
IDCT arithmetic, upsampling filters and color tables
(``tests/test_torch_jpeg.py``).

Decodes Huffman-coded sequential files (SOF0, SOF1) of 8-bit samples,
grayscale or three components, at any whole-number sampling ratio, with
restart intervals. Progressive, lossless, hierarchical and
arithmetic-coded files, 12-bit samples, CMYK and YCCK raise
``ValueError`` naming the marker or the property, as do truncated and
corrupt files.

:func:`encode` writes baseline files (Annex K tables scaled by quality as
libjpeg scales them; 4:4:4, 4:2:0, 4:2:2, 4:4:0 or grayscale; an
optional restart interval) for synthetic corpora only.

The C++ calls release the interpreter lock, so a thread pool decodes in
parallel (``data/images.py``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from esrecsys_tpu_torch import native

_ERR = 512
SUBSAMPLING = {"4:4:4": 0, "4:2:0": 1, "4:2:2": 2, "4:4:0": 3}


def _check(rc: int, err) -> None:
    if rc < 0:
        raise ValueError(err.value.decode("utf-8", "replace"))


def header(data: bytes) -> Tuple[int, int, int]:
    """(height, width, components) from the frame header."""
    lib = native.load()
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(_ERR)
    _check(lib.jpeg_header(data, len(data), info, err, _ERR), err)
    return int(info[0]), int(info[1]), int(info[2])


def decode(data: bytes) -> np.ndarray:
    """The image as (height, width, 3) uint8 RGB; a grayscale file gives
    three equal channels."""
    h, w, _ = header(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    lib = native.load()
    _check(lib.jpeg_decode_rgb(data, len(data), out.reshape(-1), out.size,
                               err, _ERR), err)
    return out


def decode_fit(data: bytes, size: int, lut: np.ndarray) -> np.ndarray:
    """Decode, crop or pad to (size, size) as
    ``tf.image.resize_with_crop_or_pad`` does (crop offset ``(n - size)
    // 2``, zero padding of ``(size - n) // 2`` before the image), then map
    every byte ``v`` to ``lut[v]`` (256 float32; padding takes ``lut[0]``).
    Returns (size, size, 3) float32."""
    lut = np.ascontiguousarray(lut, np.float32)
    if lut.shape != (256,):
        raise ValueError(f"lut must have 256 entries, got {lut.shape}")
    out = np.empty((size, size, 3), np.float32)
    err = ctypes.create_string_buffer(_ERR)
    lib = native.load()
    _check(lib.jpeg_decode_fit(data, len(data), size, lut, out.reshape(-1),
                               err, _ERR), err)
    return out


def encode(pixels: np.ndarray, quality: int = 75,
           subsampling: str = "4:2:0", restart_interval: int = 0) -> bytes:
    """A baseline JPEG of ``pixels`` ((H, W, 3) or (H, W) / (H, W, 1)
    uint8): JFIF YCbCr at ``subsampling`` (a key of ``SUBSAMPLING``) for color,
    one component for grayscale, with a restart marker every
    ``restart_interval`` MCUs (0: none)."""
    px = np.ascontiguousarray(pixels, np.uint8)
    if px.ndim == 2:
        px = px[:, :, None]
    if px.ndim != 3 or px.shape[2] not in (1, 3):
        raise ValueError(f"pixels must be (H, W), (H, W, 1) or (H, W, 3), "
                         f"got {pixels.shape}")
    if subsampling not in SUBSAMPLING:
        raise ValueError(f"subsampling must be one of {sorted(SUBSAMPLING)}")
    lib = native.load()
    h, w, c = px.shape
    cap = 4096 + h * w * c * 2
    err = ctypes.create_string_buffer(_ERR)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(px.reshape(-1), h, w, c, int(quality),
                            SUBSAMPLING[subsampling], int(restart_interval),
                            out, cap, err, _ERR)
        if n == -1:
            raise ValueError(err.value.decode("utf-8", "replace"))
        if n >= 0:
            return out[:n].tobytes()
        cap = -n - 1
