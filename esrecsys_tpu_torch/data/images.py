"""Image input pipeline and Shop-the-Look dataset utilities (counterpart
of ``esrecsys_tpu/data/images.py``).

JPEG -> crop or pad to ``image_size``² -> scale to [-0.5, 0.5], and the
triplet and keyed datasets, as NHWC float32 numpy batches. The reference
decodes through ``tf.data`` in C++ threads; the port decodes with its own
C++ (``data/jpeg.py``) across a thread pool of ``os.cpu_count()``
workers (the C++ releases the interpreter lock), the counterpart of the
reference's parallel map.

With ``shuffle=True`` :func:`triplet_image_dataset` shuffles through a
streaming buffer of ``min(n, 4096)`` triplets drawn from
``np.random.default_rng(seed)`` (``data/recordio.shuffled``), so its order
is the port's own, not ``tf.data``'s; with ``shuffle=False`` the batches
are the reference's. Files are not sliced per process (one device).
"""

from __future__ import annotations

import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from esrecsys_tpu_torch.data import jpeg
from esrecsys_tpu_torch.data.recordio import shuffled

IMAGE_SIZE = 512
# v -> float32(v) / 255 - 0.5, in float32 as the reference computes it
SCALE_LUT = (np.arange(256, dtype=np.float32) / np.float32(255.0)
             - np.float32(0.5))


def key_to_url(key: str) -> str:
    """Image signature -> pinimg CDN URL."""
    prefix = f"{key[0:2]}/{key[2:4]}/{key[4:6]}"
    return f"http://i.pinimg.com/400x/{prefix}/{key}.jpg"


def key_to_filename(key: str, image_dir: str) -> str:
    return os.path.join(image_dir, key + ".jpg")


def load_scene_product_pairs(stl_json: str) -> List[Tuple[str, str]]:
    """Parse the STL scene->product json (one object per line or a json
    list)."""
    with open(stl_json) as f:
        content = f.read().strip()
    if content.startswith("["):
        rows = json.loads(content)
    else:
        rows = [json.loads(line) for line in content.splitlines()
                if line.strip()]
    return [(row["scene"], row["product"]) for row in rows]


def valid_scene_product(pairs: Sequence[Tuple[str, str]], image_dir: str
                        ) -> List[Tuple[str, str]]:
    """Keep the pairs whose images both exist, non-empty, on disk."""

    def ok(key: str) -> bool:
        p = key_to_filename(key, image_dir)
        return os.path.isfile(p) and os.path.getsize(p) > 0

    return [(s, p) for s, p in pairs if ok(s) and ok(p)]


def decode_image(path: str, image_size: int = IMAGE_SIZE) -> np.ndarray:
    """The reference's ``_decode``: the JPEG at ``path`` decoded to RGB,
    cropped or zero-padded to ``image_size``² as
    ``tf.image.resize_with_crop_or_pad`` does, then ``float32(v) / 255 -
    0.5`` (padding becomes -0.5). (image_size, image_size, 3) float32."""
    with open(path, "rb") as f:
        data = f.read()
    return jpeg.decode_fit(data, image_size, SCALE_LUT)


def decode_pool() -> ThreadPoolExecutor:
    """A pool of ``os.cpu_count()`` decode threads."""
    return ThreadPoolExecutor(max_workers=os.cpu_count() or 1,
                              thread_name_prefix="jpeg")


def decode_batch(pool: ThreadPoolExecutor, paths: Sequence[str],
                 image_size: int) -> np.ndarray:
    """(len(paths), S, S, 3) float32, decoded across ``pool``."""
    out = np.empty((len(paths), image_size, image_size, 3), np.float32)

    def one(i: int) -> None:
        out[i] = decode_image(paths[i], image_size)

    for f in [pool.submit(one, i) for i in range(len(paths))]:
        f.result()  # re-raises a decode error
    return out


def triplet_image_dataset(
    triplets: Sequence[Tuple[str, str, str]],
    image_dir: str,
    batch_size: int,
    image_size: int = IMAGE_SIZE,
    repeat: bool = True,
    shuffle: bool = True,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(scene, pos, neg) key triplets -> batches of three (B, S, S, 3)
    float32 arrays: repeated (``repeat``), shuffled through a buffer of
    ``min(n, 4096)`` (``shuffle``, seeded), batched with the remainder
    dropped; each batch's 3B images decoded across :func:`decode_pool`."""
    files = [tuple(key_to_filename(k, image_dir) for k in t)
             for t in triplets]
    if not files:
        return
    it = itertools.chain.from_iterable(itertools.repeat(files)) if repeat \
        else iter(files)
    if shuffle:
        it = shuffled(it, min(len(files), 4096), seed=seed)
    with decode_pool() as pool:
        while True:
            rows = list(itertools.islice(it, batch_size))
            if len(rows) < batch_size:
                return
            flat = decode_batch(pool, [p for row in rows for p in row],
                                image_size)
            flat = flat.reshape(batch_size, 3, image_size, image_size, 3)
            yield (np.ascontiguousarray(flat[:, 0]),
                   np.ascontiguousarray(flat[:, 1]),
                   np.ascontiguousarray(flat[:, 2]))


def keyed_image_dataset(
    keys: Sequence[str],
    image_dir: str,
    batch_size: int,
    image_size: int = IMAGE_SIZE,
) -> Iterator[Tuple[List[str], np.ndarray, int]]:
    """(keys, images (B, S, S, 3) float32, valid_count) batches for
    catalog embedding. The tail batch is padded by repeating the last key
    (the reference does the same; its source, ``make_embeddings.py``,
    dropped the tail), and ``valid_count`` says how many rows are real."""
    n = len(keys)
    padded = list(keys) + [keys[-1]] * ((-n) % batch_size)
    with decode_pool() as pool:
        for start in range(0, len(padded), batch_size):
            ks = padded[start:start + batch_size]
            imgs = decode_batch(pool, [key_to_filename(k, image_dir)
                                       for k in ks], image_size)
            yield ks, imgs, min(batch_size, max(0, n - start))
