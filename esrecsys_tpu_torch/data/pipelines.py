"""Input pipelines (counterpart of ``esrecsys_tpu/data/pipelines.py``):
GloVe's co-occurrence triples and batches from ``CooccurrenceRow``
shards; the playlist's fixed-shape numpy batches from TFRecord files or
from packed ``.npz`` shards, and the track corpus; txt2url's sentence
windows of ``SparseDocument`` shards, its url2url dice triples and their
joint batches.

Batches are plain numpy; the caller moves them to the card. Differences
from the reference: ``playlist_batches`` reads its files with
``data/tfrecord.py`` in place of ``tf.data``, so its shuffle
(``shuffle_buffer > 0``) is a streaming buffer shuffle drawn from
``np.random.default_rng(seed)`` and does not reproduce ``tf.data``'s
order (with the shuffle off the batches are the same); and files are not
sliced per process.
"""

from __future__ import annotations

import glob as glob_lib
import json
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

from esrecsys_tpu_torch.data import recordio, tfrecord
from esrecsys_tpu_torch.data.protos import CooccurrenceRow, SparseDocument
from esrecsys_tpu_torch.data.recordio import shuffled
from esrecsys_tpu_torch.data.vocab import JsonVocab

PLAYLIST_CONTEXT_KEYS = ("track_context", "album_context", "artist_context")
PLAYLIST_NEXT_KEYS = ("next_track", "next_album", "next_artist")
PLAYLIST_PACKED_KEYS = PLAYLIST_CONTEXT_KEYS + PLAYLIST_NEXT_KEYS + ("next_mask",)


def _files(pattern: str) -> List[str]:
    files = sorted(glob_lib.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no files match {pattern}")
    return files


# ------------------------------------------------------------------ glove

def cooccurrence_triples(pattern: str, repeat: bool = True,
                         shuffle_files: bool = True, seed: int = 0
                         ) -> Iterator[Tuple[int, int, float]]:
    """The (token1, token2, count) triples of ``CooccurrenceRow`` shards,
    row by row, in ``recordio.proto_stream``'s file order."""
    for row in recordio.proto_stream(pattern, CooccurrenceRow,
                                     shuffle_files=shuffle_files,
                                     repeat=repeat, seed=seed):
        for other, count in zip(row.other_index, row.count):
            yield (row.index, other, count)


def glove_batches(pattern: str, batch_size: int, shuffle_buffer: int = 0,
                  repeat: bool = True, seed: int = 0
                  ) -> Iterator[Tuple[Tuple[np.ndarray, np.ndarray],
                                      np.ndarray]]:
    """((token1, token2), count) batches of int32, int32 and float32
    arrays; a trailing partial batch is dropped. ``shuffle_buffer`` > 0
    passes the triples through :func:`recordio.shuffled` seeded with
    ``seed + 1``, as the reference does, so a seed gives its batches."""
    it = cooccurrence_triples(pattern, repeat=repeat, seed=seed)
    if shuffle_buffer:
        it = shuffled(it, shuffle_buffer, seed=seed + 1)
    t1 = np.empty(batch_size, np.int32)
    t2 = np.empty(batch_size, np.int32)
    ct = np.empty(batch_size, np.float32)
    i = 0
    for a, b, c in it:
        t1[i], t2[i], ct[i] = a, b, c
        i += 1
        if i == batch_size:
            yield (t1.copy(), t2.copy()), ct.copy()
            i = 0


# ------------------------------------------------------------- playlists

def decode_playlist(record: bytes, context_size: int, max_next: int
                    ) -> Dict[str, np.ndarray]:
    """One playlist record -> its fixed-shape example: the context
    features of exactly ``context_size`` ids, the next features cropped
    or zero-padded to ``max_next`` with a float ``next_mask``."""
    ex = tfrecord.decode_example(record)
    out: Dict[str, np.ndarray] = {}
    for k in PLAYLIST_CONTEXT_KEYS:
        vals = ex.get(k)
        if vals is None or len(vals) != context_size:
            raise ValueError(
                f"{k}: expected {context_size} values, got "
                f"{None if vals is None else len(vals)}")
        out[k] = np.asarray(vals, np.int64).astype(np.int32)
    for k in PLAYLIST_NEXT_KEYS:
        vals = ex.get(k, [])[:max_next]
        n = len(vals)
        dense = np.zeros(max_next, np.int32)
        dense[:n] = np.asarray(vals, np.int64).astype(np.int32)
        out[k] = dense
        if k == "next_track":
            mask = np.zeros(max_next, np.float32)
            mask[:n] = 1.0
            out["next_mask"] = mask
    return out


def playlist_batches(
    pattern: str,
    context_size: int = 5,
    max_next: int = 64,
    repeat: bool = True,
    shuffle_buffer: int = 0,
    batch_size: int = 1,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Parse playlist TFRecords into fixed-shape numpy batches.

    Files are read in sorted order (records in file order); the ragged
    ``next_*`` features are cropped or padded to ``max_next`` with a
    ``next_mask``; ``repeat`` loops over the files forever; with
    ``shuffle_buffer`` the examples pass through :func:`shuffled`; with
    ``batch_size > 1`` they are stacked into batches (a trailing partial
    batch is kept only without ``drop_remainder``), at 1 they come one by
    one without a batch axis, as the reference's pipeline gives them.
    """
    files = _files(pattern)

    def examples():
        while True:
            for path in files:
                for rec in tfrecord.read_records(path):
                    yield decode_playlist(rec, context_size, max_next)
            if not repeat:
                return

    it = examples()
    if shuffle_buffer:
        it = shuffled(it, shuffle_buffer, seed=seed)
    if batch_size <= 1:
        yield from it
        return
    buf: List[Dict[str, np.ndarray]] = []
    for ex in it:
        buf.append(ex)
        if len(buf) == batch_size:
            yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
            buf = []
    if buf and not drop_remainder:
        yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}


def pack_playlists(
    tfrecord_pattern: str,
    out_dir: str,
    context_size: int = 5,
    max_next: int = 64,
    examples_per_shard: int = 262_144,
) -> List[str]:
    """ETL-time batch packing: TFRecords -> fixed-shape npz shards
    ``packed-NNNNN.npz``, each holding dense int32 arrays (N, C) / (N, M)
    and the float32 mask, so the train-time iterator is a shard load, a
    permutation and slices. Each shard is held in host memory while it is
    visited, so size ``examples_per_shard`` to the host (the default is
    about 270 MB a shard at M=64)."""
    os.makedirs(out_dir, exist_ok=True)
    it = playlist_batches(
        tfrecord_pattern, context_size=context_size, max_next=max_next,
        repeat=False, batch_size=1024, drop_remainder=False)
    buf: Dict[str, List[np.ndarray]] = {k: [] for k in PLAYLIST_PACKED_KEYS}
    count, shard, paths = 0, 0, []

    def flush():
        nonlocal count, shard
        if not count:
            return
        path = f"{out_dir}/packed-{shard:05d}.npz"
        np.savez(path, **{k: np.concatenate(v, axis=0)
                          for k, v in buf.items()})
        paths.append(path)
        for v in buf.values():
            v.clear()
        count, shard = 0, shard + 1

    for batch in it:
        for k in PLAYLIST_PACKED_KEYS:
            buf[k].append(batch[k])
        count += batch["next_mask"].shape[0]
        if count >= examples_per_shard:
            flush()
    flush()
    return paths


def packed_playlist_batches(
    pattern: str,
    batch_size: int,
    repeat: bool = True,
    shuffle: bool = True,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Train-time iterator over :func:`pack_playlists` shards.

    Per epoch: shards in random order, a fresh permutation within each
    shard, fixed-shape ``batch_size`` slices (trailing partial batches are
    dropped). The draws come from ``np.random.default_rng(seed)`` in the
    reference's order, so both packages give the same batches.
    """
    files = _files(pattern)
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(files)) if shuffle else np.arange(len(files))
        for fi in order:
            with np.load(files[fi]) as z:
                arrays = {k: z[k] for k in PLAYLIST_PACKED_KEYS}
            n = arrays["next_mask"].shape[0]
            perm = rng.permutation(n) if shuffle else np.arange(n)
            for start in range(0, n - batch_size + 1, batch_size):
                sel = perm[start:start + batch_size]
                yield {k: v[sel] for k, v in arrays.items()}
        if not repeat:
            return


def load_track_corpus(
    all_tracks_json: str,
    track_vocab_path: str,
    album_vocab_path: str,
    artist_vocab_path: str,
) -> Dict[str, np.ndarray]:
    """The full track corpus as sorted parallel int32 arrays (track id,
    album id, artist id) plus the three vocabulary sizes.
    ``all_tracks.json`` maps a track index to its raw metadata; the uri
    dictionaries map uris to ids."""
    track_vocab = JsonVocab.load(track_vocab_path)
    album_vocab = JsonVocab.load(album_vocab_path)
    artist_vocab = JsonVocab.load(artist_vocab_path)
    with open(all_tracks_json) as f:
        all_tracks = json.load(f)
    items = sorted(
        (int(idx), album_vocab[meta["album_uri"]],
         artist_vocab[meta["artist_uri"]])
        for idx, meta in all_tracks.items())
    arr = np.asarray(items, dtype=np.int32)
    return {
        "tracks": arr[:, 0].copy(),
        "albums": arr[:, 1].copy(),
        "artists": arr[:, 2].copy(),
        "num_tracks": len(track_vocab),
        "num_albums": len(album_vocab),
        "num_artists": len(artist_vocab),
    }


# -------------------------------------------------------------- txt2url

def sparse_doc_sentences(pattern: str, sentence_length: int,
                         max_sentences_per_doc: int = 4, repeat: bool = True,
                         seed: int = 0) -> Iterator[Tuple[int, np.ndarray]]:
    """(primary url index, int32 token window of ``sentence_length``)
    pairs of ``SparseDocument`` shards, files in
    ``recordio.proto_stream``'s shuffled order for ``seed``: a document of
    at most ``sentence_length`` tokens zero-padded at the end, a longer
    one as ``max_sentences_per_doc`` windows at random starts in ``[0, n
    - sentence_length)``; documents without tokens skipped. The draws
    come from ``np.random.default_rng(seed)`` in the reference's order."""
    rng = np.random.default_rng(seed)
    for sdoc in recordio.proto_stream(pattern, SparseDocument,
                                      shuffle_files=True, repeat=repeat,
                                      seed=seed):
        tokens = np.asarray(sdoc.token_index, dtype=np.int32)
        n = tokens.shape[0]
        if n == 0:
            continue
        if n <= sentence_length:
            out = np.zeros(sentence_length, np.int32)
            out[:n] = tokens
            yield int(sdoc.primary_index), out
        else:
            for _ in range(max_sentences_per_doc):
                start = int(rng.integers(0, n - sentence_length))
                yield (int(sdoc.primary_index),
                       tokens[start:start + sentence_length])


def url_dice_triples(pattern: str, doc_frequency: np.ndarray,
                     repeat: bool = True, seed: int = 0
                     ) -> Iterator[Tuple[int, int, float]]:
    """(url1, url2, dice) of url2url ``CooccurrenceRow`` shards, dice =
    ``2 joint / (df_1 + df_2)`` with ``doc_frequency[i]`` the title
    dictionary's document frequency of index i."""
    for row in recordio.proto_stream(pattern, CooccurrenceRow,
                                     shuffle_files=True, repeat=repeat,
                                     seed=seed):
        df_main = float(doc_frequency[row.index])
        for other, joint in zip(row.other_index, row.count):
            dice = 2.0 * float(joint) / (float(doc_frequency[other])
                                         + df_main)
            yield int(row.index), int(other), dice


def txt2url_batches(txt2url_pattern: str, url2url_pattern: str,
                    doc_frequency: np.ndarray, batch_size: int,
                    sentence_length: int = 32,
                    max_sentences_per_doc: int = 4, shuffle_buffer: int = 0,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless joint batches of the two objectives: ``url_near_text``
    (B,) int32 and ``tokens`` (B, L) int32 from
    :func:`sparse_doc_sentences`, ``url1``, ``url2`` (B,) int32 and
    ``sqrt_dice`` (B,) float32 from :func:`url_dice_triples`. With
    ``shuffle_buffer`` both streams pass through :func:`shuffled`, seeded
    ``seed + 1`` and ``seed + 2``."""
    text_it = sparse_doc_sentences(txt2url_pattern, sentence_length,
                                   max_sentences_per_doc, repeat=True,
                                   seed=seed)
    dice_it = url_dice_triples(url2url_pattern, doc_frequency, repeat=True,
                               seed=seed)
    if shuffle_buffer:
        text_it = shuffled(text_it, shuffle_buffer, seed=seed + 1)
        dice_it = shuffled(dice_it, shuffle_buffer, seed=seed + 2)
    while True:
        url_near = np.empty(batch_size, np.int32)
        tokens = np.empty((batch_size, sentence_length), np.int32)
        url1 = np.empty(batch_size, np.int32)
        url2 = np.empty(batch_size, np.int32)
        dice = np.empty(batch_size, np.float32)
        for i in range(batch_size):
            url_near[i], tokens[i] = next(text_it)
            url1[i], url2[i], dice[i] = next(dice_it)
        yield {"url_near_text": url_near, "tokens": tokens, "url1": url1,
               "url2": url2, "sqrt_dice": np.sqrt(dice)}
