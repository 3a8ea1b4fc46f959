"""The port's playlist data path against the JAX package's: CRC-32C and
the TFRecord framing, the ``tf.train.Example`` wire format, the ETL's
dictionaries, corpus dump and records, the TFRecord reader, packed
shards and their batches, and the track corpus.

TensorFlow runs only on the JAX side (its ETL writer and its ``tf.data``
reader). Tolerance: none; every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import tensorflow as tf

from esrecsys_tpu.data import pipelines as jpipe
from esrecsys_tpu.etl import playlists as jetl
from esrecsys_tpu_torch.data import pipelines as tpipe
from esrecsys_tpu_torch.data import tfrecord
from esrecsys_tpu_torch.etl import playlists as tetl

KEYS = tpipe.PLAYLIST_PACKED_KEYS


def write_mpd(root, n_slices=2, n_playlists=20, seed=0, ragged=True):
    """Synthetic MPD slices: 30 tracks on 15 albums and 10 artists,
    playlists clustered by track parity, 12 tracks long, or with
    ``ragged`` the second half 8 to 15 long (those under the ETL's
    10-track minimum are skipped). ``ragged=False`` writes the JAX
    package's ``tiny_mpd`` (``tests/test_playlist.py``). Returns the
    slices' glob."""
    rng = np.random.default_rng(seed)

    def track(i):
        return {"track_uri": f"spotify:track:{i}",
                "album_uri": f"spotify:album:{i % 15}",
                "artist_uri": f"spotify:artist:{i % 10}",
                "track_name": f"t{i}"}

    os.makedirs(root, exist_ok=True)
    for s in range(n_slices):
        playlists = []
        for p in range(n_playlists):
            ids = [i for i in range(30) if i % 2 == p % 2]
            order = rng.permutation(len(ids))
            length = (12 if not ragged or p < n_playlists // 2
                      else int(rng.integers(8, 16)))
            tracks = [track(ids[j]) for j in order[:length]]
            playlists.append({"num_tracks": len(tracks), "tracks": tracks})
        with open(os.path.join(root, f"mpd.slice.{s}.json"), "w") as f:
            json.dump({"playlists": playlists}, f)
    return os.path.join(root, "mpd.slice.*.json")


def run_etl(etl, pattern, out):
    cfg = etl.PlaylistEtlConfig(playlists=pattern, output=out)
    etl.build_dictionaries(cfg.playlists, out)
    return etl.build_training(cfg)


@pytest.fixture(scope="module")
def etl_outputs(tmp_path_factory):
    """The same MPD slices through both packages' ETL."""
    tmp = tmp_path_factory.mktemp("mpd")
    pattern = write_mpd(str(tmp / "raw"))
    jout, tout = str(tmp / "jax"), str(tmp / "torch")
    jstats = run_etl(jetl, pattern, jout)
    tstats = run_etl(tetl, pattern, tout)
    return jout, tout, jstats, tstats


@pytest.mark.parametrize("data,want", [
    (b"123456789", 0xE3069283),          # RFC 3720 check value
    (bytes(32), 0x8A9136AA),             # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (b"", 0)])
def test_crc32c_matches_the_rfc3720_vectors(data, want):
    assert tfrecord.crc32c(data) == want


@pytest.mark.parametrize("payloads", [[b""], [b"x"], [b"abc", b"", bytes(
    np.random.default_rng(1).integers(0, 256, 3000, dtype=np.uint8))]])
def test_framing_is_byte_identical_to_tensorflow(tmp_path, payloads):
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    with tfrecord.TFRecordWriter(ours) as w:
        for p in payloads:
            w.write(p)
    with tf.io.TFRecordWriter(theirs) as w:
        for p in payloads:
            w.write(p)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert list(tfrecord.read_records(theirs)) == payloads
    got = [r.numpy() for r in tf.data.TFRecordDataset(ours)]
    assert got == payloads


def test_corrupted_records_raise(tmp_path):
    path = str(tmp_path / "r")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(b"hello world")
    raw = bytearray(open(path, "rb").read())
    for pos, match in ((0, "length"), (14, "data")):
        bad = bytearray(raw)
        bad[pos] ^= 1
        open(path, "wb").write(bytes(bad))
        with pytest.raises(ValueError, match=match):
            list(tfrecord.read_records(path))
    open(path, "wb").write(bytes(raw[:-2]))
    with pytest.raises(ValueError, match="truncated"):
        list(tfrecord.read_records(path))


FEATURES = {"a": [0, 1, -1, 2**40, -2**63, 2**63 - 1, 127, 128],
            "empty": [], "z": [5]}


def test_example_encoding_round_trips_with_tensorflow():
    parsed = tf.train.Example.FromString(tfrecord.encode_example(FEATURES))
    got = {k: list(v.int64_list.value)
           for k, v in parsed.features.feature.items()}
    assert got == FEATURES
    ex = tf.train.Example(features=tf.train.Features(feature={
        k: tf.train.Feature(int64_list=tf.train.Int64List(value=v))
        for k, v in FEATURES.items()}))
    assert tfrecord.decode_example(ex.SerializeToString()) == FEATURES


def test_decoder_takes_unpacked_values_and_skips_unknown_fields():
    def varint(n):
        return tfrecord._varint(n)

    # Int64List with field 1 unpacked (wire type 0), twice, then packed
    int64_list = (b"\x08" + varint(7) + b"\x08" + varint(-3 & (2**64 - 1))
                  + tfrecord._field(1, varint(9)))
    feature = tfrecord._field(3, int64_list) + b"\x78\x01"  # unknown 15
    entry = tfrecord._field(1, b"k") + tfrecord._field(2, feature)
    data = tfrecord._field(1, tfrecord._field(1, entry))
    assert tfrecord.decode_example(data) == {"k": [7, -3, 9]}
    parsed = tf.train.Example.FromString(data)
    assert list(parsed.features.feature["k"].int64_list.value) == [7, -3, 9]
    bytes_feature = tf.train.Example(features=tf.train.Features(feature={
        "b": tf.train.Feature(bytes_list=tf.train.BytesList(value=[b"x"]))}))
    with pytest.raises(ValueError, match="not an Int64List"):
        tfrecord.decode_example(bytes_feature.SerializeToString())


def test_etl_writes_what_the_reference_writes(etl_outputs):
    jout, tout, jstats, tstats = etl_outputs
    assert tstats == jstats and tstats["skipped"] > 0
    for name in (tetl.TRACK_DICT, tetl.ALBUM_DICT, tetl.ARTIST_DICT,
                 tetl.ALL_TRACKS):
        with open(os.path.join(jout, name)) as a, \
                open(os.path.join(tout, name)) as b:
            assert json.load(a) == json.load(b), name
    files = sorted(f for f in os.listdir(jout) if f.endswith(".tfrecord"))
    assert files == sorted(f for f in os.listdir(tout)
                           if f.endswith(".tfrecord"))
    for f in files:
        theirs = [tfrecord.decode_example(r) for r in
                  tfrecord.read_records(os.path.join(jout, f))]
        ours = [tfrecord.decode_example(r) for r in
                tfrecord.read_records(os.path.join(tout, f))]
        assert ours == theirs


def _batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("max_next,batch_size,drop", [
    (4, 4, True), (8, 3, False), (16, 1, True)])
def test_reader_matches_the_tf_data_reader(etl_outputs, writer, max_next,
                                           batch_size, drop):
    """Records written by either ETL, read by the port and by the
    reference's ``tf.data`` pipeline (shuffle off): the same batches,
    cropped and padded to ``max_next``."""
    jout, tout, _, _ = etl_outputs
    pattern = os.path.join(tout if writer == "torch" else jout, "*.tfrecord")
    kw = dict(context_size=5, max_next=max_next, repeat=False,
              batch_size=batch_size, drop_remainder=drop)
    _batches_equal(tpipe.playlist_batches(pattern, **kw),
                   jpipe.playlist_batches(pattern, **kw))


def test_shuffle_buffer_permutes_one_pass(etl_outputs):
    _, tout, _, _ = etl_outputs
    pattern = os.path.join(tout, "*.tfrecord")
    kw = dict(max_next=8, repeat=False, batch_size=1)
    plain = list(tpipe.playlist_batches(pattern, **kw))
    mixed = list(tpipe.playlist_batches(pattern, shuffle_buffer=7, seed=3,
                                        **kw))

    def rows(exs):
        return sorted(tuple(np.concatenate([e[k].ravel() for k in KEYS]))
                      for e in exs)

    assert rows(mixed) == rows(plain)
    assert [e["track_context"].tolist() for e in mixed] != \
        [e["track_context"].tolist() for e in plain]


def test_short_context_raises(tmp_path):
    path = str(tmp_path / "short.tfrecord")
    with tfrecord.TFRecordWriter(path) as w:
        w.write(tfrecord.encode_example({
            "track_context": [1, 2], "album_context": [1, 2],
            "artist_context": [1, 2], "next_track": [3]}))
    with pytest.raises(ValueError, match="track_context"):
        next(tpipe.playlist_batches(path, context_size=5))


def test_pack_playlists_and_corpus_match_the_reference(etl_outputs, tmp_path):
    jout, tout, _, _ = etl_outputs
    pattern = os.path.join(jout, "*.tfrecord")
    jpaths = jpipe.pack_playlists(pattern, str(tmp_path / "j"),
                                  max_next=8, examples_per_shard=10)
    tpaths = tpipe.pack_playlists(pattern, str(tmp_path / "t"),
                                  max_next=8, examples_per_shard=10)
    assert [os.path.basename(p) for p in tpaths] == \
        [os.path.basename(p) for p in jpaths]
    for a, b in zip(tpaths, jpaths):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in zb.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    args = [os.path.join(tout, n) for n in (
        tetl.ALL_TRACKS, tetl.TRACK_DICT, tetl.ALBUM_DICT, tetl.ARTIST_DICT)]
    ours, theirs = tpipe.load_track_corpus(*args), jpipe.load_track_corpus(*args)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


@pytest.fixture(scope="module")
def packed_shards(tmp_path_factory):
    """Three packed shards of 37, 50 and 23 random playlists."""
    root = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(5)
    for s, n in enumerate((37, 50, 23)):
        np.savez(root / f"packed-{s:05d}.npz", **{
            **{k: rng.integers(0, 1000, (n, 5)).astype(np.int32)
               for k in tpipe.PLAYLIST_CONTEXT_KEYS},
            **{k: rng.integers(0, 1000, (n, 6)).astype(np.int32)
               for k in tpipe.PLAYLIST_NEXT_KEYS},
            "next_mask": (rng.random((n, 6)) < 0.7).astype(np.float32)})
    return str(root / "packed-*.npz")


@pytest.mark.parametrize("seed,shuffle", [(0, True), (3, True), (0, False)])
def test_packed_batches_match_the_reference(packed_shards, seed, shuffle):
    """Two epochs of packed batches, bit-identical for a seed: both
    packages draw from ``np.random.default_rng(seed)`` in one order."""
    per_epoch = 37 // 8 + 50 // 8 + 23 // 8
    ours = tpipe.packed_playlist_batches(packed_shards, 8, shuffle=shuffle,
                                         seed=seed)
    theirs = jpipe.packed_playlist_batches(packed_shards, 8,
                                           shuffle=shuffle, seed=seed)
    _batches_equal([next(ours) for _ in range(2 * per_epoch)],
                   [next(theirs) for _ in range(2 * per_epoch)])
    one = list(tpipe.packed_playlist_batches(packed_shards, 8, repeat=False,
                                             shuffle=shuffle, seed=seed))
    assert len(one) == per_epoch
