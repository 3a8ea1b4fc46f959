"""Million-Playlist-Dataset ETL: JSON slices -> uri dictionaries ->
TFRecords (counterpart of ``esrecsys_tpu/etl/playlists.py``).

First-seen-order uri -> int dictionaries for tracks, artists and albums;
each playlist of at least ``min_tracks`` tracks becomes one
``tf.train.Example`` (its first ``context_size`` tracks as the fixed
context, the rest as the variable-length next tracks) in one TFRecord
file per input slice, plus the ``all_tracks.json`` corpus dump. The
records are written by ``data/tfrecord.py``, so no TensorFlow is needed,
and TensorFlow reads them. ``--pack true`` also writes packed ``.npz``
shards (``data/pipelines.pack_playlists``) under ``<output>/packed``.

  python -m esrecsys_tpu_torch.etl.playlists \\
      --playlists 'data/mpd.slice.*.json' --output data/training
"""

from __future__ import annotations

import dataclasses
import glob as glob_lib
import json
import logging
import os
from typing import Dict, Iterator, Tuple

from esrecsys_tpu_torch.core import config as config_lib
from esrecsys_tpu_torch.data import tfrecord
from esrecsys_tpu_torch.data.pipelines import pack_playlists
from esrecsys_tpu_torch.data.vocab import JsonVocab

log = logging.getLogger(__name__)

TRACK_DICT = "track_uri_dict.json"
ARTIST_DICT = "artist_uri_dict.json"
ALBUM_DICT = "album_uri_dict.json"
ALL_TRACKS = "all_tracks.json"


@dataclasses.dataclass(frozen=True)
class PlaylistEtlConfig:
    playlists: str = ""           # glob of MPD json slices
    output: str = "data/training"
    dictionaries: str = ""        # defaults to the output dir
    context_size: int = 5
    min_tracks: int = 10
    pack: bool = False            # also emit packed fixed-shape npz shards
    pack_max_next: int = 64       # next-group padding of packed shards


def iter_playlists(pattern: str) -> Iterator[Tuple[str, list]]:
    files = sorted(glob_lib.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no playlist files match {pattern}")
    for path in files:
        with open(path) as f:
            yield path, json.load(f)["playlists"]


def build_dictionaries(pattern: str, out_dir: str
                       ) -> Tuple[JsonVocab, JsonVocab, JsonVocab]:
    """First-seen-order uri -> int dicts for tracks, artists and albums."""
    os.makedirs(out_dir, exist_ok=True)
    tracks, artists, albums = JsonVocab(), JsonVocab(), JsonVocab()
    for path, playlists in iter_playlists(pattern):
        for playlist in playlists:
            for track in playlist["tracks"]:
                tracks.add(track["track_uri"])
                artists.add(track["artist_uri"])
                albums.add(track["album_uri"])
        log.info("dictionaries after %s: %d tracks %d artists %d albums",
                 path, len(tracks), len(artists), len(albums))
    tracks.save(os.path.join(out_dir, TRACK_DICT))
    artists.save(os.path.join(out_dir, ARTIST_DICT))
    albums.save(os.path.join(out_dir, ALBUM_DICT))
    return tracks, artists, albums


def build_training(cfg: PlaylistEtlConfig) -> Dict[str, int]:
    """Write the TFRecords and ``all_tracks.json``; return counters."""
    dict_dir = cfg.dictionaries or cfg.output
    tracks = JsonVocab.load(os.path.join(dict_dir, TRACK_DICT))
    artists = JsonVocab.load(os.path.join(dict_dir, ARTIST_DICT))
    albums = JsonVocab.load(os.path.join(dict_dir, ALBUM_DICT))
    os.makedirs(cfg.output, exist_ok=True)

    raw_tracks: Dict[int, dict] = {}
    written = skipped = 0
    for pidx, (path, playlists) in enumerate(iter_playlists(cfg.playlists)):
        out = os.path.join(cfg.output, "%05d.tfrecord" % pidx)
        with tfrecord.TFRecordWriter(out) as writer:
            for playlist in playlists:
                if playlist.get("num_tracks",
                                len(playlist["tracks"])) < cfg.min_tracks:
                    skipped += 1
                    continue
                ctx: Dict[str, list] = {"track": [], "album": [], "artist": []}
                nxt: Dict[str, list] = {"track": [], "album": [], "artist": []}
                for tidx, track in enumerate(playlist["tracks"]):
                    ids = (tracks[track["track_uri"]],
                           albums[track["album_uri"]],
                           artists[track["artist_uri"]])
                    raw_tracks.setdefault(ids[0], track)
                    dest = ctx if tidx < cfg.context_size else nxt
                    dest["track"].append(ids[0])
                    dest["album"].append(ids[1])
                    dest["artist"].append(ids[2])
                if not nxt["track"]:
                    skipped += 1
                    continue
                writer.write(tfrecord.encode_example({
                    "track_context": ctx["track"],
                    "album_context": ctx["album"],
                    "artist_context": ctx["artist"],
                    "next_track": nxt["track"],
                    "next_album": nxt["album"],
                    "next_artist": nxt["artist"]}))
                written += 1
    with open(os.path.join(cfg.output, ALL_TRACKS), "w") as f:
        json.dump(raw_tracks, f)
    log.info("wrote %d playlists (%d skipped), %d unique tracks",
             written, skipped, len(raw_tracks))
    return {"written": written, "skipped": skipped,
            "unique_tracks": len(raw_tracks)}


def main(argv=None):
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = config_lib.from_cli(PlaylistEtlConfig, argv)
    build_dictionaries(cfg.playlists, cfg.dictionaries or cfg.output)
    build_training(cfg)
    if cfg.pack:
        paths = pack_playlists(
            os.path.join(cfg.output, "*.tfrecord"),
            os.path.join(cfg.output, "packed"),
            context_size=cfg.context_size,
            max_next=cfg.pack_max_next)
        log.info("packed %d npz shards", len(paths))


if __name__ == "__main__":
    main()
