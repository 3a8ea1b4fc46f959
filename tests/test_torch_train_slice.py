"""The training slice end to end at a 3,000-track corpus on the CPU:
``tools.full_scale_run`` trains the flagship configuration (scaled down)
on batches drawn by its device feed, evaluates recall@500 fused and exact
over the whole corpus, exports the trained model and serves the artifact.
The JAX package then loads the same artifact and embeds the catalog.

Tolerances: the hash of the feed is bit-identical to numpy's; the catalog
embedded by the JAX package from the port's artifact is EXACTLY the
served one (a lookup copies rows).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.models.playlist import PlaylistModel as JaxModel
from esrecsys_tpu.tools.full_scale_run import mix_mod as jax_mix_mod
from esrecsys_tpu.train.export import load_model as jax_load_model
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.tools import full_scale_run as tfsr
from esrecsys_tpu_torch.train.export import latest_artifact

SCALE = ["--corpus_size", "3000", "--num_albums_raw", "900",
         "--album_buckets", "300", "--num_artists", "500"]


@pytest.mark.parametrize("salt,mod", [(7, 700_000), (13, 295_861), (7, 3)])
def test_mix_mod_torch_is_bit_identical_to_numpy(salt, mod):
    rng = np.random.default_rng(salt + mod)
    ids = np.concatenate([
        rng.integers(0, 2**31 - 1, 4000), rng.integers(-2**31, 0, 1000),
        [0, 1, 2**31 - 1, -1, -2**31]]).astype(np.int32)
    got = tfsr.mix_mod_torch(torch.from_numpy(ids), salt, mod).numpy()
    np.testing.assert_array_equal(got, tfsr.mix_mod(ids, salt, mod))
    np.testing.assert_array_equal(got, jax_mix_mod(ids, salt, mod, np))
    assert got.dtype == np.int32


def test_device_feed_batches_are_track_consistent():
    run = tfsr.TrainRunConfig(out_dir="unused", num_tracks=3000,
                              num_albums_raw=900, album_buckets=300,
                              num_artists=500, batch_size=16, max_next=8,
                              device="cpu")
    cfg = tfsr.flagship_cfg(run)
    batch = next(tfsr.device_feed(run, cfg, torch.device("cpu")))
    assert batch["track_context"].shape == (16, 5)
    assert batch["next_track"].shape == (16, 8)
    for track_key, album_key, artist_key in (
            ("track_context", "album_context", "artist_context"),
            ("next_track", "next_album", "next_artist")):
        tracks = batch[track_key].numpy()
        np.testing.assert_array_equal(batch[album_key].numpy(),
                                      tfsr.mix_mod(tracks, 7, 900))
        np.testing.assert_array_equal(batch[artist_key].numpy(),
                                      tfsr.mix_mod(tracks, 13, 500))


def test_flagship_cfg_is_the_reference_quality_config():
    run = tfsr.TrainRunConfig(out_dir="unused")
    cfg = tfsr.flagship_cfg(run)
    assert (cfg.feature_size, cfg.album_hash_buckets, cfg.num_artists) == \
        (32, 100_000, 295_861)
    assert (cfg.batch_size, cfg.context_size, cfg.num_negatives) == \
        (2048, 5, 512)
    assert cfg.shared_negatives and cfg.sparse_updates
    assert (cfg.momentum, cfg.learning_rate) == (0.98, 0.004)
    assert cfg.compute_dtype == "bfloat16" and cfg.eval_k == 500
    jcfg = jpl.PlaylistConfig(**{f: getattr(cfg, f) for f in (
        "feature_size", "album_hash_buckets", "num_artists", "momentum",
        "sparse_updates")})
    assert jpl.use_dense_momentum(jcfg)


@pytest.mark.parametrize("fused_bins", ["0", "256"])
def test_train_eval_export_serve_on_cpu(tmp_path, capsys, fused_bins):
    tfsr.main(["--out_dir", str(tmp_path), "--device", "cpu", "--train",
               "--steps", "6", "--batch_size", "16", "--max_next", "8",
               "--eval_every", "3", "--eval_playlists", "16",
               "--eval_fused_bins", fused_bins, "--fused", *SCALE])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 6 and out["examples"] == 96
    assert len(out["eval_round_s"]) == 2 and out["eval_rounds"] == 2
    for k in ("track_recall", "track_mrr", "track_ndcg", "artist_recall",
              "artist_mrr"):
        assert np.isfinite(out["last_eval"][f"eval_{k}"])
    assert out["mode"] == "fused:bins=4096" and out["device"] == "cpu"
    with open(tmp_path / "full_scale_run.json") as f:
        assert json.load(f)["steps"] == 6

    # the trained artifact is the one served, and the JAX package reads it
    artifact = latest_artifact(str(tmp_path), "playlist")
    assert artifact.endswith("playlist-00000006.npz")
    params, _, meta = jax_load_model(artifact)
    assert meta["step"] == 6 and meta["valid_rows"]["artist_embed"] == 500
    run = tfsr.TrainRunConfig(out_dir=str(tmp_path), num_tracks=3000,
                              num_albums_raw=900, album_buckets=300,
                              num_artists=500, device="cpu")
    corpus = tfsr.synth_corpus(run)
    served = tfsr.embed_catalog_from_artifact(run, corpus).numpy()
    jvecs = np.asarray(JaxModel(32, 300, 500, table_rows_multiple=128).apply(
        {"params": params}, jnp.asarray(corpus["albums"]),
        jnp.asarray(corpus["artists"]), method=JaxModel.get_embeddings))
    np.testing.assert_array_equal(served, jvecs)
    assert np.isfinite(served).all()
