"""The serving slice end to end at a 5,000-track corpus: a JAX-initialised
playlist model is exported by the JAX package, then the port loads the
artifact, embeds the catalog and serves it fused
(``tools.full_scale_run.serve_from_artifact``). The reference is JAX
``get_embeddings`` on the same params followed by the JAX
``RetrievalService(fused=True)``.

Tolerances: embeddings exactly equal (a lookup copies rows); top-k ids
equal and scores within 1e-5 absolute (float32 rescore sums of width 32
run in another order on each side).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esrecsys_tpu.models.playlist import PlaylistModel as JaxPlaylistModel
from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.serving.server import RetrievalService as JaxService
from esrecsys_tpu.tools.full_scale_run import mix_mod as jax_mix_mod
from esrecsys_tpu.train.export import export_model as jax_export
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.tools import full_scale_run as tfsr

TRACKS, ALBUMS_RAW, BUCKETS, ARTISTS, D = 5000, 2000, 500, 800, 16
SERVE = dict(max_k=100, max_batch=8, fused_bins=512)


def _cfg(out_dir):
    return tfsr.ServingRunConfig(
        out_dir=out_dir, num_tracks=TRACKS, num_albums_raw=ALBUMS_RAW,
        album_buckets=BUCKETS, num_artists=ARTISTS, feature_size=D,
        fused=True, device="cpu", **SERVE)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("slice"))
    jcfg = jpl.PlaylistConfig(feature_size=D, album_hash_buckets=BUCKETS,
                              num_artists=ARTISTS, num_negatives=4,
                              max_next=3, seed=5)
    jmodel, state = jpl.init_state(jcfg, mesh=None)
    jax_export(work, "playlist", state.params, step=40,
               metadata={"feature_size": D})
    cfg = _cfg(work)
    corpus = tfsr.synth_corpus(cfg)
    svc, report = tfsr.serve_from_artifact(cfg, corpus)
    jvecs = np.asarray(jmodel.apply(
        {"params": state.params}, jnp.asarray(corpus["albums"]),
        jnp.asarray(corpus["artists"]),
        method=JaxPlaylistModel.get_embeddings))
    return svc, report, jvecs, corpus


def test_corpus_matches_reference_hash():
    cfg = _cfg("unused")
    corpus = tfsr.synth_corpus(cfg)
    ids = np.arange(TRACKS, dtype=np.int32)
    np.testing.assert_array_equal(corpus["albums"],
                                  jax_mix_mod(ids, 7, ALBUMS_RAW, np))
    np.testing.assert_array_equal(corpus["artists"],
                                  jax_mix_mod(ids, 13, ARTISTS, np))


def test_catalog_embeddings_equal_jax(slice_run):
    svc, _, jvecs, _ = slice_run
    assert svc.index.vectors.shape == (TRACKS, 2 * D)
    np.testing.assert_array_equal(svc.index.vectors, jvecs)


def test_fused_answers_equal_jax_service(slice_run):
    svc, report, jvecs, _ = slice_run
    assert report["mode"] == "fused:bins=512" and report["device"] == "cpu"
    jsvc = JaxService(JaxIndex([str(i) for i in range(TRACKS)], jvecs),
                      fused=True, **SERVE)
    rng = np.random.default_rng(0)
    q = (jvecs[rng.integers(0, TRACKS, 12)]
         + rng.normal(size=(12, 2 * D)).astype(np.float32) * 0.05)
    t_ids, t_scores = svc.topk(q, k=100)
    j_ids, j_scores = jsvc.topk(q, k=100)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=1e-5)
    t_ids, _ = svc.topk_by_id("17", k=10, exclude=["17"])
    j_ids, _ = jsvc.topk_by_id("17", k=10, exclude=["17"])
    np.testing.assert_array_equal(t_ids, j_ids)


def test_cli_serves_on_cpu(tmp_path, capsys):
    tfsr.main(["--out_dir", str(tmp_path), "--fused", "--device", "cpu",
               "--corpus_size", "3000", "--num_albums_raw", "900",
               "--album_buckets", "300", "--num_artists", "500"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "fused:bins=4096" and out["device"] == "cpu"
    assert out["serving_qps"] > 0
    with open(tmp_path / "full_scale_run.json") as f:
        assert json.load(f)["mode"] == out["mode"]
    assert (tmp_path / "artifacts" / "playlist-00000000.npz").exists()
