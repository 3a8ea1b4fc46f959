"""Playlist track embeddings in the port against the JAX ``PlaylistModel``.

Params are initialised by JAX and carried over with ``convert.py``; the
same numpy ids go through ``PlaylistModel.get_embeddings`` on both sides.
A lookup copies table rows, so the outputs must be EXACTLY equal,
including the NaN rows and wrapped negative ids of the guard's ``off``
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.models.playlist import PlaylistModel as JaxPlaylistModel
from esrecsys_tpu.ops import guards as jguards
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import params_from_jax, params_to_jax
from esrecsys_tpu_torch.models.playlist import (PlaylistModel,
                                                table_rows_multiple)
from esrecsys_tpu_torch.ops import guards as tguards

BUCKETS, ARTISTS, D = 1000, 3001, 16


@pytest.fixture(scope="module")
def models():
    cfg = jpl.PlaylistConfig(feature_size=D, album_hash_buckets=BUCKETS,
                             num_artists=ARTISTS, num_negatives=4,
                             max_next=3, seed=3)
    jmodel, state = jpl.init_state(cfg, mesh=None)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    tmodel = PlaylistModel(D, BUCKETS, ARTISTS,
                           table_rows_multiple=table_rows_multiple(D),
                           device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    return jmodel, params, tmodel


@pytest.fixture
def guard_mode():
    modes = (jguards.mode(), tguards.mode())
    yield lambda m: (jguards.set_mode(m), tguards.set_mode(m))
    jguards.set_mode(modes[0])
    tguards.set_mode(modes[1])


def _both(models, album, artist):
    jmodel, params, tmodel = models
    jout = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(album), jnp.asarray(artist),
        method=JaxPlaylistModel.get_embeddings))
    with torch.no_grad():
        tout = tmodel.get_embeddings(torch.from_numpy(album),
                                     torch.from_numpy(artist)).numpy()
    return jout, tout


def test_table_padding_matches_reference(models):
    _, params, tmodel = models
    assert params["album_embed"]["embedding"].shape == (1024, D)
    assert params["artist_embed"]["embedding"].shape == (3072, D)
    assert tuple(tmodel.album_embed.embedding.shape) == (1024, D)
    assert tuple(tmodel.artist_embed.embedding.shape) == (3072, D)


@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 128, 256])
def test_rows_multiple_matches_reference(d):
    cfg = jpl.PlaylistConfig(feature_size=d)
    assert table_rows_multiple(d) == jpl._table_rows_multiple(cfg)


def test_flagship_tables_pad_to_128_rows():
    m = PlaylistModel(32, 100_000, 295_861, table_rows_multiple(32),
                      device="meta")
    assert tuple(m.album_embed.embedding.shape) == (100_096, 32)
    assert tuple(m.artist_embed.embedding.shape) == (295_936, 32)


def test_init_statistics():
    gen = torch.Generator().manual_seed(0)
    m = PlaylistModel(32, 4000, 5000, device="cpu", generator=gen)
    w = m.artist_embed.embedding.detach()
    assert abs(float(w.std()) - 32 ** -0.5) < 0.01
    gen2 = torch.Generator().manual_seed(0)
    m2 = PlaylistModel(32, 4000, 5000, device="cpu", generator=gen2)
    assert torch.equal(m2.artist_embed.embedding, w)


def test_get_embeddings_exact_in_range(models, guard_mode):
    guard_mode("off")
    rng = np.random.default_rng(0)
    album = rng.integers(-50_000, 700_000, (7, 5)).astype(np.int32)
    artist = rng.integers(0, ARTISTS, (7, 5)).astype(np.int32)
    jout, tout = _both(models, album, artist)
    assert tout.shape == (7, 5, 2 * D)
    np.testing.assert_array_equal(tout, jout)


def test_album_mod_hash_is_floor_mod(models, guard_mode):
    guard_mode("off")
    album = np.array([-1, -1000, -1001, 999, 1000, 123_457], np.int32)
    artist = np.zeros(6, np.int32)
    jout, tout = _both(models, album, artist)
    np.testing.assert_array_equal(tout, jout)
    _, _, tmodel = models
    rows = tmodel.album_embed.embedding.detach().numpy()
    np.testing.assert_array_equal(tout[0, :D], rows[999])   # -1 -> 999
    np.testing.assert_array_equal(tout[2, :D], rows[999])   # -1001 -> 999


def test_off_mode_nan_rows_and_negative_wrap(models, guard_mode):
    guard_mode("off")
    # 3001..3071 are padded rows (real values); >= 3072 and < -3072 give
    # NaN rows; -1 .. -3072 wrap to 3071 .. 0
    artist = np.array([3000, 3001, 3071, 3072, 10_000, -1, -3072, -3073],
                      np.int32)
    album = np.arange(8, dtype=np.int32)
    jout, tout = _both(models, album, artist)
    np.testing.assert_array_equal(tout, jout)
    nan_rows = np.isnan(tout[:, D:]).all(axis=-1)
    assert nan_rows.tolist() == [False, False, False, True, True, False,
                                 False, True]
    assert not np.isnan(tout[:, :D]).any()


def test_clamp_mode_matches_reference(models, guard_mode):
    guard_mode("clamp")
    artist = np.array([-5, 0, 3000, 3001, 3071, 99_999], np.int32)
    album = np.array([-3, 5, 7, 1_000_003, 2, 1], np.int32)
    jout, tout = _both(models, album, artist)
    np.testing.assert_array_equal(tout, jout)
    assert not np.isnan(tout).any()


def test_error_mode_raises_like_reference(models, guard_mode):
    guard_mode("error")
    ok_album = np.array([1, 2], np.int32)
    ok_artist = np.array([0, ARTISTS - 1], np.int32)
    jout, tout = _both(models, ok_album, ok_artist)
    np.testing.assert_array_equal(tout, jout)
    bad = np.array([0, ARTISTS], np.int32)
    jmodel, params, tmodel = models
    with pytest.raises(ValueError, match="id out of range for artist_embed"):
        tmodel.get_embeddings(torch.from_numpy(ok_album),
                              torch.from_numpy(bad))
    with pytest.raises(ValueError, match="id out of range for artist_embed"):
        jmodel.apply({"params": params}, jnp.asarray(ok_album),
                     jnp.asarray(bad), method=JaxPlaylistModel.get_embeddings)


def test_convert_round_trip(models):
    _, params, tmodel = models
    sd = params_from_jax(params)
    assert set(sd) == {"album_embed.embedding", "artist_embed.embedding"}
    back = params_to_jax(tmodel.state_dict())
    for mod in ("album_embed", "artist_embed"):
        np.testing.assert_array_equal(back[mod]["embedding"],
                                      params[mod]["embedding"])


def test_fused_eval_and_serving_at_feature_size_24_match_jax():
    """feature_size 24: a 48-wide catalog (album || artist), a width the
    tuned fused kernels lack (the generic ones run it on the card). The
    fused eval (``eval_fused_bins``) and fused serving of the corpus
    embeddings, on weights carried over by ``convert.py``, against the JAX
    package: eval metrics within 1e-5 relative (``test_torch_eval.py``'s
    tolerance), served ids equal and scores within 1e-5 absolute
    (``test_torch_serving.py``'s)."""
    from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
    from esrecsys_tpu.serving import server as jserver
    from esrecsys_tpu_torch.convert import state_from_jax
    from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
    from esrecsys_tpu_torch.serving import server as tserver
    from esrecsys_tpu_torch.workloads import playlist as tpl

    n, b = 600, 8
    rng = np.random.default_rng(11)
    corpus = {"tracks": np.arange(n, dtype=np.int32),
              "albums": rng.integers(0, 150, n).astype(np.int32),
              "artists": rng.integers(0, 40, n).astype(np.int32)}
    fields = dict(feature_size=24, album_hash_buckets=16, num_artists=40,
                  num_negatives=8, batch_size=b, max_next=8, eval_k=20,
                  corpus_block=128, eval_fused_bins=128)
    jcfg, tcfg = jpl.PlaylistConfig(**fields), tpl.PlaylistConfig(**fields)
    jmodel, jstate = jpl.init_state(jcfg, None)
    tstate = state_from_jax(jstate, tcfg, device="cpu")
    ri = lambda hi, *s: rng.integers(0, hi, s).astype(np.int32)
    mask = rng.integers(0, 2, (b, 8)).astype(np.float32)
    mask[:, 0] = 1.0
    batch = {"track_context": ri(n, b, 5), "album_context": ri(150, b, 5),
             "artist_context": ri(40, b, 5), "next_track": ri(n, b, 8),
             "next_album": ri(150, b, 8), "next_artist": ri(40, b, 8),
             "next_mask": mask}
    jm = jax.jit(jpl.make_eval_step(
        jmodel, jcfg, {k: jnp.asarray(v) for k, v in corpus.items()}))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tpl.make_eval_step(
        tstate.params, tcfg,
        {k: torch.from_numpy(v) for k, v in corpus.items()})(
            tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for metric in ("track_recall", "track_mrr", "track_ndcg",
                   "artist_recall", "artist_mrr"):
        np.testing.assert_allclose(float(tm[metric]), float(jm[metric]),
                                   rtol=1e-5, err_msg=metric)
    assert float(tm["track_recall"]) > 0  # hits exist; not vacuous

    # the corpus embedded by each side, served fused
    jvecs = np.asarray(jmodel.apply(
        {"params": jstate.params}, jnp.asarray(corpus["albums"]),
        jnp.asarray(corpus["artists"]),
        method=JaxPlaylistModel.get_embeddings))
    with torch.no_grad():
        tvecs = tstate.params.get_embeddings(
            torch.from_numpy(corpus["albums"]),
            torch.from_numpy(corpus["artists"])).numpy()
    assert tvecs.shape == (n, 48)
    np.testing.assert_array_equal(tvecs, jvecs)
    ids = [f"track{i}" for i in range(n)]
    kw = dict(fused=True, fused_bins=128, max_k=50, max_batch=4)
    jsvc = jserver.RetrievalService(JaxIndex(ids, jvecs), **kw)
    tsvc = tserver.RetrievalService(EmbeddingIndex(ids, tvecs),
                                    device="cpu", **kw)
    queries = rng.normal(size=(5, 48)).astype(np.float32)
    (ti, tv), (ji, jv) = tsvc.topk(queries, k=30), jsvc.topk(queries, k=30)
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(tv, np.float32),
                               np.asarray(jv, np.float32), rtol=0,
                               atol=1e-5)
