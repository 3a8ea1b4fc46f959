"""Interchange formats: model artifacts and embedding indexes written by
either package load in the other, with identical keys, dtypes, values
and metadata."""

import json

import jax
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.train import export as jexport
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import params_from_jax
from esrecsys_tpu_torch.models.playlist import (PlaylistModel,
                                                table_rows_multiple)
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex as TorchIndex
from esrecsys_tpu_torch.train import export as texport

META = {"feature_size": 8, "album_hash_buckets": 100, "num_artists": 300,
        "valid_rows": {"album_embed": 100, "artist_embed": 300}}


def _jax_params():
    cfg = jpl.PlaylistConfig(feature_size=8, album_hash_buckets=100,
                             num_artists=300, num_negatives=4, max_next=3)
    _, state = jpl.init_state(cfg, mesh=None)
    return jax.tree_util.tree_map(np.asarray, state.params)


def _npz_layout(path):
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].shape) for k in z.files}


def test_jax_artifact_loads_in_port(tmp_path):
    params = _jax_params()
    path = jexport.export_model(str(tmp_path), "playlist", params, step=12,
                                metadata=META)
    assert texport.latest_artifact(str(tmp_path), "playlist") == path
    tparams, tstats, meta = texport.load_model(path)
    assert tstats == {}
    assert meta == {"name": "playlist", "step": 12, **META}
    model = PlaylistModel(8, 100, 300, table_rows_multiple(8), device="cpu")
    model.load_state_dict(params_from_jax(tparams))
    np.testing.assert_array_equal(
        model.artist_embed.embedding.detach().numpy(),
        params["artist_embed"]["embedding"])


def test_port_artifact_loads_in_jax(tmp_path):
    gen = torch.Generator().manual_seed(0)
    model = PlaylistModel(8, 100, 300, table_rows_multiple(8), device="cpu",
                          generator=gen)
    path = texport.export_model(str(tmp_path), "playlist", model, step=7,
                                metadata=META)
    assert path.endswith("playlist-00000007.npz")
    jparams, jstats, meta = jexport.load_model(path)
    assert jstats == {} and meta["step"] == 7 and meta["name"] == "playlist"
    for mod in ("album_embed", "artist_embed"):
        np.testing.assert_array_equal(
            jparams[mod]["embedding"],
            getattr(model, mod).embedding.detach().numpy())
    # the JAX model applies the port's params unchanged
    jmodel, state = jpl.init_state(jpl.PlaylistConfig(
        feature_size=8, album_hash_buckets=100, num_artists=300,
        num_negatives=4, max_next=3), mesh=None)
    assert jax.tree_util.tree_map(np.shape, jparams) == \
        jax.tree_util.tree_map(np.shape, dict(state.params))


def test_both_packages_write_the_same_layout(tmp_path):
    params = _jax_params()
    jpath = jexport.export_model(str(tmp_path / "j"), "m", params, step=1,
                                 batch_stats={"bn": {"mean": np.ones(3)}},
                                 metadata=META)
    tpath = texport.export_model(str(tmp_path / "t"), "m", params, step=1,
                                 batch_stats={"bn": {"mean": np.ones(3)}},
                                 metadata=META)
    assert _npz_layout(jpath) == _npz_layout(tpath)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert zj.files == zt.files        # same key order
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])
        assert json.loads(zj["__meta__"].tobytes()) == \
            json.loads(zt["__meta__"].tobytes())
    _, tstats, _ = texport.load_model(jpath)
    np.testing.assert_array_equal(tstats["bn"]["mean"], np.ones(3))


def test_latest_artifact_picks_newest_step(tmp_path):
    params = _jax_params()
    assert texport.latest_artifact(str(tmp_path), "playlist") is None
    for step in (3, 20, 100):
        texport.export_model(str(tmp_path), "playlist", params, step=step)
    assert texport.latest_artifact(str(tmp_path), "playlist").endswith(
        "playlist-00000100.npz")


@pytest.mark.parametrize("suffix", [".npz", ".json"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_embedding_index_round_trip(tmp_path, suffix, writer):
    rng = np.random.default_rng(0)
    ids = [f"t{i}" for i in range(40)]
    vecs = rng.normal(size=(40, 6)).astype(np.float32)
    src, dst = (JaxIndex, TorchIndex) if writer == "jax" else \
        (TorchIndex, JaxIndex)
    path = str(tmp_path / f"catalog{suffix}")
    src(ids, vecs).save(path)
    got = dst.load(path)
    assert got.ids == ids and len(got) == 40
    np.testing.assert_array_equal(got.vectors, vecs)
    np.testing.assert_array_equal(got.vector("t17"), vecs[17])


def test_embedding_index_rejects_mismatch():
    with pytest.raises(ValueError):
        TorchIndex(["a", "b"], np.zeros((3, 4), np.float32))
