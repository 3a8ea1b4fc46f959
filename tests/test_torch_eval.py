"""Full-corpus eval in the port against the JAX package: ranking metrics,
the streaming top-k functions, and ``make_eval_step`` on its exact and
fused paths at a tiny corpus (the cases of ``tests/test_playlist.py:286``,
``:360`` and ``:851``).

The JAX fused eval runs ``_affinity_kernel`` through the Pallas
interpreter (its own choice off a TPU); the port runs the plain version of
its affinity kernel.

Tolerances: streaming top-k values within 1e-5 relative and 1e-6 absolute
(float32 dot products of width 16 summed in another order; scores near
zero need the absolute bound), ids equal (equal scores are ordered by
ascending id on both sides).
Eval metrics within 1e-5 relative: both sides rank the same float32
affinity scores, so the retrieved sets agree and only the float32 sums of
the metrics differ in order.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.ops.metrics import ranking_metrics as jax_metrics
from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu.workloads import playlist as jpl
from esrecsys_tpu_torch.convert import state_from_jax
from esrecsys_tpu_torch.ops.metrics import ranking_metrics
from esrecsys_tpu_torch.retrieval import mips as tmips
from esrecsys_tpu_torch.workloads import playlist as tpl

METRICS = ("track_recall", "track_mrr", "track_ndcg", "artist_recall",
           "artist_mrr")


def test_ranking_metrics_closed_form():
    hit = torch.tensor([[0, 1, 0, 1, 0], [1, 1, 1, 0, 0], [0, 0, 0, 0, 0]],
                       dtype=torch.float32)
    out = ranking_metrics(hit, torch.tensor([2.0, 3.0, 4.0]), k=5, prefix="t")
    np.testing.assert_allclose(float(out["t_recall"]), 2.0 / 3.0, rtol=1e-6)
    np.testing.assert_allclose(float(out["t_mrr"]), 1.5 / 3, rtol=1e-6)
    d = [1.0 / math.log2(i + 2) for i in range(5)]
    want = ((d[1] + d[3]) / (d[0] + d[1]) + 1.0 + 0.0) / 3
    np.testing.assert_allclose(float(out["t_ndcg"]), want, rtol=1e-6)
    out2 = ranking_metrics(torch.ones(1, 3), torch.tensor([10.0]), k=3,
                           prefix="t")
    np.testing.assert_allclose(float(out2["t_ndcg"]), 1.0, rtol=1e-6)


@pytest.mark.parametrize("ndcg", [True, False])
def test_ranking_metrics_match_jax(ndcg):
    rng = np.random.default_rng(0)
    hit = rng.random((16, 20)) < 0.2
    denom = rng.integers(1, 30, 16).astype(np.float32)
    want = jax_metrics(jnp.asarray(hit), jnp.asarray(denom), 20, "x",
                       ndcg=ndcg)
    got = ranking_metrics(torch.from_numpy(hit), torch.from_numpy(denom), 20,
                          "x", ndcg=ndcg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


def _score_fns(q, items, block):
    """Block and item scorers over a catalog padded to whole blocks, for
    both packages."""
    m = items.shape[0]
    pad = (-m) % block
    items_p = np.pad(items, ((0, pad), (0, 0)))
    jq, ji = jnp.asarray(q), jnp.asarray(items_p)
    tq, ti = torch.from_numpy(q), torch.from_numpy(items_p)
    jblock = lambda s: jq @ jax.lax.dynamic_slice_in_dim(ji, s, block).T
    jitems = lambda c: jnp.einsum("bd,bnd->bn", jq, ji[c])
    tblock = lambda s: tq @ ti[s:s + block].T
    titems = lambda c: torch.einsum("bd,bnd->bn", tq, ti[c])
    return jblock, jitems, tblock, titems


@pytest.mark.parametrize("m,k", [(1000, 10), (777, 64), (100, 300)])
def test_streaming_topk_match_jax(m, k):
    rng = np.random.default_rng(m + k)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    items = rng.normal(size=(m, 16)).astype(np.float32)
    jblock, jitems, tblock, titems = _score_fns(q, items, 128)
    cases = [
        (jmips.chunked_topk(jblock, m, k, 128),
         tmips.chunked_topk(tblock, m, k)),
        (jmips.chunked_grouped_topk(jblock, jitems, m, k, 128, group=8),
         tmips.chunked_grouped_topk(tblock, titems, m, k, group=8)),
    ]
    for (jv, jid), (tv, tid) in cases:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        assert tv.shape == (4, k)


def _eval_setup(n=600, b=8, **kw):
    rng = np.random.default_rng(7)
    corpus = {"tracks": np.arange(n, dtype=np.int32),
              "albums": rng.integers(0, 150, n).astype(np.int32),
              "artists": rng.integers(0, 40, n).astype(np.int32)}
    fields = dict(feature_size=8, album_hash_buckets=16, num_artists=40,
                  num_negatives=8, batch_size=b, max_next=8, eval_k=20,
                  corpus_block=128, **kw)
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
    return (jmodel, jstate, jcfg, {k: jnp.asarray(v) for k, v in corpus.items()},
            {k: jnp.asarray(v) for k, v in batch.items()},
            tstate, tcfg, {k: torch.from_numpy(v) for k, v in corpus.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _both_metrics(setup):
    jmodel, jstate, jcfg, jcorpus, jbatch, tstate, tcfg, tcorpus, tbatch = setup
    jm = jax.jit(jpl.make_eval_step(jmodel, jcfg, jcorpus))(jstate, jbatch)
    tm = tpl.make_eval_step(tstate.params, tcfg, tcorpus)(tstate, tbatch)
    return jm, tm


@pytest.mark.parametrize("kw", [
    {}, {"eval_group": 0}, {"eval_fused_bins": 128}])
def test_eval_step_matches_jax(kw):
    jm, tm = _both_metrics(_eval_setup(**kw))
    for metric in METRICS:
        np.testing.assert_allclose(float(tm[metric]), float(jm[metric]),
                                   rtol=1e-5, err_msg=metric)
    assert float(tm["track_recall"]) > 0  # hits exist; not vacuous


def test_exact_eval_query_chunking_matches_jax():
    """A tile budget of one byte forces 8-query chunks of a 12-playlist
    batch on both sides."""
    setup = _eval_setup(b=12, eval_score_tile_bytes=1)
    assert tpl._eval_query_chunk(setup[6], 128) == 8 < 12
    jm, tm = _both_metrics(setup)
    for metric in METRICS:
        np.testing.assert_allclose(float(tm[metric]), float(jm[metric]),
                                   rtol=1e-5, err_msg=metric)


def test_fused_eval_equals_exact_within_one_bin_block():
    """With the corpus inside one bin block every item has its own bin, so
    the fused eval retrieves what the exact eval does (``:286``); the
    round's setup aux feeds the same metrics."""
    setup = _eval_setup(n=100)
    tstate, tcfg, tcorpus, tbatch = setup[5:]
    model = tstate.params
    exact = tpl.make_eval_step(model, tcfg, tcorpus)(tstate, tbatch)
    fcfg = dataclasses.replace(tcfg, eval_fused_bins=128)
    fused_step = tpl.make_eval_step(model, fcfg, tcorpus)
    fused = fused_step(tstate, tbatch)
    aux = tpl.make_corpus_embed_setup(model, fcfg, tcorpus)(tstate)
    assert isinstance(aux, tuple) and len(aux) == 2
    again = fused_step(tstate, tbatch, aux)
    for metric in METRICS:
        np.testing.assert_allclose(float(fused[metric]),
                                   float(exact[metric]), rtol=1e-5)
        assert float(again[metric]) == float(fused[metric])


def test_fused_bins_and_query_chunk_match_reference():
    for bins, k in ((0, 500), (4096, 500), (100, 500), (4096, 10)):
        kw = dict(eval_fused_bins=bins, eval_k=k)
        assert tpl._eval_fused_bins(tpl.PlaylistConfig(**kw)) == \
            jpl._eval_fused_bins(jpl.PlaylistConfig(**kw))
    for block in (128, 131_072):
        assert tpl._eval_query_chunk(tpl.PlaylistConfig(), block) == \
            jpl._eval_query_chunk(jpl.PlaylistConfig(), block)
