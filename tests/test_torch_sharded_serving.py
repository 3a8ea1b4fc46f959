"""Catalog-sharded serving on gloo ranks against the JAX package's
``RetrievalService(n_model_shards=N)`` on a virtual CPU mesh of the same
size: the exact, int8, int8+r8 and fused (bins=128) modes on 2 and 4
ranks, over a catalog of 203 rows (which 4 does not divide, so the last
shard carries padding rows that must never return), and ``serve`` on 4
ranks over HTTP (a query, a reload that keeps ``n_model_shards``, a reload
that one rank cannot read, shutdown).

The ranks run in worker processes (``tests/torch_dist_workers.py``),
joined with a deadline; each spawn runs every mode, so that the ranks
start once.

Tolerances: ids equal to the JAX service's up to exactly equal scores
(none occur on this catalog); scores within 1e-5 relative. The returned
scores are float32 dots of width 16, summed in another order on each side
(a matmul, or the rescore's multiply-sum).
"""

import json

import numpy as np
import pytest

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.serving import server as jserver
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex

from torch_dist_workers import spawn

RTOL = 1e-5
M, D, K = 203, 16, 10
MODES = {"exact": {}, "int8": {"quantized": True},
         "int8_r8": {"quantized": True, "rescore_int8": True},
         "fused": {"fused": True, "fused_bins": 128}}
WANT_MODE = {"exact": "sharded:{n}", "int8": "sharded:{n}+int8",
             "int8_r8": "sharded:{n}+int8+r8",
             "fused": "sharded:{n}+fused:bins=128"}


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(M, D)).astype(np.float32)
    ids = [f"s{i}" for i in range(M)]
    queries = rng.normal(size=(6, D)).astype(np.float32)
    return ids, vecs, queries


def _equal_up_to_ties(got_ids, got_s, want_ids, want_s):
    """Row by row: the same ids in the same order, except among exactly
    equal scores, where the sets agree."""
    for gi, gs, wi, ws in zip(got_ids, got_s, want_ids, want_s):
        ws = np.asarray(ws, np.float32)
        start = 0
        while start < len(ws):
            stop = start + 1
            while stop < len(ws) and ws[stop] == ws[start]:
                stop += 1
            assert set(gi[start:stop]) == set(wi[start:stop]), (gi, wi)
            start = stop
        np.testing.assert_allclose(np.asarray(gs, np.float32), ws,
                                   rtol=RTOL)


@pytest.fixture(scope="module", params=[2, 4])
def ranks_run(request, catalog, tmp_path_factory):
    n = request.param
    ids, vecs, queries = catalog
    (out, *rest) = spawn(
        "job_serving", n, str(tmp_path_factory.mktemp(f"serve{n}")),
        {"ids": ids, "vecs": vecs, "queries": queries, "modes": MODES,
         "k": K}, timeout=180)
    assert rest == [{}] * (n - 1)
    return n, out


@pytest.mark.parametrize("mode", list(MODES))
def test_sharded_service_matches_the_jax_service(ranks_run, catalog, mode):
    n, out = ranks_run
    ids, vecs, queries = catalog
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), max_k=K,
                                    max_batch=4, n_model_shards=n,
                                    **MODES[mode])
    want_ids, want_s = jsvc.topk(queries, k=K)
    got = out[mode]
    assert got["mode"] == jsvc.mode == WANT_MODE[mode].format(n=n)
    assert got["bytes"] == jsvc.resident_bytes_per_item
    assert got["no_f32"] == (jsvc._items is None) == (mode == "int8_r8")
    assert got["ids"].shape == (6, K)
    assert all(i in ids for i in got["ids"].ravel())  # no padding row
    _equal_up_to_ties(got["ids"], got["scores"], want_ids, want_s)


def test_sharded_refusals_match_the_reference(catalog):
    """The reference's own refusals of the sharded mode, message for
    message: approx, ivf and pq do not compose; add_capacity grows via a
    reload; filters are single-chip; fused+quantized is not a sharded
    fused scan. One process without torchrun's ranks raises too."""
    ids, vecs, _ = catalog
    cases = [({"approx": True}, "does not\\n? ?compose"),
             ({"pq_subspaces": 4}, "does not\\n? ?compose"),
             ({"ivf_clusters": 4}, "does not\\n? ?compose"),
             ({"add_capacity": 8}, "grow via /admin/reload"),
             ({"filters": {}}, "filters are single-chip"),
             ({"fused": True, "quantized": True}, "sharded fused")]
    from esrecsys_tpu_torch.serving import server as tserver

    for kw, match in cases:
        for make in (lambda: tserver.RetrievalService(
                EmbeddingIndex(ids, vecs), device="cpu", n_model_shards=2,
                **kw),
                     lambda: jserver.RetrievalService(
                JaxIndex(ids, vecs), n_model_shards=2, **kw)):
            with pytest.raises(ValueError, match=match):
                make()
    with pytest.raises(ValueError, match="needs 4 ranks.*torchrun"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 n_model_shards=4)


@pytest.mark.parametrize("kw", [{}, {"fused": True, "fused_bins": 128}],
                         ids=["exact", "fused"])
def test_serve_over_http_on_four_ranks(tmp_path, kw):
    rng = np.random.default_rng(3)
    ids = [f"item{i}" for i in range(120)]
    vecs = rng.normal(size=(120, D)).astype(np.float32)
    path, bad = str(tmp_path / "idx.npz"), str(tmp_path / "bad.npz")
    EmbeddingIndex(ids, vecs).save(path)
    EmbeddingIndex(ids[:60], vecs[:60]).save(bad)
    queries = rng.normal(size=(3, D)).astype(np.float32)
    out, *rest = spawn("job_http", 4, str(tmp_path / "ranks"),
                       {"path": path, "bad": bad, "kw": kw,
                        "queries": queries.tolist()}, timeout=180)
    assert rest == [{"returned": True}] * 3  # every shard rank returned
    code, body = out["topk"]
    assert code == 200 and body["ids"][0] == "item3"
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), max_k=5,
                                    max_batch=2, n_model_shards=4, **kw)
    want_ids, want_s = jsvc.topk(queries, k=5)
    code, body = out["vectors"]
    assert code == 200
    _equal_up_to_ties(np.asarray(body["ids"]), body["scores"], want_ids,
                      want_s)
    assert out["reload"][0] == 200 and out["shards_kept"] == 4
    assert out["after_reload"][1]["ids"][0] == "item3"
    code, body = out["bad_reload"]   # rank 2 failed: nothing swapped
    assert code == 400 and "shard rank" in body["error"]
    assert out["missing"][0] == 400
    assert out["after_bad"][0] == 200 and out["items_served"] == 120
    stats = out["statsz"]
    assert stats["mode"] == jsvc.mode and stats["reloads"] == 1
    assert stats["resident_bytes_per_item"] == jsvc.resident_bytes_per_item
    assert out["closed"]
    json.dumps(stats)


def test_reload_under_concurrent_queries_on_four_ranks(tmp_path):
    """Queries keep coming while ``/admin/reload`` swaps the catalog
    between ``a`` (120 rows) and ``b`` (12 rows: 3 a shard, fewer than k)
    six times. No request fails, and every answer is wholly one
    catalog's: the JAX service's ids and scores on ``a`` or on ``b``. A
    query that a retired service answered after the commit would scan
    its old rows on rank 0 and the new ones elsewhere."""
    rng = np.random.default_rng(5)
    cats = {}
    for name, m in (("a", 120), ("b", 12)):
        ids = [f"{name}{i}" for i in range(m)]
        vecs = rng.normal(size=(m, D)).astype(np.float32)
        path = str(tmp_path / f"{name}.npz")
        EmbeddingIndex(ids, vecs).save(path)
        cats[name] = (path, jserver.RetrievalService(
            JaxIndex(ids, vecs), max_k=5, max_batch=2, n_model_shards=4))
    queries = rng.normal(size=(5, D)).astype(np.float32)
    out, *rest = spawn("job_http_reload_race", 4, str(tmp_path / "ranks"),
                       {"a": cats["a"][0], "b": cats["b"][0], "kw": {},
                        "queries": queries.tolist(), "reloads": 6},
                       timeout=180)
    assert rest == [{"returned": True}] * 3
    assert out["reloads"] == [200] * 6
    assert out["clients_done"] and out["closed"]
    want = {name: svc.topk(queries, k=5) for name, (_, svc) in cats.items()}
    seen = set()
    for rows, code, body in out["answers"]:
        assert code == 200, body
        got_ids = body["ids"] if len(rows) > 1 else [body["ids"]]
        got_s = body["scores"] if len(rows) > 1 else [body["scores"]]
        name = got_ids[0][0][0]
        seen.add(name)
        want_ids, want_s = want[name]
        _equal_up_to_ties(got_ids, got_s, want_ids[rows], want_s[rows])
    assert seen == {"a", "b"}, seen
