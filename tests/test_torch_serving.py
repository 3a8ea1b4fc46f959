"""Serving in the port against ``esrecsys_tpu.serving.server`` on the same
index (M=2000, D=16, max_k=50, max_batch=4, fused_bins=128).

Tolerances: ids equal; scores within 1e-5 absolute. The returned scores
are float32 dot products of width 16 (exact mode: a matmul; fused mode: a
multiply-sum rescore), whose sums run in another order on each side.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.serving import server as jserver
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving import server as tserver

ATOL = 1e-5
M, D = 2000, 16
KW = dict(max_k=50, max_batch=4)
EVEN = [f"item{i}" for i in range(0, M, 2)]


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    rng = np.random.default_rng(0)
    ids = [f"item{i}" for i in range(M)]
    vecs = rng.normal(size=(M, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("idx") / "catalog.npz")
    EmbeddingIndex(ids, vecs).save(path)
    queries = rng.normal(size=(6, D)).astype(np.float32)
    return ids, vecs, path, queries


@pytest.fixture(scope="module", params=["exact", "fused"])
def services(request, catalog):
    ids, vecs, _, _ = catalog
    fused = {"fused": True, "fused_bins": 128} if request.param == "fused" \
        else {}
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), filters={},
                                    **KW, **fused)
    tsvc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), filters={},
                                    device="cpu", **KW, **fused)
    return jsvc, tsvc


def _same(t, j):
    (ti, tv), (ji, jv) = t, j
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(tv, np.float32),
                               np.asarray(jv, np.float32), rtol=0, atol=ATOL)


def test_topk_matches_jax(services, catalog):
    jsvc, tsvc = services
    q = catalog[3]   # 6 queries: two chunks of max_batch=4
    _same(tsvc.topk(q, k=50), jsvc.topk(q, k=50))
    _same(tsvc.topk(q[:1], k=7), jsvc.topk(q[:1], k=7))
    assert tsvc.mode == jsvc.mode
    assert tsvc.queries == 7 and tsvc.device_calls == 3


def test_exclude_matches_jax(services, catalog):
    jsvc, tsvc = services
    q = catalog[3][:3]
    excl = list(tsvc.topk(q[:1], k=5)[0][0][:3]) + ["not-in-catalog"]
    t = tsvc.topk(q, k=10, exclude=excl)
    _same(t, jsvc.topk(q, k=10, exclude=excl))
    assert t[0].shape == (3, 10) and not set(excl) & set(t[0].ravel())
    with pytest.raises(ValueError, match="max_k"):
        tsvc.topk(q, k=48, exclude=excl)


def test_topk_by_id_matches_jax(services):
    jsvc, tsvc = services
    _same(tsvc.topk_by_id("item7", k=10), jsvc.topk_by_id("item7", k=10))
    ids, _ = tsvc.topk_by_id("item7", k=10, exclude=["item7"])
    assert "item7" not in ids and len(ids) == 10


def test_filters_match_jax(services, catalog):
    jsvc, tsvc = services
    q = catalog[3][:4]
    assert tsvc.set_filter("even", EVEN) == jsvc.set_filter("even", EVEN)
    t = tsvc.topk(q, k=20, filter="even")
    _same(t, jsvc.topk(q, k=20, filter="even"))
    assert all(int(i[4:]) % 2 == 0 for i in t[0].ravel())
    # fewer eligible rows than k: the -inf tail carries a sanitized id
    assert tsvc.set_filter("few", ["item1", "item2", "nope"]) == 2
    jsvc.set_filter("few", ["item1", "item2", "nope"])
    t = tsvc.topk(q, k=5, filter="few")
    _same(t, jsvc.topk(q, k=5, filter="few"))
    assert np.isinf(t[1][:, 2:]).all()
    with pytest.raises(ValueError, match="unknown filter"):
        tsvc.topk(q, filter="missing")


def test_fused_filter_mask_is_padded_once(catalog):
    ids, vecs, _, _ = catalog
    svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), filters={},
                                   device="cpu", fused=True, fused_bins=128,
                                   **KW)
    svc.set_filter("even", EVEN)
    mask = svc._filter_masks["even"]
    assert mask.shape == (svc._items_packed.shape[1],)   # Mp = 2048, not M
    assert int(mask.sum()) == len(EVEN) and not mask[M:].any()


def test_fused_service_at_another_dim_matches_jax():
    # the CPU takes the plain version, which serves any dim, as the
    # reference's fused mode does (on the card the generic kernel does)
    rng = np.random.default_rng(5)
    d = 24
    ids = [f"item{i}" for i in range(M)]
    vecs = rng.normal(size=(M, d)).astype(np.float32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    fused = dict(fused=True, fused_bins=128, filters={"even": EVEN}, **KW)
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), **fused)
    tsvc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                    **fused)
    _same(tsvc.topk(q, k=30), jsvc.topk(q, k=30))
    _same(tsvc.topk(q, k=30, filter="even"), jsvc.topk(q, k=30, filter="even"))


def test_filters_disabled_raise(catalog):
    ids, vecs, _, q = catalog
    svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                   **KW)
    with pytest.raises(ValueError, match="not enabled"):
        svc.set_filter("x", ["item1"])
    with pytest.raises(ValueError, match="not enabled"):
        svc.topk(q, filter="x")


def test_query_batcher_coalesces(catalog):
    ids, vecs, _, q = catalog
    svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                   fused=True, fused_bins=128, max_k=50,
                                   max_batch=8)
    want_ids, want_scores = svc.topk(q, k=10)
    calls_before = svc.device_calls
    batcher = tserver.QueryBatcher(svc, max_wait_ms=200.0)
    results = [None] * len(q)

    def worker(i):
        results[i] = batcher.submit(q[i], 10)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(q))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    for i, (r_ids, r_scores) in enumerate(results):
        np.testing.assert_array_equal(r_ids, want_ids[i])
        np.testing.assert_allclose(r_scores, want_scores[i], rtol=0,
                                   atol=ATOL)
    assert svc.device_calls - calls_before < len(q)   # coalesced
    with pytest.raises(ValueError, match="query shape"):
        batcher.submit(q[0][:3], 5)
    with pytest.raises(tserver.QueryBatcher.Closed):
        batcher.submit(q[0], 5)


def _post(url, body, token=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    if token:
        req.add_header("X-Admin-Token", token)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_round_trip_matches_jax(catalog):
    ids, vecs, path, q = catalog
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), fused=True,
                                    fused_bins=128, **KW)
    httpd = tserver.serve(path, port=0, fused=True, fused_bins=128,
                          filters={}, admin_token="s3cret", device="cpu",
                          **KW)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "items": M, "dim": D, "max_k": 50,
                          "index": path}
        one = _post(f"{url}/v1/topk", {"vector": q[0].tolist(), "k": 10})
        j_ids, j_scores = jsvc.topk(q[:1], k=10)
        assert one["ids"] == list(j_ids[0])
        np.testing.assert_allclose(one["scores"], j_scores[0], rtol=0,
                                   atol=ATOL)
        by_id = _post(f"{url}/v1/topk", {"id": "item3", "k": 5,
                                         "exclude": ["item3"]})
        assert "item3" not in by_id["ids"] and len(by_id["ids"]) == 5
        batch = _post(f"{url}/v1/topk", {"vectors": q[:3].tolist(), "k": 4})
        assert [len(r) for r in batch["ids"]] == [4, 4, 4]
        assert batch["ids"][0] == list(j_ids[0][:4])
        assert _post(f"{url}/admin/set_filter",
                     {"name": "even", "ids": EVEN}, token="s3cret")[
                         "matched"] == M // 2
        filt = _post(f"{url}/v1/topk", {"vector": q[1].tolist(), "k": 5,
                                        "filter": "even"})
        assert all(int(i[4:]) % 2 == 0 for i in filt["ids"])
        errors = {}
        missing = path[:-len(".npz")] + "-missing.npz"
        for name, route, body, token in (
                ("reload", "/admin/reload", {"index": missing}, "s3cret"),
                ("add", "/admin/add_items", {}, "s3cret"),
                ("token", "/admin/set_filter", {"name": "x", "ids": []}, None),
                ("unknown_id", "/v1/topk", {"id": "nope"}, None),
                ("bad_dim", "/v1/topk", {"vector": [1.0, 2.0]}, None),
                ("text", "/v1/topk", {"text": "jazz"}, None)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + route, body, token)
            errors[name] = e.value.code
        # a reload from a missing file, and an add without add_capacity
        assert errors == {"reload": 400, "add": 400, "token": 403,
                          "unknown_id": 404, "bad_dim": 400, "text": 400}
        with urllib.request.urlopen(f"{url}/statsz", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["mode"] == "fused:bins=128"
        assert stats["filters"] == ["even"] and stats["queries"] >= 6
        assert stats["resident_bytes_per_item"] == 6 * D
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("option,value", [
    ("approx", True), ("ivf_clusters", 16), ("pq_subspaces", 4), ("n_model_shards", 2),
    ("add_capacity", 10), ("encoders", {"text": len})])
def test_unported_modes_raise(catalog, option, value):
    """Every reference option that selects a mode is ported: approx,
    add_capacity, ivf_clusters and pq_subspaces construct with the
    reference's mode and capacity; encoders run on a raw query; the
    sharded mode (``n_model_shards``) raises the reference's own refusal
    with approx, and in one process it asks for ``torchrun``'s ranks."""
    ids, vecs, _, _ = catalog
    if option == "encoders":
        svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs),
                                       device="cpu", **{option: value})
        assert svc.mode == "exact"
        assert float(svc.encode("text", "four")) == 4.0
        with pytest.raises(ValueError, match="no 'image_key' encoder"):
            svc.encode("image_key", "k")
        return
    if option in ("approx", "add_capacity", "ivf_clusters", "pq_subspaces"):
        svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs),
                                       device="cpu", **{option: value})
        mode = {"approx": "approx", "add_capacity": "exact",
                "ivf_clusters": f"ivf:{value}:nprobe=8",
                "pq_subspaces": f"pq:S={value}:oversample=64"}[option]
        assert svc.mode == mode
        assert svc.capacity == M + (value if option == "add_capacity" else 0)
        return
    with pytest.raises(ValueError, match="does not compose"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 approx=True, **{option: value})
    with pytest.raises(ValueError, match="does not\n? ?compose"):
        jserver.RetrievalService(JaxIndex(ids, vecs), approx=True,
                                 **{option: value})
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 **{option: value})


def test_unported_defaults_and_unknown_options(catalog):
    ids, vecs, _, _ = catalog
    svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                   approx=False, add_capacity=0, **KW)
    assert svc.mode == "exact" and svc.resident_bytes_per_item == 4 * D
    with pytest.raises(TypeError, match="unexpected"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 bogus=1)


def test_service_without_card_raises(catalog):
    import torch

    ids, vecs, _, _ = catalog
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), **KW)
