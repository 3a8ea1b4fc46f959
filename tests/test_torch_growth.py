"""Catalog growth in the port (``EmbeddingIndex.reserve``/``extend``,
``RetrievalService(add_capacity=N).add_items``, ``/admin/add_items``)
against the JAX package, on the reference's test catalog (200 x 16, ids
``item{i}``), in the exact, approx, int8, int8+r8, fused and fused-int8
modes.

Tolerances: the same adds and queries go into both packages' services;
ids are identical and scores agree within 1e-5 absolute (float32 sums of
width 16 in another order). At this size the approx select's reduction
is 0 at ``recall_target=0.99``, so its ids are JAX's too. A grown
service's answers equal a fresh service's on the grown catalog: ids
identical, scores within 1e-6. The host index matches the reference's
bit for bit.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.serving import server as jserver
from esrecsys_tpu_torch.retrieval import mips as tmips
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving import server as tserver

ATOL = 1e-5
M, D = 200, 16
KW = dict(max_k=10, max_batch=4)
MODES = {
    "exact": {},
    "approx": {"approx": True, "recall_target": 0.99},
    "int8": {"quantized": True},
    "int8+r8": {"quantized": True, "rescore_int8": True},
    "fused": {"fused": True, "fused_bins": 128},
    "fused-int8": {"fused": True, "quantized": True, "fused_bins": 128},
}


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(M, D)).astype(np.float32)
    return [f"item{i}" for i in range(M)], vecs


def _pair(catalog, mode, **extra):
    ids, vecs = catalog
    kw = {**KW, **MODES[mode], **extra}
    return (tserver.RetrievalService(EmbeddingIndex(list(ids), vecs.copy()),
                                     device="cpu", **kw),
            jserver.RetrievalService(JaxIndex(list(ids), vecs.copy()), **kw))


def _buffers(svc):
    return {name: getattr(svc, name) for name in
            ("_items", "_q_items", "_scales", "_items_packed",
             "_fused_scales") if getattr(svc, name) is not None}


def _same(t, j, atol=ATOL):
    np.testing.assert_array_equal(np.asarray(t[0]), np.asarray(j[0]))
    np.testing.assert_allclose(np.asarray(t[1], np.float32),
                               np.asarray(j[1], np.float32), rtol=0,
                               atol=atol)


def _adds(seed=30):
    rng = np.random.default_rng(seed)
    # scaled rows win queries, so answering them proves the bound moved
    first = (rng.normal(size=(8, D)) * 2.0).astype(np.float32)
    second = rng.normal(size=(4, D)).astype(np.float32)
    return ([f"new{i}" for i in range(8)], first,
            [f"more{i}" for i in range(4)], second)


@pytest.mark.parametrize("mode", list(MODES))
def test_add_items_matches_jax(catalog, mode):
    tsvc, jsvc = _pair(catalog, mode, add_capacity=32)
    assert tsvc.capacity == jsvc.capacity == M + 32
    assert tsvc.mode == jsvc.mode
    assert tsvc.resident_bytes_per_item == jsvc.resident_bytes_per_item
    before = {k: v.data_ptr() for k, v in _buffers(tsvc).items()}
    ids1, v1, ids2, v2 = _adds()
    assert tsvc.add_items(ids1, v1) == jsvc.add_items(ids1, v1) == M + 8
    assert tsvc.add_items(ids2, v2) == jsvc.add_items(ids2, v2) == M + 12
    q = np.concatenate([v1[:3], np.random.default_rng(1).normal(
        size=(3, D)).astype(np.float32)])
    _same(tsvc.topk(q, k=10), jsvc.topk(q, k=10))
    _same(tsvc.topk_by_id("new2", k=5), jsvc.topk_by_id("new2", k=5))
    assert tsvc.topk(v1[2][None], k=1)[0][0][0] == "new2"
    # written in place: no buffer was reallocated
    assert {k: v.data_ptr() for k, v in _buffers(tsvc).items()} == before
    assert tsvc.index.ids == jsvc.index.ids
    np.testing.assert_array_equal(tsvc.index.vectors, jsvc.index.vectors)


@pytest.mark.parametrize("mode", list(MODES))
def test_grown_service_equals_a_fresh_one(catalog, mode):
    ids, vecs = catalog
    grown = tserver.RetrievalService(EmbeddingIndex(list(ids), vecs.copy()),
                                     device="cpu", add_capacity=64, **KW,
                                     **MODES[mode])
    ids1, v1, ids2, v2 = _adds(31)
    grown.add_items(ids1, v1)
    grown.add_items(ids2, v2)
    fresh = tserver.RetrievalService(
        EmbeddingIndex(list(ids) + ids1 + ids2,
                       np.concatenate([vecs, v1, v2])),
        device="cpu", **KW, **MODES[mode])
    q = np.concatenate([v2, np.random.default_rng(2).normal(
        size=(4, D)).astype(np.float32)])
    _same(grown.topk(q, k=10), fresh.topk(q, k=10), atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "int8+r8", "fused-int8"])
def test_guards_leave_nothing_half_applied(catalog, mode):
    tsvc, jsvc = _pair(catalog, mode, add_capacity=16)
    tsvc.add_items(["a"], np.ones((1, D), np.float32))
    snap = {k: v.clone() for k, v in _buffers(tsvc).items()}
    n, ids_before = len(tsvc.index), list(tsvc.index.ids)
    bad = [
        (["x%d" % i for i in range(16)], np.zeros((16, D)), "capacity"),
        (["a"], np.zeros((1, D)), "duplicate"),
        (["b", "b"], np.zeros((2, D)), "duplicate"),
        ([7, "7"], np.zeros((2, D)), "duplicate"),  # stringified first
        (["c"], np.zeros((1, D + 1)), "vectors"),
        (["c", "d"], np.zeros((1, D)), "ids"),
    ]
    for ids, vecs, match in bad:
        with pytest.raises(ValueError, match=match):
            tsvc.add_items(ids, vecs)
    assert len(tsvc.index) == n == tsvc._n_valid
    assert tsvc.index.ids == ids_before
    for k, v in _buffers(tsvc).items():
        assert torch.equal(v, snap[k]), k
    # the reference rejects the same batches
    jsvc.add_items(["a"], np.ones((1, D), np.float32))
    for ids, vecs, _ in bad[:4]:
        with pytest.raises(ValueError):
            jsvc.add_items(ids, vecs)
    with pytest.raises(ValueError, match="headroom"):
        tserver.RetrievalService(EmbeddingIndex(*catalog), device="cpu",
                                 **KW).add_items(["z"], np.zeros((1, D)))


def test_max_k_clamps_to_capacity_and_k_to_the_live_size(catalog):
    """The reference's review case: a growable service's max_k clamps to
    its capacity, while k never exceeds the live item count."""
    ids, vecs = catalog
    t = tserver.RetrievalService(EmbeddingIndex(ids[:20], vecs[:20].copy()),
                                 device="cpu", max_k=50, max_batch=4,
                                 add_capacity=100)
    j = jserver.RetrievalService(JaxIndex(ids[:20], vecs[:20].copy()),
                                 max_k=50, max_batch=4, add_capacity=100)
    assert t.max_k == j.max_k == 50
    got = t.topk(vecs[3][None], k=50)
    assert got[0].shape == (1, 20) and np.isfinite(got[1]).all()
    _same(got, j.topk(vecs[3][None], k=50))
    for svc in (t, j):
        svc.add_items([f"g{i}" for i in range(40)], vecs[20:60].copy())
    got = t.topk(vecs[3][None], k=50)
    assert got[0].shape == (1, 50)
    _same(got, j.topk(vecs[3][None], k=50))
    with pytest.raises(ValueError, match="catalog size"):
        tserver.RetrievalService(EmbeddingIndex(ids[:20], vecs[:20].copy()),
                                 device="cpu", max_k=50, add_capacity=10
                                 ).topk(vecs[:1], k=15,
                                        exclude=[f"x{i}" for i in range(10)])


@pytest.mark.parametrize("mode", ["exact", "fused", "approx"])
def test_filters_live_at_capacity(catalog, mode):
    """The reference's runtime-registration case: rows added later are
    outside a filter until it is set again."""
    ids, vecs = catalog
    rng = np.random.default_rng(41)
    t = tserver.RetrievalService(EmbeddingIndex(list(ids), vecs.copy()),
                                 device="cpu", filters={}, add_capacity=8,
                                 **KW, **MODES[mode])
    assert t.set_filter("evens", ids[::2] + ["ghost"]) == 100
    got, _ = t.topk(rng.normal(size=(1, D)).astype(np.float32), k=10,
                    filter="evens")
    assert all(int(g[4:]) % 2 == 0 for g in got[0])
    fresh = (rng.normal(size=(1, D)) * 3).astype(np.float32)
    t.add_items(["fresh"], fresh)
    assert "fresh" not in t.topk(fresh, k=10, filter="evens")[0][0]
    t.set_filter("evens", ["fresh"])
    got, scores = t.topk(fresh, k=10, filter="evens")
    assert got[0][0] == "fresh" and np.isfinite(scores[0][0])
    assert not np.isfinite(scores[0][1:]).any()


def test_fused_int8_add_writes_codes_and_the_flat_scale(catalog):
    t, j = _pair(catalog, "fused-int8", add_capacity=16)
    probe = np.zeros((1, D), np.float32)
    probe[0, 0] = 100.0
    for svc in (t, j):
        svc.add_items(["shiny"], probe)
    assert t.topk(probe, k=3)[0][0][0] == "shiny"
    _same(t.topk(probe, k=3), j.topk(probe, k=3))
    assert abs(float(t._fused_scales[M]) - 100.0 / 127.0) < 1e-6
    assert t._items_packed[0, M].item() == 127
    q8, sc = tmips.quantize_rows_np(probe)
    np.testing.assert_array_equal(t._q_items[M].numpy(), q8[0])


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_add_items_over_http_matches_jax(catalog, tmp_path):
    ids, vecs = catalog
    path = str(tmp_path / "catalog.npz")
    EmbeddingIndex(ids, vecs).save(path)
    httpd = tserver.serve(path, port=0, coalesce=False, add_capacity=16,
                          device="cpu", **KW)
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs.copy()),
                                    add_capacity=16, **KW)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        new = (np.random.default_rng(32).normal(size=(3, D)) * 2.0
               ).astype(np.float32)
        out = _post(f"{url}/admin/add_items",
                    {"ids": ["a1", "a2", "a3"], "vectors": new.tolist()})
        assert out == {"status": "ok", "added": 3, "items": M + 3,
                       "capacity_left": 13}
        jsvc.add_items(["a1", "a2", "a3"], new)
        got = _post(f"{url}/v1/topk", {"id": "a2", "k": 5})
        want = jsvc.topk_by_id("a2", k=5)
        assert got["ids"] == list(want[0]) and got["ids"][0] == "a2"
        np.testing.assert_allclose(got["scores"], want[1], atol=ATOL)
        with urllib.request.urlopen(f"{url}/statsz", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["items"] == M + 3 and stats["capacity"] == M + 16
        codes = {}
        for name, body in (("dup", {"ids": ["a1"], "vectors": [[0.0] * D]}),
                           ("dim", {"ids": ["z"], "vectors": [[0.0] * 3]}),
                           ("full", {"ids": [f"f{i}" for i in range(14)],
                                     "vectors": [[0.0] * D] * 14})):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{url}/admin/add_items", body)
            codes[name] = e.value.code
        assert codes == {"dup": 400, "dim": 400, "full": 400}
        assert len(httpd.service.index) == M + 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("option,value", [
    ("ivf_clusters", 8), ("pq_subspaces", 4), ("n_model_shards", 2)])
def test_unported_options_still_raise_with_add_capacity(catalog, option,
                                                        value):
    """With add_capacity: the IVF and the sharded modes refuse growth as
    the reference does (they grow through a reload); the pq mode
    grows."""
    ids, vecs = catalog
    kw = dict(add_capacity=8, **{option: value})
    if option == "pq_subspaces":
        svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs),
                                       device="cpu", pq_codes=32, **kw)
        assert svc.capacity == M + 8 and svc.mode.startswith("pq:S=4")
        return
    with pytest.raises(ValueError, match="grow via /admin/reload"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs),
                                 device="cpu", **kw)
    with pytest.raises(ValueError, match="grow via /admin/reload"):
        jserver.RetrievalService(JaxIndex(ids, vecs), **kw)


def test_index_reserve_and_extend_match_jax(catalog):
    ids, vecs = catalog
    t, j = EmbeddingIndex(ids[:50], vecs[:50]), JaxIndex(ids[:50], vecs[:50])
    for idx in (t, j):
        idx.reserve(60)
    buf = t.vectors.base
    steps = [([1, "2", 3], vecs[50:53]), (["x"], vecs[53:54]),
             ([f"y{i}" for i in range(6)], vecs[54:60]),
             (["past"], vecs[60:61])]            # past the reserved rows
    for k, (new_ids, new_vecs) in enumerate(steps):
        for idx in (t, j):
            idx.extend(new_ids, new_vecs)
        assert t.ids == j.ids and t._id2row == j._id2row
        np.testing.assert_array_equal(t.vectors, j.vectors)
        if k < 3:   # appended in place while the reserve lasts
            assert t.vectors.base is buf
    assert t.vector("2").tolist() == vecs[51].tolist()
    for bad_ids, bad_vecs in (([2], vecs[:1]), (["q", "q"], vecs[:2]),
                              (["w"], vecs[:1, :8]), (["w", "v"], vecs[:1])):
        with pytest.raises(ValueError):
            t.extend(bad_ids, bad_vecs)
        with pytest.raises(ValueError):
            j.extend(bad_ids, bad_vecs)
    assert len(t) == len(j) == 61 and t.ids == j.ids
