"""Hot reload in the port (``RetrievalHTTPServer.reload_index``,
``/admin/reload``, ``QueryBatcher.idle`` and the handler's retry on
``QueryBatcher.Closed``) against the JAX package, on the reference's test
catalog (200 x 16) and a second catalog of 120 items.

Tolerances: after a reload the live server's answers equal a JAX service
built on the new index with the same options: ids identical, scores
within 1e-5 absolute (float32 sums of width 16 in another order). At
this size the approx select's reduction is 0, so its ids are JAX's too.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.serving import server as jserver
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving import server as tserver

ATOL = 1e-5
D = 16
KW = dict(max_k=10, max_batch=4)
MODES = {"exact": {}, "fused": {"fused": True, "fused_bins": 128},
         "int8+approx": {"quantized": True, "approx": True}}


@pytest.fixture(scope="module")
def catalogs(tmp_path_factory):
    root = tmp_path_factory.mktemp("reload")
    rng = np.random.default_rng(0)
    old = EmbeddingIndex([f"item{i}" for i in range(200)],
                         rng.normal(size=(200, D)).astype(np.float32))
    new = EmbeddingIndex([f"new{i}" for i in range(120)],
                         rng.normal(size=(120, D)).astype(np.float32))
    old_path, new_path = str(root / "catalog.npz"), str(root / "new.npz")
    old.save(old_path)
    new.save(new_path)
    return old_path, new_path


def _post(url, body, token=None):
    headers = {"Content-Type": "application/json"}
    if token:
        headers["X-Admin-Token"] = token
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


class _Live:
    """A port server on a free port, run on a thread."""

    def __init__(self, index, **kw):
        self.httpd = tserver.serve(index, port=0, device="cpu", **kw)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


@pytest.mark.parametrize("mode", list(MODES))
def test_hot_reload_swaps_catalog_under_live_traffic(catalogs, mode):
    """The reference's case: queries sent while the reload runs all
    succeed (on the old or the new service, through the coalescer), the
    health and query surface then show the new catalog, and a reload of
    a missing file is a clean 400 that leaves the server serving."""
    old_path, new_path = catalogs
    with _Live(old_path, **KW, **MODES[mode]) as live:
        q = EmbeddingIndex.load(old_path).vector("item3").tolist()
        stop, errors, answered = threading.Event(), [], [0]

        def hammer():
            while not stop.is_set():
                try:
                    _post(f"{live.url}/v1/topk", {"vector": q, "k": 3})
                    answered[0] += 1
                except Exception as e:  # any failed query fails the test
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        out = _post(f"{live.url}/admin/reload", {"index": new_path})
        time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors
        assert answered[0] > 0
        assert out["status"] == "ok" and out["items"] == 120
        assert out["index"] == new_path and out["aux"] == "rebuild"
        assert out["reload_seconds"] >= 0
        health = _get(f"{live.url}/healthz")
        assert health["items"] == 120 and health["index"] == new_path
        stats = _get(f"{live.url}/statsz")
        assert stats["reloads"] == 1 and stats["mode"] == \
            live.httpd.service.mode
        # the new generation answers as a JAX service on the new index
        jsvc = jserver.RetrievalService(
            JaxIndex.load(new_path), **KW, **MODES[mode])
        nq = EmbeddingIndex.load(new_path).vectors[:4] + 0.1
        got = _post(f"{live.url}/v1/topk", {"vectors": nq.tolist(), "k": 5})
        want_ids, want_scores = jsvc.topk(nq, k=5)
        assert got["ids"] == [list(r) for r in want_ids]
        np.testing.assert_allclose(got["scores"], want_scores, atol=ATOL)
        by_id = _post(f"{live.url}/v1/topk", {"id": "new5", "k": 3})
        assert "new5" in by_id["ids"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{live.url}/admin/reload",
                  {"index": new_path[:-4] + "-missing.npz"})
        assert e.value.code == 400
        assert _get(f"{live.url}/healthz")["items"] == 120
        assert _get(f"{live.url}/statsz")["reloads"] == 1


def test_admin_token_gates_reload(catalogs):
    old_path, _ = catalogs
    with _Live(old_path, coalesce=False, admin_token="sekrit",
               max_k=5, max_batch=2) as live:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{live.url}/admin/reload", {})
        assert e.value.code == 403
        _post(f"{live.url}/v1/topk", {"id": "item3", "k": 2})  # stays open
        assert _post(f"{live.url}/admin/reload", {},
                     token="sekrit")["status"] == "ok"
        assert live.httpd.reloads == 1


def test_rescore_int8_survives_hot_reload(catalogs):
    old_path, new_path = catalogs
    with _Live(old_path, quantized=True, rescore_int8=True,
               max_k=10, max_batch=2) as live:
        assert live.httpd.service.mode == "int8+r8"
        assert _post(f"{live.url}/admin/reload", {})["status"] == "ok"
        assert live.httpd.service.mode == "int8+r8"     # options carried
        assert live.httpd.service._items is None        # still f32-free
        assert live.httpd.index_path == old_path
        _post(f"{live.url}/admin/reload", {"index": new_path})
        assert live.httpd.service._items is None
        assert len(live.httpd.service.index) == 120


def test_aux_reuse_equals_rebuild_without_aux_structures(catalogs):
    old_path, new_path = catalogs
    nq = EmbeddingIndex.load(new_path).vectors[:3]
    answers = {}
    with _Live(old_path, coalesce=False, add_capacity=8, **KW) as live:
        for aux in ("rebuild", "reuse"):
            out = _post(f"{live.url}/admin/reload",
                        {"index": new_path, "aux": aux})
            assert out["aux"] == aux
            answers[aux] = _post(f"{live.url}/v1/topk",
                                 {"vectors": nq.tolist(), "k": 5})
            # the options travel: the new generation can grow
            assert live.httpd.service.capacity == 128
        assert answers["reuse"] == answers["rebuild"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{live.url}/admin/reload", {"aux": "bogus"})
        assert e.value.code == 400
        assert live.httpd.reloads == 2


def test_server_started_from_an_object_needs_a_path(catalogs):
    """serve() also takes an EmbeddingIndex. A reload without a path then
    has nothing to load: 400, and the old object keeps serving."""
    old_path, new_path = catalogs
    index = EmbeddingIndex.load(old_path)
    with _Live(index, coalesce=False, **KW) as live:
        before = live.httpd.service
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{live.url}/admin/reload", {})
        assert e.value.code == 400
        assert "path" in json.loads(e.value.read())["error"]
        assert live.httpd.service is before and live.httpd.reloads == 0
        assert live.httpd.index_path is None
        assert _post(f"{live.url}/admin/reload",
                     {"index": new_path})["items"] == 120
        assert live.httpd.index_path == new_path


def test_startup_filters_survive_a_reload_runtime_ones_do_not(catalogs):
    """As in the reference: the startup ``filters`` dict is applied to
    every generation; runtime registrations are not (row positions change
    with the catalog)."""
    old_path, new_path = catalogs
    with _Live(old_path, coalesce=False,
               filters={"some": ["new1", "new2", "item1"]}, **KW) as live:
        _post(f"{live.url}/admin/set_filter", {"name": "rt", "ids": ["item2"]})
        assert _get(f"{live.url}/statsz")["filters"] == ["rt", "some"]
        _post(f"{live.url}/admin/reload", {"index": new_path})
        assert _get(f"{live.url}/statsz")["filters"] == ["some"]
        got = _post(f"{live.url}/v1/topk", {"vector": [1.0] * D, "k": 5,
                                            "filter": "some"})
        assert sorted(got["ids"]) == ["new1", "new2"]


def test_batcher_idle_and_retire(catalogs):
    old_path, _ = catalogs
    svc = tserver.RetrievalService(EmbeddingIndex.load(old_path),
                                   device="cpu", **KW)
    b = tserver.QueryBatcher(svc)
    assert b.idle()
    ids, _ = b.submit(svc.index.vector("item4"), 3)
    assert ids[0] == "item4" and b.idle()
    tserver.RetrievalHTTPServer._retire_batcher(b)
    deadline = time.monotonic() + 10
    while not b._closed and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(tserver.QueryBatcher.Closed):
        b.submit(svc.index.vector("item4"), 3)


def test_request_retries_once_on_a_closed_batcher(catalogs):
    """A request that read the (service, batcher) pair just before a
    reload retired the batcher gets Closed from it, and the handler
    retries once on the current pair."""
    old_path, _ = catalogs
    with _Live(old_path, **KW) as live:
        httpd = live.httpd
        service, current = httpd.serving
        calls = []

        class Retired(tserver.QueryBatcher):
            def submit(self, *args, **kw):
                calls.append("retired")
                httpd._serving = (service, current)  # the reload's swap
                raise tserver.QueryBatcher.Closed("batcher closed")

        retired = Retired(service)
        httpd._serving = (service, retired)
        got = _post(f"{live.url}/v1/topk", {"id": "item9", "k": 3})
        assert calls == ["retired"] and got["ids"][0] == "item9"
        retired.close()
