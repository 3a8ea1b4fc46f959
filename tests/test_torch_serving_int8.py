"""Quantized (int8) serving in the port against
``esrecsys_tpu.serving.server`` on the same index (M=2000, D=16, max_k=50,
max_batch=4, fused_bins=128), in the four int8 modes of the reference's
serving bench: ``quantized``, ``quantized_r8`` (``rescore_int8``),
``fused_q8`` and ``fused_q8_r8``.

Tolerances: ids equal; scores within 1e-5 absolute. Both sides select
candidates from the same int8 codes and scales (the quantizer is
bit-identical) and rescore them in float32, from the float32 rows or from
the int8 rows dequantized; the width-16 sums run in another order on each
side.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.serving import server as jserver
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving import server as tserver
from esrecsys_tpu_torch.tools import full_scale_run as tfsr

ATOL = 1e-5
M, D = 2000, 16
KW = dict(max_k=50, max_batch=4)
EVEN = [f"item{i}" for i in range(0, M, 2)]

# the reference's serving-bench modes (tools/serving_bench.mode_kwargs)
MODES = {
    "quantized": dict(quantized=True),
    "quantized_r8": dict(quantized=True, rescore_int8=True),
    "fused_q8": dict(fused=True, fused_bins=128, quantized=True),
    "fused_q8_r8": dict(fused=True, fused_bins=128, quantized=True,
                        rescore_int8=True),
}
WANT_MODE = {"quantized": "int8", "quantized_r8": "int8+r8",
             "fused_q8": "fused:bins=128+int8",
             "fused_q8_r8": "fused:bins=128+int8+r8"}
# float32 rows 4D, int8 rows D + 4, int8 scan copy D + 4
WANT_BYTES = {"quantized": 5 * D + 4, "quantized_r8": D + 4,
              "fused_q8": 6 * D + 8, "fused_q8_r8": 2 * D + 8}


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    rng = np.random.default_rng(0)
    ids = [f"item{i}" for i in range(M)]
    vecs = rng.normal(size=(M, D)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("idx") / "catalog.npz")
    EmbeddingIndex(ids, vecs).save(path)
    queries = rng.normal(size=(6, D)).astype(np.float32)
    return ids, vecs, path, queries


@pytest.fixture(scope="module", params=sorted(MODES))
def services(request, catalog):
    ids, vecs, _, _ = catalog
    kw = MODES[request.param]
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), filters={}, **KW,
                                    **kw)
    tsvc = tserver.RetrievalService(EmbeddingIndex(ids, vecs), filters={},
                                    device="cpu", **KW, **kw)
    return request.param, jsvc, tsvc


def _same(t, j):
    (ti, tv), (ji, jv) = t, j
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
    np.testing.assert_allclose(np.asarray(tv, np.float32),
                               np.asarray(jv, np.float32), rtol=0, atol=ATOL)


def test_topk_mode_and_residency_match_jax(services, catalog):
    name, jsvc, tsvc = services
    q = catalog[3]   # 6 queries: two chunks of max_batch=4
    _same(tsvc.topk(q, k=50), jsvc.topk(q, k=50))
    _same(tsvc.topk(q[:1], k=7), jsvc.topk(q[:1], k=7))
    assert tsvc.mode == jsvc.mode == WANT_MODE[name]
    assert (tsvc.resident_bytes_per_item == jsvc.resident_bytes_per_item
            == WANT_BYTES[name])


def test_rescore_int8_holds_no_float32_catalog(services):
    name, _, tsvc = services
    if tsvc.rescore_int8:
        assert tsvc._items is None
        assert tsvc._q_items.dtype.is_floating_point is False
    else:
        assert tsvc._items is not None
    if tsvc.fused:
        assert tsvc._items_packed.dtype == tsvc._q_items.dtype
        assert tsvc._fused_scales.shape == (tsvc._items_packed.shape[1],)


def test_exclude_by_id_and_filters_match_jax(services, catalog):
    _, jsvc, tsvc = services
    q = catalog[3][:3]
    excl = list(tsvc.topk(q[:1], k=5)[0][0][:3]) + ["not-in-catalog"]
    _same(tsvc.topk(q, k=10, exclude=excl), jsvc.topk(q, k=10, exclude=excl))
    _same(tsvc.topk_by_id("item7", k=10), jsvc.topk_by_id("item7", k=10))
    assert tsvc.set_filter("even", EVEN) == jsvc.set_filter("even", EVEN)
    t = tsvc.topk(q, k=20, filter="even")
    _same(t, jsvc.topk(q, k=20, filter="even"))
    assert all(int(i[4:]) % 2 == 0 for i in t[0].ravel())


def test_quantized_host_and_device_quantizers_agree(catalog):
    # rescore_int8 quantizes on the host (numpy twin), quantized on the
    # device from the resident float32 rows: the codes are the same bits
    ids, vecs, _, _ = catalog
    a = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 quantized=True, **KW)
    b = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 quantized=True, rescore_int8=True, **KW)
    assert np.array_equal(a._q_items.numpy(), b._q_items.numpy())
    assert np.array_equal(a._scales.numpy().view(np.int32),
                          b._scales.numpy().view(np.int32))


def test_option_checks_like_reference(catalog):
    ids, vecs, _, _ = catalog
    with pytest.raises(ValueError, match="rescore_int8"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 rescore_int8=True)
    with pytest.raises(ValueError, match="rescore_int8"):
        jserver.RetrievalService(JaxIndex(ids, vecs), rescore_int8=True)
    with pytest.raises(ValueError, match="sharded fused"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 fused=True, quantized=True,
                                 n_model_shards=2)
    # the int8 scan with approx_max_k selection is not ported
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 quantized=True, approx=True)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_round_trip_quantized_r8_matches_jax(catalog):
    ids, vecs, path, q = catalog
    jsvc = jserver.RetrievalService(JaxIndex(ids, vecs), quantized=True,
                                    rescore_int8=True, **KW)
    httpd = tserver.serve(path, port=0, quantized=True, rescore_int8=True,
                          device="cpu", **KW)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        one = _post(f"{url}/v1/topk", {"vector": q[0].tolist(), "k": 10})
        j_ids, j_scores = jsvc.topk(q[:1], k=10)
        assert one["ids"] == list(j_ids[0])
        np.testing.assert_allclose(one["scores"], j_scores[0], rtol=0,
                                   atol=ATOL)
        batch = _post(f"{url}/v1/topk", {"vectors": q[:3].tolist(), "k": 4})
        assert [len(r) for r in batch["ids"]] == [4, 4, 4]
        with urllib.request.urlopen(f"{url}/statsz", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["mode"] == "int8+r8"
        assert stats["resident_bytes_per_item"] == D + 4
        assert stats["queries"] >= 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_server_cli_flags_reach_the_service(catalog, monkeypatch):
    _, _, path, _ = catalog
    seen = {}

    class _Stop(Exception):
        pass

    def fake_serve(*args, **kw):
        seen.update(kw)
        raise _Stop

    monkeypatch.setattr(tserver, "serve", fake_serve)
    with pytest.raises(_Stop):
        tserver.main(["--index", path, "--quantized", "--rescore_int8",
                      "--fused", "--device", "cpu"])
    assert seen["quantized"] and seen["rescore_int8"] and seen["fused"]


@pytest.mark.parametrize("flags,mode", [
    (["--quantized_serving"], "int8"),
    (["--quantized_serving", "--rescore_int8", "--fused"],
     "fused:bins=4096+int8+r8")])
def test_full_scale_run_quantized_serving_on_cpu(tmp_path, capsys, flags,
                                                 mode):
    tfsr.main(["--out_dir", str(tmp_path), "--device", "cpu",
               "--corpus_size", "3000", "--num_albums_raw", "900",
               "--album_buckets", "300", "--num_artists", "500", *flags])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == mode and out["device"] == "cpu"
    assert out["serving_qps"] > 0
