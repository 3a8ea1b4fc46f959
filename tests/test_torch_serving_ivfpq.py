"""The IVF and PQ serving modes of the port (``RetrievalService``, the HTTP
server's reload, ``add_items``, the CLI, ``tools/retrieval_quality_study``)
against the JAX package's, on the CPU at a small size (a mixture catalog
of 2,000 x 16, 16 cells, S=4).

Both packages serve the same IVF and PQ structures (built by the JAX
package and saved as npz, which the port loads): ids are identical and
scores agree within 1e-5 relative (float32 sums in another order). The
mode strings and resident bytes per item are the reference's letter for
letter. A reload with ``aux="reuse"`` derives the new catalog's
structures from the live centroids and codebooks by one assign or encode
pass, as the JAX package does: identical tables and codes. A grown pq
service equals a fresh one over the grown catalog with the same codebook:
ids identical, scores within 1e-6.
"""

import json
import logging
import os
import threading
import urllib.request

import numpy as np
import pytest

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.retrieval.ivf import IVFIndex as JaxIVF
from esrecsys_tpu.retrieval.pq import PQCodebook as JaxPQ
from esrecsys_tpu.serving import server as jserver
from esrecsys_tpu.tools import retrieval_quality_study as jrqs
from esrecsys_tpu.tools import serving_bench as jsb
from esrecsys_tpu_torch.retrieval import ivf as tivf
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.serving import server as tserver
from esrecsys_tpu_torch.tools import retrieval_quality_study as trqs
from esrecsys_tpu_torch.tools import serving_bench as tsb

RTOL = 1e-5
M, D = 2000, 16
KW = dict(max_k=20, max_batch=4)
KNOBS = dict(ivf_clusters=16, nprobe=4, ivf_iters=4, pq_subspaces=4,
             pq_oversample=8, pq_rotate=False, pq_anisotropic=0.0,
             recall_target=0.95)
SIX = ("ivf", "ivf_quantized", "pq", "ivf_pq", "pq_r8", "ivf_pq_r8")


class _Knobs:
    def __init__(self, **kw):
        self.__dict__.update(KNOBS, **kw)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    root = tmp_path_factory.mktemp("ivfpq")
    rng = np.random.default_rng(0)
    means = rng.normal(size=(16, D)).astype(np.float32) * 3.0
    vecs = (means[rng.integers(0, 16, M)]
            + rng.normal(size=(M, D)).astype(np.float32) * 0.3)
    ids = [f"item{i}" for i in range(M)]
    q = (vecs[rng.integers(0, M, 6)]
         + rng.normal(size=(6, D)).astype(np.float32) * 0.2)
    ivf = JaxIVF.build(vecs, 16, iters=4)
    pq = JaxPQ.build(vecs, 4, n_codes=32, iters=4)
    paths = {"ivf": str(root / "ivf.npz"), "pq": str(root / "pq.npz"),
             "index": str(root / "catalog.npz"), "root": str(root)}
    ivf.save(paths["ivf"])
    pq.save(paths["pq"])
    EmbeddingIndex(ids, vecs).save(paths["index"])
    return ids, vecs, q, paths


def _prebuilt(kw, paths):
    """The mode's keywords with the saved JAX structures as prebuilt
    files (so both packages serve the same cells and codes)."""
    kw = dict(kw)
    if kw.get("ivf_clusters"):
        kw["ivf_index_path"] = paths["ivf"]
    if kw.get("pq_subspaces"):
        kw["pq_index_path"] = paths["pq"]
    return kw


def _same(t, j, rtol=RTOL):
    np.testing.assert_array_equal(np.asarray(t[0]), np.asarray(j[0]))
    np.testing.assert_allclose(np.asarray(t[1], np.float32),
                               np.asarray(j[1], np.float32), rtol=rtol,
                               atol=1e-6)


@pytest.mark.parametrize("mode", SIX)
def test_modes_match_jax(catalog, mode):
    ids, vecs, q, paths = catalog
    kw = _prebuilt(tsb.mode_kwargs(mode, _Knobs()), paths)
    filters = {"even": ids[::2]}
    t = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 filters=filters, **KW, **kw)
    j = jserver.RetrievalService(JaxIndex(ids, vecs), filters=filters,
                                 **KW, **kw)
    assert t.mode == j.mode
    assert t.resident_bytes_per_item == j.resident_bytes_per_item
    _same(t.topk(q, k=20), j.topk(q, k=20))
    _same(t.topk(q, k=7, filter="even"), j.topk(q, k=7, filter="even"))
    _same(t.topk(q, k=9, exclude=["item3"]), j.topk(q, k=9,
                                                    exclude=["item3"]))
    if "r8" in mode:
        assert t._items is None   # prebuilt structures: no float32 upload


def test_mode_strings_and_bytes(catalog):
    ids, vecs, _, paths = catalog
    tb = tivf.IVFIndex.build(vecs, 8, iters=2, device="cpu")
    cases = [
        (dict(ivf_index_path=paths["ivf"], nprobe=3), "ivf:16:nprobe=3",
         4 * D + 4),
        (dict(ivf_index_path=paths["ivf"], quantized=True,
              rescore_int8=True), "ivf:16:nprobe=8+int8+r8", D + 4 + 4),
        (dict(pq_index_path=paths["pq"], pq_oversample=5),
         "pq:S=4:oversample=5", 4 * D + 4),
        (dict(pq_subspaces=2, pq_rotate=True, pq_anisotropic=0.5,
              pq_codes=16, pq_iters=2, rescore_int8=True),
         "pq:S=2+rotated+aniso=0.5:oversample=64+r8", D + 4 + 2),
        (dict(ivf_warm_from=tb, pq_index_path=paths["pq"]),
         "ivf:8:nprobe=8+pq:S=4:oversample=64", 4 * D + 4 + 4),
    ]
    for kw, mode, nbytes in cases:
        svc = tserver.RetrievalService(EmbeddingIndex(ids, vecs),
                                       device="cpu", **KW, **kw)
        assert svc.mode == mode and svc.resident_bytes_per_item == nbytes
    # at the flagship's width the reference's example: pq S=8 264 -> 76
    assert 4 * 64 + 8 == 264 and 64 + 4 + 8 == 76


@pytest.mark.parametrize("kw,match", [
    (dict(ivf_clusters=8, approx=True), "mutually exclusive"),
    (dict(ivf_clusters=8, fused=True), "does not compose"),
    (dict(pq_subspaces=4, fused=True), "does not compose"),
    (dict(pq_subspaces=4, quantized=True), "alternative catalog scan"),
    (dict(pq_subspaces=4, approx=True), "alternative catalog scan"),
    (dict(rescore_int8=True), "enable quantized or a pq mode"),
    (dict(ivf_clusters=8, rescore_int8=True), "enable quantized or a pq"),
    (dict(ivf_clusters=8, add_capacity=4), "grow via /admin/reload"),
])
def test_exclusive_options_raise_as_the_reference(catalog, kw, match):
    ids, vecs, _, _ = catalog
    with pytest.raises(ValueError, match=match):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 **kw)
    with pytest.raises(ValueError):
        jserver.RetrievalService(JaxIndex(ids, vecs), **kw)


def test_prebuilt_caches_skip_kmeans(catalog, monkeypatch, caplog):
    ids, vecs, q, paths = catalog
    root = paths["root"]
    ivf_path, pq_path = os.path.join(root, "own_ivf"), os.path.join(
        root, "own_pq")   # without .npz: saved as .npz, found on restart
    first = tserver.RetrievalService(
        EmbeddingIndex(ids, vecs), device="cpu", ivf_clusters=8, ivf_iters=2,
        ivf_index_path=ivf_path, pq_subspaces=4, pq_codes=16, pq_iters=2,
        pq_index_path=pq_path, **KW)
    assert os.path.exists(ivf_path + ".npz") and os.path.exists(
        pq_path + ".npz")

    def no_kmeans(*a, **k):
        raise AssertionError("k-means ran although the files exist")

    monkeypatch.setattr(tivf, "kmeans", no_kmeans)
    monkeypatch.setattr("esrecsys_tpu_torch.retrieval.pq.kmeans", no_kmeans)
    with caplog.at_level(logging.WARNING):
        second = tserver.RetrievalService(
            EmbeddingIndex(ids, vecs), device="cpu", ivf_clusters=8,
            ivf_index_path=ivf_path, ivf_max_cell=2, pq_subspaces=8,
            pq_index_path=pq_path, rescore_int8=True, **KW)
    assert "ivf_max_cell=2 ignored" in caplog.text
    assert "requested S=8 C=256 ignored" in caplog.text
    assert second._items is None
    np.testing.assert_array_equal(second.ivf.bucket_ids,
                                  first.ivf.bucket_ids)
    np.testing.assert_array_equal(second.pq.codes, first.pq.codes)
    assert second.mode == "ivf:8:nprobe=8+pq:S=4:oversample=64+r8"
    with pytest.raises(ValueError, match="was built for"):
        tserver.RetrievalService(EmbeddingIndex(ids[:100], vecs[:100]),
                                 device="cpu", ivf_index_path=ivf_path)
    with pytest.raises(ValueError, match="was built for"):
        tserver.RetrievalService(EmbeddingIndex(ids[:100], vecs[:100]),
                                 device="cpu", pq_index_path=pq_path)
    with pytest.raises(ValueError, match="does not exist"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 ivf_index_path=os.path.join(root, "none"))
    with pytest.raises(ValueError, match="does not exist"):
        tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                 pq_index_path=os.path.join(root, "none"))


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_reload_rebuild_and_reuse_carry_parameters(catalog, tmp_path):
    ids, vecs, q, paths = catalog
    rng = np.random.default_rng(1)
    new_vecs = vecs + rng.normal(size=vecs.shape).astype(np.float32) * 0.05
    new_path = str(tmp_path / "new.npz")
    EmbeddingIndex(ids, new_vecs).save(new_path)
    ivf_path, pq_path = str(tmp_path / "ivf.npz"), str(tmp_path / "pq.npz")
    JaxIVF.load(paths["ivf"]).save(ivf_path)
    JaxPQ.load(paths["pq"]).save(pq_path)
    # prebuilt files only: the build parameters come from the live service
    httpd = tserver.serve(paths["index"], port=0, device="cpu",
                          coalesce=False, ivf_index_path=ivf_path,
                          pq_index_path=pq_path, nprobe=4, pq_oversample=8,
                          **KW)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        old = httpd.service
        rep = _post(f"{url}/admin/reload", {"index": new_path,
                                            "aux": "reuse"})
        assert rep["status"] == "ok" and rep["aux"] == "reuse"
        reused = httpd.service
        # reuse: the live centroids and codebook, one assign/encode pass
        np.testing.assert_array_equal(reused.ivf.centroids,
                                      old.ivf.centroids)
        np.testing.assert_array_equal(reused.pq.centroids,
                                      old.pq.centroids)
        j_ivf = JaxIVF.load(paths["ivf"]).reassign(new_vecs)
        j_pq = JaxPQ.load(paths["pq"]).encode(new_vecs)
        np.testing.assert_array_equal(reused.ivf.bucket_ids, j_ivf.bucket_ids)
        np.testing.assert_array_equal(reused.pq.codes, j_pq.codes)
        # the files now hold the new catalog's structures
        np.testing.assert_array_equal(JaxIVF.load(ivf_path).bucket_ids,
                                      j_ivf.bucket_ids)
        np.testing.assert_array_equal(JaxPQ.load(pq_path).codes, j_pq.codes)
        j_svc = jserver.RetrievalService(
            JaxIndex(ids, new_vecs), ivf_index_path=ivf_path,
            pq_index_path=pq_path, nprobe=4, pq_oversample=8, **KW)
        _same(reused.topk(q, k=20), j_svc.topk(q, k=20))
        assert reused.mode == j_svc.mode
        got = _post(f"{url}/v1/topk", {"vector": q[0].tolist(), "k": 5})
        assert got["ids"] == list(j_svc.topk(q[:1], k=5)[0][0])
        # rebuild: trained anew with the carried parameters
        httpd.reload_index(new_path, aux="rebuild")
        rebuilt = httpd.service
        assert httpd._service_kwargs["ivf_clusters"] == 16
        assert httpd._service_kwargs["pq_subspaces"] == 4
        assert httpd._service_kwargs["pq_codes"] == 32
        assert httpd._service_kwargs["pq_rotate"] is False
        assert rebuilt.ivf.n_clusters == 16 and rebuilt.pq.n_codes == 32
        assert not np.array_equal(rebuilt.pq.centroids, old.pq.centroids)
        assert httpd.reloads == 2
        stats = json.loads(urllib.request.urlopen(f"{url}/statsz").read())
        assert stats["mode"] == "ivf:16:nprobe=4+pq:S=4:oversample=8"
        assert stats["resident_bytes_per_item"] == 4 * D + 4 + 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("r8", [False, True])
def test_pq_growth_matches_fresh_service_and_jax(catalog, r8):
    ids, vecs, q, paths = catalog
    n0 = 1500
    kw = dict(pq_subspaces=4, pq_codes=32, pq_oversample=8,
              rescore_int8=r8, **KW)
    book = tserver.PQCodebook.load(paths["pq"])
    base = book._replace(codes=book.codes[:n0], n_items=n0)
    t = tserver.RetrievalService(
        EmbeddingIndex(ids[:n0], vecs[:n0]), device="cpu", add_capacity=600,
        pq_warm_from=base, **kw)
    ptrs = {n: getattr(t, n).data_ptr() for n in ("_pq_codes", "_q_items",
                                                  "_items")
            if getattr(t, n) is not None}
    j_path = os.path.join(paths["root"], f"grow{int(r8)}.npz")
    JaxPQ(*base).save(j_path)
    j = jserver.RetrievalService(JaxIndex(ids[:n0], vecs[:n0]),
                                 add_capacity=600, pq_index_path=j_path,
                                 **kw)
    for a, b in ((1500, 1700), (1700, 1950), (1950, 2000)):
        assert t.add_items(ids[a:b], vecs[a:b]) == j.add_items(
            ids[a:b], vecs[a:b]) == b
    assert {n: getattr(t, n).data_ptr() for n in ptrs} == ptrs
    np.testing.assert_array_equal(t.pq.codes, j.pq.codes)
    assert t.pq.n_items == 2000 and len(t.pq.codes) == 2000
    got = t.topk(q, k=20)
    _same(got, j.topk(q, k=20))
    fresh = tserver.RetrievalService(EmbeddingIndex(ids, vecs), device="cpu",
                                     add_capacity=100, pq_warm_from=base,
                                     **kw)
    _same(got, fresh.topk(q, k=20), rtol=1e-6)


def test_cli_flags_reach_serve_as_the_references(monkeypatch):
    argv = ["--index", "x.npz", "--ivf_clusters", "64", "--nprobe", "16",
            "--ivf_iters", "7", "--build_train_sample", "5000",
            "--ivf_max_cell", "300", "--ivf_index", "ivf.npz",
            "--pq_subspaces", "8", "--pq_codes", "128", "--pq_iters", "9",
            "--pq_oversample", "32", "--pq_rotate", "--pq_anisotropic", "0.3",
            "--pq_index", "pq.npz", "--rescore_int8"]
    seen = {}

    class _Stub:
        def serve_forever(self):
            pass

    def capture(name):
        def fake(index, *args, **kw):
            seen[name] = kw
            return _Stub()
        return fake

    monkeypatch.setattr(tserver, "serve", capture("port"))
    monkeypatch.setattr(jserver, "serve", capture("jax"))
    tserver.main(argv + ["--device", "cpu"])
    jserver.main(argv)
    keys = ("ivf_clusters", "nprobe", "ivf_iters", "build_train_sample",
            "ivf_max_cell", "ivf_index_path", "pq_subspaces", "pq_codes",
            "pq_iters", "pq_oversample", "pq_rotate", "pq_anisotropic",
            "pq_index_path", "rescore_int8")
    assert {k: seen["port"][k] for k in keys} == \
        {k: seen["jax"][k] for k in keys}
    assert seen["port"]["pq_anisotropic"] == 0.3
    tserver.main(["--index", "x.npz", "--device", "cpu"])
    off = {k: seen["port"][k] for k in keys}
    assert off["ivf_clusters"] is None and off["pq_subspaces"] is None
    assert off["ivf_index_path"] is None and off["pq_anisotropic"] is None


def test_quality_study_matches_the_references_at_tiny_size(tmp_path):
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for kind in ("clustered", "isotropic", "correlated"):
        t = trqs.synth_catalog(kind, 300, 8, 16, rng_t, components=32)
        j = jrqs.synth_catalog(kind, 300, 8, 16, rng_j, components=32)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    argv = ["--n_items", "3000", "--dim", "16", "--n_queries", "16",
            "--n_clusters", "16", "--kmeans_iters", "3", "--nprobes", "1,16",
            "--pq_subspaces", "4", "--pq_iters", "3",
            "--pq_oversamples", "4,64", "--ivfpq", "--regimes", "clustered"]
    out = trqs.main(argv + ["--device", "cpu",
                            "--out", str(tmp_path / "t.json")])
    with open(tmp_path / "t.json") as f:
        assert json.load(f) == out
    assert out["device"] == "cpu" and out["card"] is None
    jrqs.main(argv + ["--out", str(tmp_path / "j.json")])
    with open(tmp_path / "j.json") as f:
        ref = json.load(f)
    got, want = out["clustered"], ref["clustered"]
    assert set(got) == set(want)
    for sec in ("ivf", "pq", "ivfpq"):
        assert set(got[sec]) == set(want[sec]), sec
    assert got["int8_fullscan"] == want["int8_fullscan"]
    # every cell probed recovers the exact answer in both packages
    for sec in ("ivf", "ivfpq"):
        assert got[sec]["curve"][-1]["recall@100"] == 1.0 == \
            want[sec]["curve"][-1]["recall@100"]
    for row in got["pq"]["rescored_curve"] + [got["pq"]["raw_adc"]]:
        assert 0.0 <= row["overlap@10"] <= 1.0
    assert [r["candidates_rescored"] for r in got["pq"]["rescored_curve"]] \
        == [r["candidates_rescored"] for r in want["pq"]["rescored_curve"]]
    with pytest.raises(SystemExit):
        trqs.main(["--ivfpq", "--device", "cpu"])


def test_deploy_cycles_into_a_live_ivf_pq_server(tmp_path):
    """full_scale_run's deploy cycles with the IVF/PQ flags, reloading a
    live ivf_pq server with aux "reuse": each generation keeps the first
    one's centroids and codebook, and the live answers reach the
    reference's recall target."""
    from esrecsys_tpu_torch.tools import full_scale_run as tfsr

    out = tfsr.main(["--out_dir", str(tmp_path), "--device", "cpu",
                     "--corpus_size", "3000", "--num_albums_raw", "1000",
                     "--album_buckets", "400", "--num_artists", "200",
                     "--train", "--steps", "4", "--batch_size", "16",
                     "--max_next", "8", "--eval_every", "4",
                     "--eval_playlists", "16", "--deploy_cycles", "2",
                     "--cycle_steps", "2", "--deploy_serve_mode", "ivf_pq",
                     "--deploy_reload_aux", "reuse", "--ivf_clusters", "16",
                     "--nprobe", "16", "--ivf_iters", "2",
                     "--pq_subspaces", "4", "--pq_oversample", "64",
                     "--build_train_sample", "2000",
                     "--deploy_quality_queries", "8",
                     "--deploy_quality_k", "20"])
    assert out["deploy_serve_mode"] == "ivf_pq"
    assert out["deploy_reload_aux"] == "reuse"
    assert [c["cycle"] for c in out["deploy_cycles"]] == [1, 2]
    for c in out["deploy_cycles"]:
        assert c["probe_hit"] is True and c["overlap_at_k"] >= 0.95
    run = tfsr.TrainRunConfig(out_dir="x", ivf_clusters=16, nprobe=16,
                              pq_subspaces=4, build_train_sample=2000)
    assert tsb.mode_kwargs("ivf_pq_r8", run) == jsb.mode_kwargs(
        "ivf_pq_r8", run)
