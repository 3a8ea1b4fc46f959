"""The port's ``tools/serving_bench.py`` and the deploy cycles of
``tools/full_scale_run.py`` against the JAX package's, on the CPU at a
small size.

Tolerances: ``mode_kwargs`` equals the reference's dict for every mode.
Per mode the bench's answers are the JAX bench's answers on the same
catalog and queries (ids identical), except in the approx modes, where
the port bins and the CPU's JAX selects exactly: there overlap@k against
the JAX answers is at least 0.95. Overlap against exact is at least the
reference's smoke floor, 0.8. The deploy cycles' index generations load
in the JAX package bit for bit, and their live answers reach the
reference's recall target (overlap@k at least 0.95; 1.0 in the exact
mode).
"""

import argparse
import json
import os

import numpy as np
import pytest

from esrecsys_tpu.retrieval.index import EmbeddingIndex as JaxIndex
from esrecsys_tpu.tools import serving_bench as jsb
from esrecsys_tpu_torch.retrieval.index import EmbeddingIndex
from esrecsys_tpu_torch.tools import full_scale_run as tfsr
from esrecsys_tpu_torch.tools import serving_bench as tsb

# the full-scan modes, whose answers equal the JAX bench's; the IVF and
# PQ modes train their structures from seeds the two packages draw apart
# (tests/test_torch_serving_ivfpq.py holds them to JAX on shared ones)
PORTED = ("exact", "approx", "fused", "fused_q8", "fused_q8_r8",
          "quantized", "quantized_approx", "quantized_r8", "filtered")
UNPORTED = {"ivf": "ivf_clusters", "ivf_quantized": "ivf_clusters",
            "pq": "pq_subspaces", "ivf_pq": "ivf_clusters",
            "pq_r8": "pq_subspaces", "ivf_pq_r8": "ivf_clusters"}


def _args(**kw):
    base = dict(batch=16, reps=1, overlap_queries=32, recall_target=0.95,
                fused_bins=128, ivf_clusters=16, nprobe=4, ivf_iters=3,
                pq_subspaces=4, pq_oversample=8, pq_rotate=False,
                pq_anisotropic=0.0, ivf_max_cell=0, build_train_sample=0,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_modes_and_mode_kwargs_are_the_references():
    assert tsb.MODES == jsb.MODES
    assert set(PORTED) | set(UNPORTED) == set(tsb.MODES)
    args = _args(ivf_max_cell=64, build_train_sample=512,
                 pq_anisotropic=0.2)
    for mode in tsb.MODES:
        assert tsb.mode_kwargs(mode, args) == jsb.mode_kwargs(mode, args), \
            mode
    # an object without the IVF/PQ knobs takes the bench's defaults
    bare = argparse.Namespace(recall_target=0.9)
    assert tsb.mode_kwargs("approx", bare) == {"approx": True,
                                               "recall_target": 0.9}
    assert tsb.mode_kwargs("ivf", bare)["ivf_clusters"] == 4096


@pytest.fixture(scope="module")
def bench_data():
    vecs = jsb.make_catalog(2000, 16, structured=True)
    np.testing.assert_array_equal(
        vecs, tsb.make_catalog(2000, 16, structured=True))
    ids = [str(i) for i in range(2000)]
    rng = np.random.default_rng(99)
    queries = (vecs[rng.integers(0, 2000, 32)]
               + rng.normal(size=(32, 16)).astype(np.float32) * 0.1)
    return ids, vecs, queries


def test_bench_modes_match_jax(bench_data):
    ids, vecs, queries = bench_data
    args = _args()
    t_index, j_index = EmbeddingIndex(ids, vecs), JaxIndex(ids, vecs)
    t_exact = j_exact = None
    for mode in PORTED:
        t_res, t_ids = tsb.bench_mode(mode, t_index, queries, 10, args,
                                      t_exact, vecs=vecs)
        j_res, j_ids = jsb.bench_mode(mode, j_index, queries, 10, args,
                                      j_exact, vecs=vecs)
        if mode == "exact":
            t_exact, j_exact = t_ids, j_ids
            assert t_res["overlap_vs_exact"] is None
        else:
            assert t_res["overlap_vs_exact"] >= 0.8, t_res
        assert t_res["resident_bytes_per_item"] == \
            j_res["resident_bytes_per_item"], mode
        assert t_res["queries_per_s"] > 0 and t_res["setup_s"] >= 0
        if "approx" in mode:
            overlap = np.mean([len(set(t_ids[b]) & set(j_ids[b])) / 10
                               for b in range(len(queries))])
            assert overlap >= 0.95, (mode, overlap)
        else:
            np.testing.assert_array_equal(t_ids, j_ids, err_msg=mode)


def test_serving_bench_smoke(tmp_path):
    """The reference's smoke (tests/test_tools.py) on the port, over every
    ported mode, writing its JSON."""
    out = str(tmp_path / "sb.json")
    res = tsb.main(["--items", "2000", "--dim", "16", "--queries", "32",
                    "--batch", "16", "--k", "10", "--reps", "1",
                    "--structured", "--fused_bins", "128", "--device", "cpu",
                    "--modes", ",".join(reversed(PORTED)), "--out", out])
    with open(out) as f:
        d = json.load(f)
    assert d == res and d["card"] is None and d["device"] == "cpu"
    modes = [r["mode"] for r in d["results"]]
    assert modes[0] == "exact" and set(modes) == set(PORTED)
    for r in d["results"][1:]:
        assert r["overlap_vs_exact"] >= 0.8, r
        assert set(r) == {"mode", "queries_per_s", "overlap_vs_exact",
                          "setup_s", "resident_bytes_per_item"}


def test_serving_bench_rejects_unknown_mode(tmp_path):
    with pytest.raises(SystemExit, match="unknown modes"):
        tsb.main(["--items", "100", "--dim", "8", "--device", "cpu",
                  "--modes", "exact,bogus", "--out", str(tmp_path / "x")])


@pytest.mark.parametrize("mode", sorted(UNPORTED))
def test_unported_modes_raise_naming_their_option(tmp_path, mode):
    """The IVF and PQ modes, unported before, now run in the bench and
    report the reference's keys: ivf_imbalance and ivf_lmax for the IVF
    modes, pq_bytes_per_item for the PQ ones, and an overlap over the
    reference's smoke floor."""
    res = tsb.main(["--items", "2000", "--dim", "8", "--queries", "16",
                    "--batch", "8", "--k", "10", "--reps", "1",
                    "--structured", "--ivf_clusters", "16", "--nprobe", "8",
                    "--ivf_iters", "3", "--pq_subspaces", "4",
                    "--pq_oversample", "16", "--device", "cpu",
                    "--modes", f"exact,{mode}", "--out",
                    str(tmp_path / "x.json")])
    r = res["results"][1]
    assert r["mode"] == mode and r["overlap_vs_exact"] >= 0.8, r
    keys = {"mode", "queries_per_s", "overlap_vs_exact", "setup_s",
            "resident_bytes_per_item"}
    if UNPORTED[mode] == "ivf_clusters":
        keys |= {"ivf_imbalance", "ivf_lmax"}
        assert r["ivf_imbalance"] >= 1.0 and r["ivf_lmax"] >= 2000 // 16
    if "pq" in mode:
        keys |= {"pq_bytes_per_item"}
        assert r["pq_bytes_per_item"] == 4
    assert set(r) == keys


@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_deploy_cycles_hot_reload_live_server(tmp_path, capsys, mode):
    """The reference's deploy-cycle case (tests/test_full_scale.py) on the
    port: retrain segments export artifacts that go live through
    /admin/reload on a running server, with the per-cycle report."""
    out_dir = tmp_path / mode
    tfsr.main(["--out_dir", str(out_dir), "--device", "cpu",
               "--corpus_size", "3000", "--num_albums_raw", "1000",
               "--album_buckets", "400", "--num_artists", "200",
               "--train", "--steps", "8", "--batch_size", "16",
               "--max_next", "8", "--eval_every", "8",
               "--eval_playlists", "16", "--deploy_cycles", "2",
               "--cycle_steps", "4", "--deploy_serve_mode", mode,
               "--deploy_quality_queries", "8", "--deploy_quality_k", "20"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out_dir / "full_scale_run.json") as f:
        out = json.load(f)
    assert out == printed
    assert out["deploy_serve_mode"] == mode
    assert out["deploy_reload_aux"] == "rebuild"
    assert out["deploy_server_startup_s"] >= 0
    assert out["steps"] == 8 and out["deploy_final_step"] == 16
    cycles = out["deploy_cycles"]
    assert [c["cycle"] for c in cycles] == [1, 2]
    for c in cycles:
        assert c["steps"] == 4 and c["probe_hit"] is True
        assert c["retrain_s"] > 0 and c["reload_s"] > 0
        assert c["artifact_to_live_s"] == pytest.approx(
            c["embed_and_save_s"] + c["reload_s"])
        assert c["overlap_at_k"] >= (1.0 if mode == "exact" else 0.95)
    arts = sorted(os.listdir(out_dir / "artifacts"))
    assert sum(a.startswith("playlist-") for a in arts) >= 3, arts
    # each generation is an index the JAX package reads as it is
    for tag in ("v0", "v1", "v2"):
        path = str(out_dir / f"index_{tag}.npz")
        t, j = EmbeddingIndex.load(path), JaxIndex.load(path)
        assert t.ids == j.ids and len(t) == 3000
        np.testing.assert_array_equal(t.vectors, j.vectors)
    v1 = EmbeddingIndex.load(str(out_dir / "index_v1.npz")).vectors
    v2 = EmbeddingIndex.load(str(out_dir / "index_v2.npz")).vectors
    assert not np.array_equal(v1, v2)   # the retrain moved the catalog


def test_deploy_cycles_need_the_device_feed(tmp_path):
    with pytest.raises(SystemExit, match="deploy_cycles"):
        tfsr.main(["--out_dir", str(tmp_path), "--device", "cpu",
                   "--corpus_size", "3000", "--num_albums_raw", "1000",
                   "--album_buckets", "400", "--num_artists", "200",
                   "--deploy_cycles", "1"])
