"""The port's retrieval auto-tuner (``esrecsys_tpu_torch/tools/
retrieval_autotune.py``) against the JAX package's, on
``tests/test_autotune.py``'s clustered catalog.

Both tuners calibrate the same queries against the exact top-k. The IVF
index and the PQ codebook are the JAX package's builds, passed to the
port's tuner through the npz format both packages read (the k-means
inits come from each package's own generator, so their builds differ).

Tolerances: the same (mode, knob) rows are tried; the exact and int8
rows' recalls are equal outright (float32 scores, int8 dots exact in
both); every other recall within 2 / (n_queries * k), two boundary items
(bf16 scores or float32 sums in another order can flip an item at the
k-th place); the recommendation is equal where no row lies within that
tolerance of the target.
"""

import numpy as np
import pytest

from esrecsys_tpu.retrieval.ivf import IVFIndex as JIVFIndex
from esrecsys_tpu.retrieval.pq import PQCodebook as JPQCodebook
from esrecsys_tpu.tools.retrieval_autotune import autotune as jautotune
from esrecsys_tpu_torch.retrieval.ivf import IVFIndex
from esrecsys_tpu_torch.retrieval.pq import PQCodebook
from esrecsys_tpu_torch.tools import retrieval_autotune as tra

KW = dict(target_recall=0.9, k=10, nprobes=(1, 4, 16), oversamples=(4, 16, 64),
          ivf_clusters=16, pq_subspaces=4, build_iters=5,
          fused_bins_sweep=(512,))
N_QUERIES = 48
TOL = 2 / (N_QUERIES * KW["k"])


@pytest.fixture(scope="module")
def catalog():
    rng = np.random.default_rng(0)
    n_comp, d = 32, 16
    means = rng.normal(size=(n_comp, d)).astype(np.float32) * 3.0
    comp = rng.integers(0, n_comp, 3000)
    vecs = (means[comp]
            + rng.normal(size=(3000, d)).astype(np.float32) * 0.3)
    queries = vecs[rng.choice(3000, N_QUERIES, replace=False)] \
        + 0.1 * rng.normal(size=(N_QUERIES, d)).astype(np.float32)
    return vecs.astype(np.float32), queries.astype(np.float32)


@pytest.fixture(scope="module")
def jax_structures(catalog, tmp_path_factory):
    """The JAX tuner's own IVF and PQ builds (its arguments for them),
    saved as npz and loaded by the port."""
    import jax.numpy as jnp

    vecs, _ = catalog
    items = jnp.asarray(vecs)
    tmp = tmp_path_factory.mktemp("structures")
    JIVFIndex.build(items, KW["ivf_clusters"], iters=KW["build_iters"],
                    max_cell=None, train_sample=None).save(
        str(tmp / "ivf.npz"))
    JPQCodebook.build(items, KW["pq_subspaces"],
                      iters=max(KW["build_iters"], 15), rotate=False,
                      anisotropic_threshold=None, train_sample=None).save(
        str(tmp / "pq.npz"))
    return (IVFIndex.load(str(tmp / "ivf.npz")),
            PQCodebook.load(str(tmp / "pq.npz")))


@pytest.fixture(scope="module")
def both(catalog, jax_structures):
    vecs, queries = catalog
    ivf, book = jax_structures
    return (jautotune(vecs, queries, **KW),
            tra.autotune(vecs, queries, **KW, device="cpu", ivf_index=ivf,
                         pq_book=book))


def test_the_same_rows_are_tried(both):
    jres, tres = both
    assert [(c["mode"], c["knob"]) for c in tres["all_configs"]] == \
        [(c["mode"], c["knob"]) for c in jres["all_configs"]]
    for key in ("n_items", "dim", "k", "target_recall", "n_queries",
                "ranked_by"):
        assert tres[key] == jres[key], key


def test_recalls_agree(both):
    jres, tres = both
    for j, t in zip(jres["all_configs"], tres["all_configs"]):
        if j["mode"] in ("exact", "int8"):
            assert t["recall"] == j["recall"], (j, t)
        else:
            assert abs(t["recall"] - j["recall"]) <= TOL + 1e-9, (j, t)
        for key in ("scan_bytes_per_query", "resident_bytes_per_item",
                    "kwargs", "flags"):
            assert t[key] == j[key], (key, j, t)


def test_recommendation_agrees(both):
    jres, tres = both
    near = [c for c in jres["all_configs"]
            if abs(c["recall"] - KW["target_recall"]) <= TOL]
    if not near:
        assert (tres["recommended"]["mode"], tres["recommended"]["knob"]) \
            == (jres["recommended"]["mode"], jres["recommended"]["knob"])
        assert [(c["mode"], c["knob"]) for c in tres["feasible"]] == \
            [(c["mode"], c["knob"]) for c in jres["feasible"]]
    assert all("_fn" not in c for c in tres["all_configs"])


def test_measure_throughput_ranks_by_measured_qps(catalog):
    vecs, queries = catalog
    out = tra.autotune(vecs, queries, target_recall=0.9, k=10,
                       nprobes=(16,), oversamples=(64,), ivf_clusters=16,
                       pq_subspaces=4, build_iters=3,
                       fused_bins_sweep=(512,), measure_throughput=True,
                       device="cpu")
    assert out["ranked_by"] == "measured_queries_per_s"
    qps = [c["queries_per_s"] for c in out["feasible"]]
    assert qps and all(q > 0 for q in qps)
    assert qps == sorted(qps, reverse=True)
    assert out["recommended"]["queries_per_s"] == qps[0]
    assert set(out["build_seconds"]) == {"ground_truth", "ivf_build",
                                         "pq_build"}


def test_fused_rows_check_the_kernel_dims(catalog, monkeypatch):
    """Each fused row asks serving's check for its bins at the catalog's
    dim on the tuner's device. On a card every positive dim is accepted
    (the generic kernel runs the dims the tuned one lacks); a bin count
    below 1 raises there, as fused serving does."""
    from esrecsys_tpu_torch.retrieval import fused

    seen = []
    real = fused.validate_fused_bins

    def spy(bins, dim, *a, device=None, **k):
        seen.append((bins, dim, str(device)))
        return real(bins, dim, *a, device=device, **k)

    monkeypatch.setattr(fused, "validate_fused_bins", spy)
    vecs, queries = catalog
    tra.autotune(vecs[:, :12], queries[:, :12], target_recall=1.01, k=10,
                 nprobes=(1,), oversamples=(4,), ivf_clusters=16,
                 pq_subspaces=4, build_iters=2, fused_bins_sweep=(512, 1024),
                 device="cpu")
    assert seen == [(512, 12, "cpu"), (1024, 12, "cpu")]
    real(512, 12, device="cuda")
    with pytest.raises(ValueError, match="positive"):
        real(0, 12, device="cuda")


def test_entry_point_needs_a_card_unless_asked(catalog):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    vecs, queries = catalog
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tra.autotune(vecs, queries, 0.9)


def test_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "tune.json"
    tra.main(["--device", "cpu", "--n_items", "2000", "--dim", "16",
              "--n_queries", "32", "--k", "10", "--nprobes", "4,16",
              "--oversamples", "16", "--fused_bins_sweep", "512",
              "--ivf_clusters", "16", "--pq_subspaces", "4",
              "--build_iters", "3", "--out", str(out)])
    import json

    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["recommended"] and "serve_flags" in line
    saved = json.loads(out.read_text())
    assert saved["recommended"]["mode"] == line["recommended"]
