"""The port's IVF retrieval (``esrecsys_tpu_torch/retrieval/ivf.py``)
against the JAX package's, on the CPU at a small size (a mixture catalog
of 3,200 x 16, 32 cells).

Tolerances:
  * ``kmeans_assign``: equal assignments, except rows whose two best
    distances lie within 1e-5 relative (the two packages' float32 matmuls
    sum in different orders); none occur on these catalogs.
  * Lloyd iterations from the rows JAX's own key draws: centroids within
    1e-5 (float32 cell sums in another order).
  * ``_assemble_cells`` and ``_split_to_cap`` are host numpy in both: the
    same assignments give identical tables.
  * ``ivf_topk`` and ``ivf_pq_topk`` on a JAX-built index: ids equal (ties
    to the lower candidate position in both), scores within 1e-5 relative.
  * An index saved by either package loads in the other unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import ivf as jivf
from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu.retrieval import pq as jpq
from esrecsys_tpu_torch.retrieval import ivf as tivf
from esrecsys_tpu_torch.retrieval import mips as tmips

RTOL = 1e-5
D = 16


def _mixture(rng, n_comp=16, per=200, d=D, spread=0.15):
    means = rng.normal(size=(n_comp, d)).astype(np.float32) * 3.0
    comp = np.repeat(np.arange(n_comp), per)
    x = means[comp] + rng.normal(size=(n_comp * per, d)).astype(
        np.float32) * spread
    return x.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same_topk(t, j):
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=RTOL,
                               atol=1e-6)


def _assign_equal_off_near_ties(x, cent, got, want):
    d = (np.sum(cent.astype(np.float64) ** 2, 1)[None, :]
         - 2.0 * x.astype(np.float64) @ cent.astype(np.float64).T)
    two = np.sort(d, axis=1)[:, :2]
    near = np.abs(two[:, 1] - two[:, 0]) <= 1e-5 * np.abs(two).max(1)
    assert np.array_equal(got[~near], want[~near])
    return int(near.sum())


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = _mixture(rng)
    index = jivf.IVFIndex.build(x, 32, iters=8, max_cell=160)
    q = (x[rng.integers(0, len(x), 6)]
         + rng.normal(size=(6, D)).astype(np.float32) * 0.3)
    return x, index, q


def test_kmeans_assign_matches_jax(data):
    x, index, _ = data
    rng = np.random.default_rng(1)
    cent = rng.normal(size=(40, D)).astype(np.float32) * 2.0
    want = np.asarray(jivf.kmeans_assign(jnp.asarray(x), jnp.asarray(cent)))
    for block in (65_536, 1000):   # a ragged last block too
        got = tivf.kmeans_assign(_t(x), _t(cent), block_size=block).numpy()
        assert _assign_equal_off_near_ties(x, cent, got, want) == 0


def _min_gap(x, cent) -> float:
    """Smallest relative gap between a row's two best distances."""
    d = (np.sum(cent.astype(np.float64) ** 2, 1)[None, :]
         - 2.0 * x.astype(np.float64) @ cent.astype(np.float64).T)
    two = np.sort(d, axis=1)[:, :2]
    return float((np.abs(two[:, 1] - two[:, 0]) / np.abs(two).max(1)).min())


@pytest.mark.parametrize("train_sample", [None, 1000])
def test_lloyd_from_jax_init_rows_matches_kmeans(train_sample):
    """The rows JAX's key draws (the reference's own recipe, rebuilt here
    with jax.random) fed to the port's Lloyd iterations. A row whose two
    best distances come within float32 rounding of each other may take
    either cell in either package and move a centroid by far more than
    1e-5, so the catalog is one whose gaps stay over 1e-5 relative at
    every iteration of JAX's trajectory (asserted): 16 components in 4
    cells, which splits no component."""
    rng = np.random.default_rng(0)
    x = _mixture(rng, n_comp=16, per=200, spread=0.1)
    C, iters, seed = 4, 6, 3
    for it in range(iters + 1):
        jc, ja = jivf.kmeans(jnp.asarray(x), C, it, seed,
                             train_sample=train_sample)
        assert _min_gap(x, np.asarray(jc)) > 1e-5, it
    key = jax.random.PRNGKey(seed)
    train = x
    if train_sample is not None:
        key, sk = jax.random.split(key)
        rows = np.asarray(jax.random.choice(sk, len(x), (train_sample,),
                                            replace=False))
        train = x[rows]
    init = np.asarray(jax.random.choice(key, len(train), (C,),
                                        replace=False))
    cent = tivf.lloyd(_t(train), _t(train[init]), iters)
    np.testing.assert_allclose(cent.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5)
    got = tivf.kmeans_assign(_t(x), cent).numpy()
    assert _assign_equal_off_near_ties(x, np.asarray(jc), got,
                                       np.asarray(ja)) == 0


@pytest.mark.parametrize("C", [24, 40])
def test_lloyd_assignments_match_jax_off_near_ties(data, C):
    """On the default catalog, where cells split components and rows sit
    on cell borders, one Lloyd step from the same centroids gives the
    same assignments except at near-ties, and centroids within 1e-5 in
    every cell no near-tie row touches."""
    x, _, _ = data
    jc0, _ = jivf.kmeans(jnp.asarray(x), C, 3, 1)
    jc0 = np.asarray(jc0)
    # one step from jc0 on both sides
    want_a = np.asarray(jivf.kmeans_assign(jnp.asarray(x),
                                           jnp.asarray(jc0)))
    got_a = tivf.kmeans_assign(_t(x), _t(jc0)).numpy()
    _assign_equal_off_near_ties(x, jc0, got_a, want_a)
    got_c = tivf.lloyd(_t(x), _t(jc0), 1).numpy()
    sums = np.zeros_like(jc0, dtype=np.float64)
    np.add.at(sums, want_a, x.astype(np.float64))
    cnt = np.bincount(want_a, minlength=C)
    want_c = np.where(cnt[:, None] > 0, sums / np.maximum(cnt, 1)[:, None],
                      jc0)
    moved = np.unique(np.concatenate([got_a[got_a != want_a],
                                      want_a[got_a != want_a]]))
    keep = np.setdiff1d(np.arange(C), moved)
    np.testing.assert_allclose(got_c[keep], want_c[keep], rtol=0, atol=1e-5)


def test_lloyd_keeps_empty_cells_and_kmeans_is_seeded():
    x = np.repeat(np.eye(4, dtype=np.float32), 3, axis=0)  # 4 distinct rows
    cent0 = np.concatenate([np.eye(4), np.full((4, 4), 9.0)]).astype(
        np.float32)
    cent = tivf.lloyd(_t(x), _t(cent0), 3)
    np.testing.assert_array_equal(cent.numpy(), cent0)  # empty cells kept
    rng = np.random.default_rng(2)
    y = _mixture(rng, n_comp=4, per=50)
    a = tivf.kmeans(_t(y), 8, 4, seed=5)
    b = tivf.kmeans(_t(y), 8, 4, seed=5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="n_clusters"):
        tivf.kmeans(_t(y[:5]), 8)
    with pytest.raises(ValueError, match="train_sample"):
        tivf.kmeans(_t(y), 8, train_sample=4)


def test_assemble_cells_and_split_to_cap_are_the_references(data):
    x, index, _ = data
    a = np.asarray(jivf.kmeans_assign(jnp.asarray(x),
                                      jnp.asarray(index.centroids[:32])))
    for max_cell in (None, 90, 1):
        want = jivf._assemble_cells(list(index.centroids[:32]), a, x,
                                    max_cell)
        for vectors in (x, _t(x)):  # host rows, and rows on the device
            got = tivf._assemble_cells(list(index.centroids[:32]), a,
                                       vectors, max_cell)
            np.testing.assert_array_equal(got.bucket_ids, want.bucket_ids)
            np.testing.assert_array_equal(got.centroids, want.centroids)
            assert got.n_items == want.n_items == len(x)
    ids = np.arange(50, 250)
    rows = x[ids].astype(np.float64)
    for cap in (7, 64):
        got = tivf._split_to_cap(ids, rows, cap)
        want = jivf._split_to_cap(ids, rows, cap)
        assert len(got) == len(want)
        for (gi, gc), (wi, wc) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gc, wc)
    with pytest.raises(ValueError, match="max_cell"):
        tivf._assemble_cells(list(index.centroids[:32]), a, x, 0)


def test_build_covers_every_item_once_and_caps_cells():
    rng = np.random.default_rng(3)
    x = _mixture(rng, n_comp=8, per=60)
    for max_cell in (None, 40):
        idx = tivf.IVFIndex.build(x, 8, iters=5, max_cell=max_cell,
                                  device="cpu")
        got = idx.bucket_ids[idx.bucket_ids >= 0]
        assert sorted(got.tolist()) == list(range(len(x)))
        assert idx.n_items == len(x) and idx.imbalance >= 1.0
        assert idx.centroids.dtype == np.float32
        assert idx.bucket_ids.dtype == np.int32
        if max_cell:
            assert idx.bucket_ids.shape[1] <= max_cell
    sampled = tivf.IVFIndex.build(_t(x), 8, iters=5, train_sample=200)
    assert sorted(sampled.bucket_ids[sampled.bucket_ids >= 0].tolist()) == \
        list(range(len(x)))


def _ivf_args(index, x):
    return (_t(index.centroids), _t(index.bucket_ids), _t(x))


def _jivf_args(index, x):
    return (jnp.asarray(index.centroids), jnp.asarray(index.bucket_ids),
            jnp.asarray(x))


@pytest.mark.parametrize("variant", ["f32", "int8", "int8_r8", "mask",
                                     "k_past_candidates", "full_probe"])
def test_ivf_topk_matches_jax(data, variant):
    x, index, q = data
    k, nprobe = 20, 4
    jq8, jsc = jmips.quantize_rows(jnp.asarray(x))
    tq8, tsc = tmips.quantize_rows(_t(x))
    assert np.array_equal(tq8.numpy(), np.asarray(jq8))
    jc, jb, jx = _jivf_args(index, x)
    tc, tb, tx = _ivf_args(index, x)
    jkw, tkw = {}, {}
    if variant == "int8":
        jkw, tkw = (dict(q_items=jq8, item_scales=jsc),
                    dict(q_items=tq8, item_scales=tsc))
    elif variant == "int8_r8":
        jx, tx = jq8, tq8
        jkw = dict(q_items=jq8, item_scales=jsc, rescore_scales=jsc)
        tkw = dict(q_items=tq8, item_scales=tsc, rescore_scales=tsc)
    elif variant == "mask":
        mask = np.random.default_rng(4).random(len(x)) > 0.5
        jkw, tkw = dict(item_mask=jnp.asarray(mask)), dict(item_mask=_t(mask))
    elif variant == "k_past_candidates":
        k, nprobe = 2 * index.bucket_ids.shape[1] + 5, 1
    elif variant == "full_probe":
        nprobe = index.n_clusters
    want = jivf.ivf_topk(jnp.asarray(q), jc, jb, jx, k, nprobe, **jkw)
    got = tivf.ivf_topk(_t(q), tc, tb, tx, k, nprobe, **tkw)
    assert got[0].shape == (len(q), k) and got[1].dtype == torch.int64
    _same_topk(got, want)
    if variant == "k_past_candidates":
        assert np.isneginf(got[0].numpy()[:, index.bucket_ids.shape[1]:]).all()
    if variant == "full_probe":
        # every cell probed: the exact answer
        exact = tmips.topk_over_matrix(_t(q), _t(x), k)
        assert torch.equal(got[1], exact[1])
        torch.testing.assert_close(got[0], exact[0], rtol=RTOL, atol=1e-6)


def test_ivf_topk_chunks_the_query_batch(data, monkeypatch):
    """A gather budget of one query per chunk gives the same ids, and
    scores within float32 rounding (a batched product may sum another way
    at another batch size)."""
    x, index, q = data
    whole = tivf.ivf_topk(_t(q), *_ivf_args(index, x), 20, 4)
    monkeypatch.setattr(tivf, "GATHER_BYTES", 1)
    assert len(tivf._chunks(len(q), 4 * index.bucket_ids.shape[1], D)) == \
        len(q)
    chunked = tivf.ivf_topk(_t(q), *_ivf_args(index, x), 20, 4)
    assert torch.equal(whole[1], chunked[1])
    torch.testing.assert_close(whole[0], chunked[0], rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def book(data):
    x, _, _ = data
    return {rot: jpq.PQCodebook.build(x, 4, n_codes=32, iters=6, rotate=rot)
            for rot in (False, True)}


@pytest.mark.parametrize("variant", ["plain", "rotation", "r8", "mask",
                                     "full"])
def test_ivf_pq_topk_matches_jax(data, book, variant):
    x, index, q = data
    b = book[variant == "rotation"]
    k, nprobe, over = 10, 4, 3
    jc, jb, jx = _jivf_args(index, x)
    tc, tb, tx = _ivf_args(index, x)
    jkw = dict(pq_centroids=jnp.asarray(b.centroids),
               pq_codes=jnp.asarray(b.codes))
    tkw = dict(pq_centroids=_t(b.centroids), pq_codes=_t(b.codes))
    if b.rotation is not None:
        jkw["rotation"], tkw["rotation"] = (jnp.asarray(b.rotation),
                                            _t(b.rotation))
    if variant == "r8":
        jq8, jsc = jmips.quantize_rows(jnp.asarray(x))
        tq8, tsc = tmips.quantize_rows(_t(x))
        jx, tx = jq8, tq8
        jkw["item_scales"], tkw["item_scales"] = jsc, tsc
    elif variant == "mask":
        mask = np.random.default_rng(5).random(len(x)) > 0.3
        jkw["item_mask"], tkw["item_mask"] = jnp.asarray(mask), _t(mask)
    elif variant == "full":
        # every cell probed and every candidate rescored: exact
        nprobe = index.n_clusters
        over = -(-nprobe * index.bucket_ids.shape[1] // k)
    want = jivf.ivf_pq_topk(jnp.asarray(q), jc, jb, jx, k, nprobe,
                            oversample=over, **jkw)
    got = tivf.ivf_pq_topk(_t(q), tc, tb, tx, k, nprobe, oversample=over,
                           **tkw)
    _same_topk(got, want)
    if variant == "full":
        exact = tmips.topk_over_matrix(_t(q), _t(x), k)
        assert torch.equal(got[1], exact[1])


def test_reassign_matches_jax_and_checks_dim(data):
    x, index, _ = data
    rng = np.random.default_rng(6)
    drifted = x + rng.normal(size=x.shape).astype(np.float32) * 0.05
    t_index = tivf.IVFIndex(*index)   # a JAX-built index carried across
    for max_cell in (None, 120):
        want = index.reassign(drifted, max_cell=max_cell)
        got = t_index.reassign(drifted, max_cell=max_cell, device="cpu")
        np.testing.assert_array_equal(got.bucket_ids, want.bucket_ids)
        np.testing.assert_array_equal(got.centroids, want.centroids)
        assert got.n_items == want.n_items
    with pytest.raises(ValueError, match="dim"):
        t_index.reassign(drifted[:, :8], device="cpu")


def test_index_files_cross_between_packages(data, tmp_path):
    x, index, q = data
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    index.save(jpath)
    t_loaded = tivf.IVFIndex.load(jpath)
    t_built = tivf.IVFIndex.build(x, 16, iters=4, device="cpu")
    t_built.save(tpath)
    j_loaded = jivf.IVFIndex.load(tpath)
    for a, b in ((t_loaded, index), (j_loaded, t_built)):
        np.testing.assert_array_equal(a.centroids, b.centroids)
        np.testing.assert_array_equal(a.bucket_ids, b.bucket_ids)
        assert a.n_items == b.n_items and a.n_clusters == b.n_clusters
        assert a.imbalance == pytest.approx(b.imbalance)
    # the port's index answers in JAX as in the port
    want = jivf.ivf_topk(jnp.asarray(q), *_jivf_args(j_loaded, x), 10, 3)
    got = tivf.ivf_topk(_t(q), *_ivf_args(t_built, x), 10, 3)
    _same_topk(got, want)
