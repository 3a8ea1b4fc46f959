"""The port's product quantization (``esrecsys_tpu_torch/retrieval/pq.py``)
against the JAX package's, on the CPU at a small size (2,000-4,000 x 16,
S=4, up to 32 codes).

Tolerances:
  * ``adc_lut``: within 1e-5 (float32 dots of Ds=4 in another order).
  * ``pq_topk`` on a JAX-built codebook, with a float32 or int8 rescore,
    raw ADC, ``valid_count``, ``item_mask`` and a rotation: ids equal (ties
    to the lower position), scores within 1e-5 relative.
  * ``_refine_anisotropic`` from the same init, and ``encode``: codes
    equal, centroids within 1e-5 (the per-centroid solves in float32 in
    another order); ``anisotropic_loss`` within 1e-6 relative.
  * The rotation is numpy's in both packages: bit-equal. A codebook saved
    by either package loads in the other unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu.retrieval import pq as jpq
from esrecsys_tpu_torch.retrieval import mips as tmips
from esrecsys_tpu_torch.retrieval import pq as tpq

RTOL = 1e-5
D, S = 16, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_topk(t, j):
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=RTOL,
                               atol=1e-6)


def _correlated(rng, n=2000, d=D, rank=4, noise=0.1):
    basis = rng.normal(size=(rank, d)).astype(np.float32)
    x = rng.normal(size=(n, rank)).astype(np.float32) @ basis
    return (x + noise * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    means = rng.normal(size=(12, D)).astype(np.float32) * 3.0
    x = (means[rng.integers(0, 12, 3000)]
         + rng.normal(size=(3000, D)).astype(np.float32) * 0.3)
    q = rng.normal(size=(5, D)).astype(np.float32)
    books = {rot: jpq.PQCodebook.build(x, S, n_codes=32, iters=6,
                                       rotate=rot) for rot in (False, True)}
    return x, q, books


def test_adc_lut_matches_jax(data):
    x, q, books = data
    for book in books.values():
        rot = book.rotation
        want = jpq.adc_lut(jnp.asarray(q), jnp.asarray(book.centroids),
                           None if rot is None else jnp.asarray(rot))
        got = tpq.adc_lut(_t(q), _t(book.centroids),
                          None if rot is None else _t(rot))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        assert got.shape == (len(q), S, 32)


@pytest.mark.parametrize("variant", ["rescore", "r8", "raw", "valid_count",
                                     "mask", "rotation", "raw_valid_mask",
                                     "k_past_items"])
def test_pq_topk_matches_jax(data, variant):
    x, q, books = data
    book = books[variant == "rotation"]
    k, block = 20, 1024   # three blocks, the last ragged
    jq8, jsc = jmips.quantize_rows(jnp.asarray(x))
    tq8, tsc = tmips.quantize_rows(_t(x))
    jkw = dict(rescore_items=jnp.asarray(x), block_size=block, oversample=8)
    tkw = dict(rescore_items=_t(x), block_size=block, oversample=8)
    if variant == "r8":
        jkw.update(rescore_items=jq8, rescore_scales=jsc)
        tkw.update(rescore_items=tq8, rescore_scales=tsc)
    if variant.startswith("raw"):
        jkw["rescore_items"] = tkw["rescore_items"] = None
    if variant in ("valid_count", "raw_valid_mask"):
        jkw["valid_count"] = tkw["valid_count"] = 2500
    if variant in ("mask", "raw_valid_mask"):
        mask = np.random.default_rng(1).random(len(x)) > 0.4
        jkw["item_mask"], tkw["item_mask"] = jnp.asarray(mask), _t(mask)
    if variant == "rotation":
        jkw["rotation"], tkw["rotation"] = (jnp.asarray(book.rotation),
                                            _t(book.rotation))
    if variant == "k_past_items":
        k = 40
        jkw["valid_count"] = tkw["valid_count"] = 30
    want = jpq.pq_topk(jnp.asarray(q), jnp.asarray(book.centroids),
                       jnp.asarray(book.codes), k, **jkw)
    got = tpq.pq_topk(_t(q), _t(book.centroids), _t(book.codes), k, **tkw)
    assert got[0].shape == (len(q), k) and got[1].dtype == torch.int64
    _same_topk(got, want)
    if "valid" in variant or variant == "k_past_items":
        bound = 30 if variant == "k_past_items" else 2500
        fin = torch.isfinite(got[0])
        assert bool((got[1][fin] < bound).all())
        assert bool((got[1][~fin] == 0).all())


def test_pq_topk_every_candidate_rescored_is_exact(data):
    x, q, books = data
    book = books[False]
    got = tpq.pq_topk(_t(q), _t(book.centroids), _t(book.codes), 10,
                      rescore_items=_t(x), block_size=512, per_block_k=512)
    exact = tmips.topk_over_matrix(_t(q), _t(x), 10)
    assert torch.equal(got[1], exact[1])
    torch.testing.assert_close(got[0], exact[0], rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="query dim"):
        tpq.pq_topk(_t(q[:, :8]), _t(book.centroids), _t(book.codes), 10)


def test_build_rotation_is_the_references_and_codes_are_consistent(data):
    x, _, books = data
    t = tpq.PQCodebook.build(x, S, n_codes=32, iters=6, rotate=True,
                             device="cpu")
    np.testing.assert_array_equal(t.rotation, books[True].rotation)
    assert t.centroids.shape == (S, 32, D // S) and t.codes.dtype == np.uint8
    assert t.n_items == len(x) and t.bytes_per_item == S
    # every code is its row's nearest centroid in the rotated space
    xr = x @ t.rotation
    for s in range(S):
        sub = xr[:, s * 4:(s + 1) * 4]
        d = ((sub[:, None, :] - t.centroids[s][None]) ** 2).sum(-1)
        gap = np.sort(d, 1)[:, 1] - np.sort(d, 1)[:, 0]
        ok = gap > 1e-4
        np.testing.assert_array_equal(t.codes[ok, s], d.argmin(1)[ok])
    rel = (np.linalg.norm(t.decode() - x, axis=1)
           / np.linalg.norm(x, axis=1))
    assert rel.mean() < 0.25, rel.mean()
    sampled = tpq.PQCodebook.build(_t(x), S, n_codes=32, iters=4,
                                   train_sample=500)
    assert sampled.codes.shape == (len(x), S)


def test_build_validation():
    x = np.zeros((100, 10), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        tpq.PQCodebook.build(x, 4, device="cpu")
    with pytest.raises(ValueError, match="n_codes"):
        tpq.PQCodebook.build(x, 5, n_codes=300, device="cpu")
    with pytest.raises(ValueError, match="n_codes"):
        tpq.PQCodebook.build(x, 5, n_codes=200, device="cpu")


def test_anisotropic_eta_is_the_references():
    for t, d in ((0.2, 64), (0.5, 16), (0.9, 8)):
        assert tpq.anisotropic_eta(t, d) == jpq.anisotropic_eta(t, d)
    for t, d in ((0.0, 16), (1.0, 16), (0.1, 16)):
        with pytest.raises(ValueError):
            tpq.anisotropic_eta(t, d)
        with pytest.raises(ValueError):
            jpq.anisotropic_eta(t, d)


@pytest.mark.parametrize("update", [True, False])
def test_refine_anisotropic_matches_jax(update):
    rng = np.random.default_rng(2)
    x = _correlated(rng)
    book = jpq.PQCodebook.build(x, S, n_codes=16, iters=5)
    eta = jpq.anisotropic_eta(0.5, D)
    jc, jcodes = jpq._refine_anisotropic(
        jnp.asarray(x), book.centroids, np.asarray(book.codes, np.int32),
        eta, sweeps=2, update_centroids=update)
    tc, tcodes = tpq._refine_anisotropic(_t(x), book.centroids, book.codes,
                                         eta, sweeps=2, block_size=700,
                                         update_centroids=update)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tcodes, jcodes)
    assert tcodes.dtype == np.uint8
    jl = jpq.anisotropic_loss(x, book._replace(centroids=jc, codes=jcodes),
                              0.5)
    tl = tpq.anisotropic_loss(x, tpq.PQCodebook(tc, tcodes, len(x)), 0.5)
    assert tl == pytest.approx(jl, rel=1e-6)
    # the refinement lowers the score-aware loss it descends
    assert tl < tpq.anisotropic_loss(x, tpq.PQCodebook(*book[:3]), 0.5)


@pytest.mark.parametrize("aniso", [None, 0.5])
def test_encode_matches_jax(data, aniso):
    x, _, books = data
    rng = np.random.default_rng(3)
    book = books[True]
    if aniso is not None:
        book = book._replace(anisotropic_threshold=aniso)
    new = x[:700] + rng.normal(size=(700, D)).astype(np.float32) * 0.05
    want = book.encode(new)
    got = tpq.PQCodebook(*book).encode(new, device="cpu")
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.n_items == 700
    np.testing.assert_array_equal(got.centroids, book.centroids)
    assert got.anisotropic_threshold == aniso
    with pytest.raises(ValueError, match="dim"):
        tpq.PQCodebook(*book).encode(new[:, :8], device="cpu")


def test_codebook_files_cross_between_packages(data, tmp_path):
    x, q, books = data
    jb = books[True]._replace(anisotropic_threshold=0.3)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jb.save(jpath)
    tb = tpq.PQCodebook.build(x, S, n_codes=16, iters=3, rotate=True,
                              device="cpu")
    tb.save(tpath)
    for got, want in ((tpq.PQCodebook.load(jpath), jb),
                      (jpq.PQCodebook.load(tpath), tb)):
        for name in ("centroids", "codes", "rotation"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.n_items == want.n_items
        assert got.anisotropic_threshold == want.anisotropic_threshold
    np.testing.assert_array_equal(tpq.PQCodebook.load(jpath).decode(),
                                  jb.decode())
    plain = tpq.PQCodebook.build(x, S, n_codes=8, iters=2, device="cpu")
    plain.save(tpath)
    back = jpq.PQCodebook.load(tpath)
    assert back.rotation is None and back.anisotropic_threshold is None
