"""The int8 scan of quantized serving in the port against the JAX package:
``mips.quantize_rows`` (and its numpy twin) and
``mips.quantized_topk_over_matrix`` with ``select="exact"``.

Tolerances: the quantizer is bit-identical on all three sides (scale clamp,
float32 reciprocal of 127, half-to-even rounding, clip). The int8 block
scores are exact integers times the same float32 scales, so phase 1 picks
the same candidates; the float32 rescore sums width-16 products in another
order than JAX's einsum, so values agree within 1e-5 relative, and ids are
equal except where two candidates' rescored values lie within that
tolerance of each other (a near-tie the two orders may break apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu_torch.retrieval import mips as tmips

RTOL = 1e-5


def _rows(seed=5):
    rng = np.random.default_rng(seed)
    half = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 63.5, -126.5]
                    + [3.5] * 8, np.float32)       # scale exactly 1.0
    return np.concatenate([
        rng.normal(size=(50, 16)).astype(np.float32),
        np.zeros((2, 16), np.float32),                          # all-zero
        (rng.normal(size=(8, 16)) * 1e-20).astype(np.float32),  # tiny
        np.full((1, 16), 63.5, np.float32),
        half[None, :],                                          # .5 ties
        (rng.normal(size=(4, 16)) * 1e6).astype(np.float32),
    ])


def test_quantize_rows_bit_identical_to_jax_and_numpy():
    x = _rows()
    qj, sj = jax.jit(jmips.quantize_rows)(jnp.asarray(x))
    qt, st = tmips.quantize_rows(torch.from_numpy(x))
    qn, sn = tmips.quantize_rows_np(x)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(qn, np.asarray(qj))
    # scales compared as bits: equal floats are not enough
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    np.testing.assert_array_equal(sn.view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert (qt.numpy()[50:52] == 0).all()            # all-zero rows stay 0
    # row 61: x / 1.0 with exact .5 quotients rounds half to even
    assert qt.numpy()[61, :8].tolist() == [127, 0, 2, 2, -2, 0, 64, -126]


def test_quantize_rows_np_matches_reference_twin():
    x = _rows(seed=9)
    qr, sr = jmips.quantize_rows_np(x)
    qn, sn = tmips.quantize_rows_np(x)
    np.testing.assert_array_equal(qn, qr)
    np.testing.assert_array_equal(sn.view(np.int32), sr.view(np.int32))


def test_int8_dot_is_exact():
    rng = np.random.default_rng(1)
    qq = torch.from_numpy(rng.integers(-127, 128, (5, 64)).astype(np.int8))
    codes = torch.from_numpy(rng.integers(-127, 128, (1003, 64))
                             .astype(np.int8))
    got = tmips.int8_dot(qq, codes)
    want = qq.long() @ codes.long().T
    assert got.dtype == torch.int32 and got.shape == (5, 1003)
    assert torch.equal(got.long(), want)


def test_top_ids_lower_index_first_orders_like_lax_top_k():
    rng = np.random.default_rng(2)
    vals = rng.integers(-3, 4, (4, 300)).astype(np.float32)   # many ties
    vals[0, :5] = -np.inf
    vals[1, 7] = -0.0
    t = torch.from_numpy(vals)
    got = tmips.top_ids_lower_index_first(t, 40)
    _, want = jax.lax.top_k(jnp.asarray(vals), 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, stable = tmips.topk_lower_index_first(t, 40)
    assert torch.equal(got, stable)


def _assert_topk(tv, ti, jv, ji, items, queries, rescore_scales=None):
    """Values within RTOL; ids equal except between near-tied slots."""
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=RTOL, atol=1e-6)
    diff = (ti != ji) & fin
    if diff.any():
        rows = items.astype(np.float32)
        if rescore_scales is not None:
            rows = rows * rescore_scales[:, None]
        b, _ = np.nonzero(diff)
        s_t = (rows[ti[diff]] * queries[b]).sum(-1)
        s_j = (rows[ji[diff]] * queries[b]).sum(-1)
        assert np.all(np.abs(s_t - s_j) <= RTOL * np.abs(s_j) + 1e-6), (
            f"{int(diff.sum())} ids differ beyond near-ties")
    np.testing.assert_array_equal(ti[~fin], 0)


# (k, M, block_size, valid_count, with_mask, rescore_int8)
CASES = [
    (50, 3000, 262_144, None, False, False),
    (50, 3000, 1024, None, False, False),
    (50, 3000, 1024, 2500, True, False),
    (20, 777, 256, 700, False, False),
    (4000, 3000, 1024, None, False, False),   # k past the catalog
    (50, 3000, 1024, None, False, True),
    (50, 3000, 262_144, 2500, True, True),
    (64, 50, 262_144, None, False, True),     # k past a tiny catalog
]


@pytest.mark.parametrize("k,m,block,valid,with_mask,r8", CASES)
def test_quantized_topk_matches_jax(k, m, block, valid, with_mask, r8):
    rng = np.random.default_rng(m + k)
    items = rng.normal(size=(m, 16)).astype(np.float32)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    mask = rng.random(m) > 0.4 if with_mask else None
    q8, sc = jmips.quantize_rows(jnp.asarray(items))
    jv, ji = jmips.quantized_topk_over_matrix(
        jnp.asarray(q), q8, sc, q8 if r8 else jnp.asarray(items), k,
        block_size=block, rescore_scales=sc if r8 else None,
        valid_count=None if valid is None else jnp.int32(valid),
        item_mask=None if mask is None else jnp.asarray(mask))
    t8, ts = tmips.quantize_rows(torch.from_numpy(items))
    tv, ti = tmips.quantized_topk_over_matrix(
        torch.from_numpy(q), t8, ts, t8 if r8 else torch.from_numpy(items),
        k, block_size=block, rescore_scales=ts if r8 else None,
        valid_count=valid,
        item_mask=None if mask is None else torch.from_numpy(mask))
    assert tv.shape == (5, k) and ti.dtype == torch.int64
    _assert_topk(tv, ti, jv, ji, t8.numpy() if r8 else items, q,
                 ts.numpy() if r8 else None)
    ids = ti.numpy()[np.isfinite(tv.numpy())]
    if valid is not None:
        assert (ids < valid).all()
    if mask is not None:
        assert mask[ids].all()


def test_per_block_k_and_oversample_match_jax():
    """Per-block k is the reference's, ceil(oversample * k / nblk) with
    oversample 4: with every true top-30 item crowded into block 0, both
    sides keep exactly kb = ceil(120 / 6) = 20 of them."""
    rng = np.random.default_rng(7)
    items = rng.normal(size=(1500, 16)).astype(np.float32)
    items[:256] *= 10.0                     # block 0 of 6 outscores the rest
    q = rng.normal(size=(3, 16)).astype(np.float32)
    q8, sc = jmips.quantize_rows(jnp.asarray(items))
    t8, ts = tmips.quantize_rows(torch.from_numpy(items))
    jv, ji = jmips.quantized_topk_over_matrix(
        jnp.asarray(q), q8, sc, jnp.asarray(items), 30, block_size=256)
    tv, ti = tmips.quantized_topk_over_matrix(
        torch.from_numpy(q), t8, ts, torch.from_numpy(items), 30,
        block_size=256)
    _assert_topk(tv, ti, jv, ji, items, q)
    assert ((ti.numpy() < 256).sum(-1) == 20).all()


def test_select_approx_is_not_ported_and_bad_select_raises():
    """select="approx" is ported now: at 300 rows the approx select's
    reduction is 0 (one bin a position), so it equals the JAX function,
    whose CPU approx_max_k is exact. A bad select still raises."""
    rng = np.random.default_rng(3)
    items = rng.normal(size=(300, 16)).astype(np.float32)
    q = rng.normal(size=(2, 16)).astype(np.float32)
    t8, ts = tmips.quantize_rows(torch.from_numpy(items))
    q8, sc = jmips.quantize_rows(jnp.asarray(items))
    assert tmips.approx_reduction_size(384, 40, 0.95)[1] == 0
    tv, ti = tmips.quantized_topk_over_matrix(
        torch.from_numpy(q), t8, ts, torch.from_numpy(items), 10,
        select="approx")
    jv, ji = jmips.quantized_topk_over_matrix(
        jnp.asarray(q), q8, sc, jnp.asarray(items), 10, select="approx")
    _assert_topk(tv, ti, jv, ji, items, q)
    with pytest.raises(ValueError, match="select"):
        tmips.quantized_topk_over_matrix(torch.randn(2, 16), t8, ts, items,
                                         10, select="bogus")
