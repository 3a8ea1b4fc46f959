"""Exact MIPS in the port against ``esrecsys_tpu.retrieval.mips``.

The reference runs its group-max prefilter with a float32 rescore (on
the CPU its block matmul is full float32 too); the port streams float32
matmul blocks into ``torch.topk``. Both are exact, so ids must be equal on
random data (no ties) and values agree within 1e-5 absolute: the scores
are float32 dot products of width 16 whose sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu_torch.retrieval import mips as tmips

ATOL = 1e-5


def _data(seed, b=6, d=16, m=3000):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32),
            rng.random(m) > 0.5)


# (k, M, block_size, valid_count, with_mask)
CASES = [
    (50, 3000, 1024, None, False),
    (50, 3000, 1000, 2500, False),
    (20, 3000, 262_144, None, True),
    (20, 3000, 777, 1200, True),
    (64, 50, 16, None, False),      # k > M pads with (-inf, 0)
    (40, 300, 128, 30, True),       # fewer eligible rows than k
]


@pytest.mark.parametrize("k,m,block,valid,with_mask", CASES)
def test_topk_over_matrix_matches_jax(k, m, block, valid, with_mask):
    q, items, mask = _data(k + m, m=m)
    jv, ji = jmips.topk_over_matrix(
        jnp.asarray(q), jnp.asarray(items), k,
        valid_count=None if valid is None else jnp.int32(valid),
        item_mask=jnp.asarray(mask) if with_mask else None)
    tv, ti = tmips.topk_over_matrix(
        torch.from_numpy(q), torch.from_numpy(items), k, block_size=block,
        valid_count=valid,
        item_mask=torch.from_numpy(mask) if with_mask else None)
    assert tv.shape == (6, k) and ti.shape == (6, k)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(np.isfinite(tv.numpy()), np.isfinite(jv))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_equal_scores_order_by_ascending_id():
    q, items, _ = _data(1, m=400)
    items[[10, 250, 399]] = items[123]
    tv, ti = tmips.topk_over_matrix(torch.from_numpy(q),
                                    torch.from_numpy(items), 400,
                                    block_size=64)
    for row_v, row_i in zip(tv.numpy(), ti.numpy()):
        pos = [list(row_i).index(i) for i in (10, 123, 250, 399)]
        assert pos == sorted(pos) and pos[-1] - pos[0] == 3
        assert len(set(row_v[pos].tolist())) == 1


def test_topk_lower_index_first_is_lax_top_k_order():
    vals = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, float("-inf")]])
    v, i = tmips.topk_lower_index_first(vals, 4)
    assert i.tolist() == [[1, 2, 4, 3]] and v.tolist() == [[3, 3, 3, 2]]


@pytest.mark.parametrize("leaders", [0, 20])
@pytest.mark.parametrize("block", [777, 1024, 262_144])
def test_ties_at_the_cut_keep_the_lowest_ids(block, leaders):
    """200 exact copies of the best vector among 5,000 x 8 items, k=50:
    the cut runs through the tied copies (below ``leaders`` strictly
    better items), so the merge of every block must keep the lowest ids,
    as ``lax.top_k`` over the whole score matrix does. Integer-valued
    inputs make every score exact in both frameworks."""
    rng = np.random.default_rng(block + leaders)
    q = rng.integers(1, 5, size=(6, 8)).astype(np.float32)
    items = rng.integers(-3, 4, size=(5000, 8)).astype(np.float32)
    spots = rng.choice(5000, size=200 + leaders, replace=False)
    items[spots[:200]] = 4.0
    items[spots[200:]] = 5.0
    k = 50
    full = jnp.dot(jnp.asarray(q), jnp.asarray(items).T,
                   precision=jax.lax.Precision.HIGHEST)
    lv, li = jax.lax.top_k(full, k)
    rv, ri = jmips.topk_over_matrix(jnp.asarray(q), jnp.asarray(items), k,
                                    block_size=block, group=0)
    tv, ti = tmips.topk_over_matrix(torch.from_numpy(q),
                                    torch.from_numpy(items), k,
                                    block_size=block)
    copies = np.sort(spots[:200])[:k - leaders]
    for row in ti.numpy():
        np.testing.assert_array_equal(row[leaders:], copies)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(li))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(lv))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
