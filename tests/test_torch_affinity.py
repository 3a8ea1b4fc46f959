"""Fused playlist-affinity scan+select in the port against the JAX kernel.

The JAX side is ``binned_affinity_candidates`` (``_affinity_kernel``
through the Pallas interpreter, which it picks itself off a TPU), the
cases mirroring ``tests/test_fused.py:304-365``; the port runs its plain
PyTorch version (the CPU path of ``kernels/fused_affinity.py``).

Tolerances: candidate values within 1e-5 absolute. Both sides multiply the
same bf16-rounded inputs exactly in float32 and add the same float32 0.1
boosts after the max; only the order of the float32 dot-product sums
differs. Ids must be equal: random normal data leaves no near-ties, and
where two items score bit-equal (copies of one vector) the strict-'>'
rule decides on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import fused as jfused
from esrecsys_tpu_torch.kernels import fused_affinity as tkernel
from esrecsys_tpu_torch.retrieval import fused as tfused

ATOL = 1e-5


def _data(seed=0, b=5, c=4, d=16, m=1000, nalb=50, nart=30):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, c, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32),
            rng.integers(0, nalb, m).astype(np.int32),
            rng.integers(0, nart, m).astype(np.int32),
            rng.integers(0, nalb, (b, c)).astype(np.int32),
            rng.integers(0, nart, (b, c)).astype(np.int32))


def _both(data, bins, valid=None):
    ctx, items, alb, art, actx, artx = data
    m = items.shape[0]
    jv, ji = jfused.binned_affinity_candidates(
        jnp.asarray(ctx), jfused.pack_catalog(jnp.asarray(items), bins),
        jnp.asarray(alb), jnp.asarray(art), jnp.asarray(actx),
        jnp.asarray(artx), m, num_bins=bins,
        valid_count=None if valid is None else jnp.int32(valid))
    t = [torch.from_numpy(x) for x in data]
    tv, ti = tfused.binned_affinity_candidates(
        t[0], tfused.pack_catalog(t[1], bins), t[2], t[3], t[4], t[5], m,
        num_bins=bins, valid_count=valid)
    return tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)


def _assert_same(tv, ti, jv, ji):
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti, ji)


# (B, C, M, L, valid_count): ragged B, one and five context slots, one
# block and several, a valid-count bound
CASES = [
    (5, 4, 1000, 128, None),
    (13, 5, 1000, 128, 600),
    (1, 1, 700, 256, None),
    (9, 5, 2049, 128, 1500),
    (3, 1, 300, 128, 250),
]


@pytest.mark.parametrize("b,c,m,bins,valid", CASES)
def test_plain_matches_jax_kernel(b, c, m, bins, valid):
    tv, ti, jv, ji = _both(_data(seed=m + b, b=b, c=c, m=m), bins, valid)
    _assert_same(tv, ti, jv, ji)
    if valid is not None:
        fin = np.isfinite(tv)
        assert fin.any() and (ti[fin] < valid).all()


def test_exact_ties_keep_the_earlier_block():
    """Copies of one vector at g, g + L, g + 3L (same bin, same album and
    artist) score bit-equal: each bin keeps the earliest copy on top and
    the next one as runner-up, on both sides."""
    ctx, items, alb, art, actx, artx = _data(seed=7, b=4, c=5, m=1000)
    L = 128
    g = np.arange(0, L, 2)
    items[g] *= 3
    for off in (L, 3 * L):
        items[g + off] = items[g]
        alb[g + off] = alb[g]
        art[g + off] = art[g]
    ctx[0, 2] = items[0]
    tv, ti, jv, ji = _both((ctx, items, alb, art, actx, artx), L)
    _assert_same(tv, ti, jv, ji)
    ties = (tv[:, :L] == tv[:, L:]) & np.isfinite(tv[:, L:])
    assert ties.sum() > 0
    assert (ti[:, :L][ties] < ti[:, L:][ties]).all()


def test_boosts_reach_the_scores():
    """An item whose album is in the query's context outranks an identical
    item whose album is not, by 0.1 exactly in float32."""
    ctx, items, alb, art, actx, artx = _data(seed=9, b=2, c=3, m=256)
    items[200] = items[72]          # same bin (mod 128), later block
    art[200] = art[72]
    alb[72], alb[200] = 999, 7
    actx[:] = 7
    artx[:] = -5                    # no artist boost anywhere
    tv, ti, jv, ji = _both((ctx, items, alb, art, actx, artx), 128)
    _assert_same(tv, ti, jv, ji)
    assert (ti[:, 72] == 200).all() and (ti[:, 128 + 72] == 72).all()
    np.testing.assert_array_equal(tv[:, 72],
                                  tv[:, 128 + 72] + np.float32(0.1))


def test_payload_padding():
    alb = torch.tensor([4, 5], dtype=torch.int32)
    out = tfused.pack_payload(alb, 5)
    assert out.tolist() == [4, 5, -2, -2, -2]


def test_plain_is_taken_on_cpu_without_launch():
    ctx, items, alb, art, actx, artx = _data(b=2, m=200)
    before = tkernel.LAUNCHES.count
    t = [torch.from_numpy(x) for x in (ctx, items, alb, art, actx, artx)]
    tfused.binned_affinity_candidates(t[0], tfused.pack_catalog(t[1], 128),
                                      t[2], t[3], t[4], t[5], 200, 128)
    assert tkernel.LAUNCHES.count == before


def test_check_rejects_bad_inputs():
    q = torch.zeros(2, 3, 16, dtype=torch.bfloat16)
    packed = torch.zeros(16, 256, dtype=torch.bfloat16)
    pay = torch.zeros(256, dtype=torch.int32)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_bins"):
        tkernel.fused_affinity(q, packed, pay, pay, ids, ids, 100, 256)
    with pytest.raises(ValueError, match="bound"):
        tkernel.fused_affinity(q, packed, pay, pay, ids, ids, 128, 300)
    with pytest.raises(ValueError):
        tkernel.fused_affinity(q, packed, pay[:10], pay, ids, ids, 128, 200)
    with pytest.raises(TypeError):
        tkernel.fused_affinity(q.float(), packed, pay, pay, ids, ids, 128, 1)
