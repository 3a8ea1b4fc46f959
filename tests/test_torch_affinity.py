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


# (B, C, M, L, valid_count[, D]): ragged B, one and five context slots,
# one block and several, a valid-count bound; then more slots than the
# tuned kernel takes (9, 12) at D=16 and 48 (on the card the generic
# kernel runs them), the catalog scaled by sqrt(16 / D) so that the scores
# keep the D=16 cases' spread, which the tolerance was stated for
CASES = [
    (5, 4, 1000, 128, None),
    (13, 5, 1000, 128, 600),
    (1, 1, 700, 256, None),
    (9, 5, 2049, 128, 1500),
    (3, 1, 300, 128, 250),
    (7, 9, 1000, 128, None, 16),
    (13, 12, 2049, 128, 1500, 16),
    (5, 9, 700, 256, 600, 48),
    (3, 12, 1000, 128, None, 48),
]


@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_plain_matches_jax_kernel(case):
    b, c, m, bins, valid = case[:5]
    d = case[5] if len(case) > 5 else 16
    data = _data(seed=m + b, b=b, c=c, d=d, m=m)
    data[1][:] *= np.float32(np.sqrt(16 / d))
    tv, ti, jv, ji = _both(data, bins, valid)
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


def test_variant_is_tuned_at_its_dims_and_slots_only():
    for d in tkernel.SUPPORTED_DIMS:
        for c in range(1, tkernel.MAX_SLOTS + 1):
            assert tkernel.variant(d, c) == "tuned"
        for c in (9, 12, 16, 100):
            assert tkernel.variant(d, c) == "generic"   # C > 8: always
    for d in (1, 8, 16, 24, 48, 100, 256, 768):
        for c in (1, 5, 8, 9, 16):
            assert tkernel.variant(d, c) == "generic"
    with pytest.raises(ValueError):
        tkernel.variant(0, 5)
    with pytest.raises(ValueError):
        tkernel.variant(64, 0)


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


def _membership_ids(kind, rng):
    """(ctx (B, C), item ids (M,)) int32 for one membership case."""
    if kind == "random":
        ctx = rng.integers(0, 60, (70, 5))
        items = rng.integers(0, 60, 400)
    elif kind == "colliding":  # 64 x 8 distinct ids, one probe chain
        ids = tkernel.colliding_ids(64 * 8 + 40, slot=3).numpy()
        ctx = ids[:64 * 8].reshape(64, 8)
        items = np.concatenate([ids, rng.integers(-5, 5, 100)])
    elif kind == "one_set":  # every query of the tile holds the same ids
        ctx = np.tile(rng.integers(0, 1000, 5), (64, 1))
        items = rng.integers(0, 1000, 300)
        items[:5] = ctx[0]
    else:  # the padding ids, the int32 extremes, repeats in one query
        ext = [-1, -2, -2**31, 2**31 - 1, 0]
        ctx = rng.choice(ext + [7, 8], size=(66, 4))
        ctx[3] = [7, 7, 7, 7]
        items = np.array(ext + [7, 8, 9, -3, 2**31 - 2] * 3)
    return ctx.astype(np.int32), items.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "colliding", "one_set",
                                  "special"])
def test_membership_masks_match_batched_isin(kind):
    """The kernel's hash-table membership (its plain twin) against the
    reference's ``batched_isin`` on the same ids: exact."""
    from esrecsys_tpu.models.playlist import batched_isin

    ctx, items = _membership_ids(kind, np.random.default_rng(7))
    want = np.asarray(batched_isin(
        jnp.broadcast_to(jnp.asarray(items), (ctx.shape[0], items.shape[0])),
        jnp.asarray(ctx)))
    masks = tkernel.membership_masks(torch.from_numpy(ctx),
                                     torch.from_numpy(items)).numpy()
    b = np.arange(ctx.shape[0])
    got = (masks[b // 64].view(np.uint64)
           >> (b % 64).astype(np.uint64)[:, None]) & np.uint64(1)
    np.testing.assert_array_equal(got.astype(bool), want)


def test_colliding_ids_share_one_slot():
    ids = tkernel.colliding_ids(600, slot=1000)
    assert len(set(ids.tolist())) == 600
    assert set(tkernel.table_slot(ids).tolist()) == {1000}
