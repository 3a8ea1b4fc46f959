"""The approx select of the port (``retrieval/mips.py``:
``approx_reduction_size``, ``approx_select_ids``,
``approx_topk_over_matrix`` and ``quantized_topk_over_matrix(
select="approx")``) against the JAX package and XLA.

Tolerances:
  * ``approx_reduction_size`` equals jaxlib's
    ``approx_top_k_reduction_output_size(n, 2, k, r, False, -1)`` exactly.
  * The select equals a numpy model of the TPU's bins (position j in bin
    j mod L, each bin's first maximum, the top bin maxima by lower bin
    among equals): identical positions, planted ties included.
  * Where the reduction is 0 (one bin a position) the select is an exact
    top-k, and so is JAX's ``approx_max_k`` on the CPU: ids identical,
    values within 1e-5 relative (float32 sums in another order).
  * Where it is above 0 the CPU's JAX is still exact but the port bins: mean
    overlap@k at least 0.95 and each query at least 0.9 (the reference's
    recall target), and every returned value equal to the float64 dot of
    its row within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import xla_client

from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu_torch.retrieval import mips as tmips

RTOL = 1e-5
xla_reduction_size = xla_client._xla.approx_top_k_reduction_output_size

SIZES = [1, 100, 128, 129, 200, 1000, 1024, 2560, 5000, 8192, 20000,
         65536, 262143, 262144, 300000]
KS = [1, 2, 10, 50, 100, 223, 256, 500, 1000]


@pytest.mark.parametrize("recall_target", [0.8, 0.9, 0.95, 0.99, 1.0])
def test_reduction_size_equals_xla(recall_target):
    for n in SIZES:
        for k in KS:
            want = tuple(xla_reduction_size(n, 2, k, recall_target, False, -1))
            assert tmips.approx_reduction_size(n, k, recall_target) == want, \
                (n, k, recall_target)


def test_reduction_size_reference_points():
    # the flagship's blocks (kb 256 and 223) and the reference's examples
    assert tmips.approx_reduction_size(262_144, 256, 0.95) == (8192, 5)
    assert tmips.approx_reduction_size(262_144, 223, 0.95) == (8192, 5)
    assert tmips.approx_reduction_size(262_144, 500, 0.95) == (16_384, 4)
    assert tmips.approx_reduction_size(20_000, 50, 0.95) == (1280, 4)
    assert tmips.approx_reduction_size(5000, 100, 0.95) == (2560, 1)
    with pytest.raises(ValueError, match="recall_target"):
        tmips.approx_reduction_size(5000, 100, 0.0)


def _bins_model(scores: np.ndarray, kb: int, recall_target: float):
    """numpy model of the PartialReduce + top-k, one row at a time."""
    n = scores.shape[-1]
    L, r = tmips.approx_reduction_size(n, kb, recall_target)
    out = []
    for row in scores:
        if r == 0:
            out.append(np.argsort(-row, kind="stable")[:kb])
            continue
        pad = np.full(L << r, -np.inf, np.float32)
        pad[:n] = row
        groups = pad.reshape(1 << r, L)          # position j -> bin j mod L
        first = groups.argmax(axis=0)            # np.argmax: first maximum
        bin_max = groups[first, np.arange(L)]
        top = np.argsort(-bin_max, kind="stable")[:min(kb, L)]
        out.append(first[top] * L + top)
    return np.stack(out)


@pytest.mark.parametrize("n,kb,rt", [
    (8192, 100, 0.95),      # r = 2
    (20_000, 50, 0.95),     # r = 4, padded to 1280 * 16
    (5000, 100, 0.95),      # r = 1, padded
    (1000, 10, 0.8),        # r = 3
    (3000, 40, 0.99),       # r = 0: exact
    (2048, 1, 0.95),        # k = 1
])
def test_select_equals_numpy_bins_model(n, kb, rt):
    rng = np.random.default_rng(n + kb)
    # scores from a small set: equal maxima inside bins and across bins
    ties = rng.integers(0, 6, (4, n)).astype(np.float32)
    ties[0, ::7] = -np.inf
    smooth = rng.normal(size=(3, n)).astype(np.float32)
    smooth[1, : n // 2] = -np.inf             # half the row masked
    scores = np.concatenate([ties, smooth])
    got = tmips.approx_select_ids(torch.from_numpy(scores), kb, rt)
    want = _bins_model(scores, kb, rt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64


def _run_both(items, q, k, **kw):
    jkw = dict(kw)
    if jkw.get("valid_count") is not None:
        jkw["valid_count"] = jnp.int32(jkw["valid_count"])
    if jkw.get("item_mask") is not None:
        jkw["item_mask"] = jnp.asarray(jkw["item_mask"])
    jv, ji = jmips.approx_topk_over_matrix(
        jnp.asarray(q), jnp.asarray(items), k, **jkw)
    if kw.get("item_mask") is not None:
        kw["item_mask"] = torch.from_numpy(kw["item_mask"])
    tv, ti = tmips.approx_topk_over_matrix(
        torch.from_numpy(q), torch.from_numpy(items), k, **kw)
    return tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji)


# (M, k, block_size, recall_target, valid_count, with_mask); r == 0 in
# every block: the port's select is then exact, like JAX's on the CPU
EXACT_CASES = [
    (3000, 50, 1024, 0.99, None, False),
    (3000, 50, 1024, 0.99, 2500, True),
    (777, 20, 256, 0.99, 700, False),
    (300, 10, 262_144, 0.99, None, True),
]


@pytest.mark.parametrize("m,k,block,rt,valid,with_mask", EXACT_CASES)
def test_approx_topk_equals_jax_where_the_reduction_is_zero(
        m, k, block, rt, valid, with_mask):
    rng = np.random.default_rng(m + k)
    items = rng.normal(size=(m, 16)).astype(np.float32)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    mask = rng.random(m) > 0.4 if with_mask else None
    blk = min(block, -(-m // 128) * 128)
    kb = max(-(-k // -(-m // blk)), min(k, 256))
    assert tmips.approx_reduction_size(blk, kb, rt)[1] == 0
    tv, ti, jv, ji = _run_both(items, q, k, block_size=block,
                               recall_target=rt, valid_count=valid,
                               item_mask=mask)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6)
    if valid is not None:
        assert (ti < valid).all()
    if mask is not None:
        assert mask[ti].all()


@pytest.mark.parametrize("m,k,block,rt", [
    (20_000, 100, 8192, 0.95),   # kb 100, L 2048, r 2 in each block
    (20_000, 50, 20_096, 0.95),  # one block, L 1280, r 4
    (9000, 30, 4096, 0.9),
])
def test_approx_topk_recall_against_jax_where_the_reduction_bins(m, k, block,
                                                                 rt):
    rng = np.random.default_rng(m + k)
    items = rng.normal(size=(m, 16)).astype(np.float32)
    q = rng.normal(size=(16, 16)).astype(np.float32)
    blk = min(block, -(-m // 128) * 128)
    kb = max(-(-k // -(-m // blk)), min(k, 256))
    assert tmips.approx_reduction_size(blk, kb, rt)[1] > 0
    tv, ti, jv, ji = _run_both(items, q, k, block_size=block,
                               recall_target=rt)
    overlap = [len(set(ti[b]) & set(ji[b])) / k for b in range(len(q))]
    assert np.mean(overlap) >= 0.95 and min(overlap) >= 0.9, overlap
    exact = np.einsum("bkd,bd->bk", items[ti].astype(np.float64),
                      q.astype(np.float64))
    np.testing.assert_allclose(tv, exact, rtol=RTOL, atol=1e-6)
    assert (np.diff(tv, axis=-1) <= 0).all()
    assert all(len(set(row)) == k for row in ti)


def test_k_above_the_candidates_pads():
    """The reference's edge case (tests/test_mips.py): k past what the
    blocks keep pads with (-inf, 0)."""
    rng = np.random.default_rng(1)
    items = rng.normal(size=(64, 8)).astype(np.float32)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    tv, ti, jv, ji = _run_both(items, q, 50, block_size=64, per_block_k=16)
    assert tv.shape == (2, 50) and ti.shape == (2, 50)
    assert np.isneginf(tv[:, 16:]).all() and (ti[:, 16:] == 0).all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv[:, :16], jv[:, :16], rtol=RTOL)


def test_small_catalog_returns_k_real_items():
    """The reference's regression case: a single-block catalog with k
    above the default per-block candidates returns k real items."""
    rng = np.random.default_rng(2)
    items = rng.normal(size=(2000, 8)).astype(np.float32)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    tv, ti, jv, ji = _run_both(items, q, 500, block_size=262_144)
    assert np.isfinite(tv).all()
    assert len(set(ti[0].tolist())) == 500
    # block 2048, kb 500: the reduction is 2 bins, so compare recall
    overlap = [len(set(ti[b]) & set(ji[b])) / 500 for b in range(2)]
    assert min(overlap) >= 0.95, overlap


def test_valid_bound_and_mask_hold_in_both_phases():
    """Rows past the bound and masked rows are scaled to win every query:
    phase 1 must not spend a candidate slot on them, and the rescore must
    not let them back in with their real dot."""
    rng = np.random.default_rng(3)
    m = 3000
    items = rng.normal(size=(m, 16)).astype(np.float32)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    mask = np.ones(m, bool)
    mask[::3] = False
    items[::3] *= 50.0                 # masked rows lead every query
    items[2600:] *= 50.0               # so do the rows past the bound
    for rt in (0.99, 0.95):            # the exact select, then the bins
        tv, ti, jv, ji = _run_both(items, q, 40, block_size=1024,
                                   recall_target=rt, valid_count=2600,
                                   item_mask=mask)
        assert (ti < 2600).all() and mask[ti].all()
        assert np.isfinite(tv).all()
        overlap = [len(set(ti[b]) & set(ji[b])) / 40 for b in range(4)]
        assert min(overlap) >= (1.0 if rt == 0.99 else 0.9), overlap


def test_everything_masked_gives_minus_inf_and_id_zero():
    items = np.random.default_rng(4).normal(size=(500, 8)).astype(np.float32)
    q = np.ones((2, 8), np.float32)
    tv, ti, _, _ = _run_both(items, q, 10, item_mask=np.zeros(500, bool))
    assert np.isneginf(tv).all() and (ti == 0).all()


@pytest.mark.parametrize("rt", [0.99, 0.95])
def test_quantized_select_approx_against_jax(rt):
    """The int8 scan with the approx select, as
    tests/test_quantized_mips.py holds the reference's: against JAX's
    (exact on the CPU) and against the port's exact int8 select. At 0.99
    the reduction is 0 and the ids are JAX's; at 0.95 it bins."""
    rng = np.random.default_rng(5)
    items = rng.normal(size=(6000, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    q8, sc = jmips.quantize_rows(jnp.asarray(items))
    t8, ts = tmips.quantize_rows(torch.from_numpy(items))
    jv, ji = jmips.quantized_topk_over_matrix(
        jnp.asarray(q), q8, sc, jnp.asarray(items), 20, block_size=2048,
        select="approx", recall_target=rt)
    tv, ti = tmips.quantized_topk_over_matrix(
        torch.from_numpy(q), t8, ts, torch.from_numpy(items), 20,
        block_size=2048, select="approx", recall_target=rt)
    ev, ei = tmips.quantized_topk_over_matrix(
        torch.from_numpy(q), t8, ts, torch.from_numpy(items), 20,
        block_size=2048)
    tv, ti, ji = tv.numpy(), ti.numpy(), np.asarray(ji)
    kb = -(-4 * 20 // 3)
    reduced = tmips.approx_reduction_size(2048, kb, rt)[1] > 0
    assert reduced == (rt == 0.95)
    if not reduced:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ti, ei.numpy())
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=RTOL, atol=1e-6)
    overlap = [len(set(ti[b]) & set(ji[b])) / 20 for b in range(8)]
    assert np.mean(overlap) >= 0.95 and min(overlap) >= 0.9, overlap
    exact = np.einsum("bkd,bd->bk", items[ti].astype(np.float64),
                      q.astype(np.float64))
    np.testing.assert_allclose(tv, exact, rtol=RTOL, atol=1e-6)


def test_bf16_scores_are_float32_sums_of_bf16_products():
    """Phase 1's scores: both sides rounded to bf16, the products summed
    in float32 (the reference's preferred_element_type=float32), never a
    bf16 output."""
    rng = np.random.default_rng(6)
    rows = rng.normal(size=(300, 64)).astype(np.float32)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    got = tmips.bf16_scores(torch.from_numpy(q).to(torch.bfloat16),
                            torch.from_numpy(rows))
    want = jnp.einsum("bd,md->bm", jnp.asarray(q, jnp.bfloat16),
                      jnp.asarray(rows, jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    # bf16 outputs would hold 8 bits: most float32 sums carry more
    assert (got.numpy() != got.to(torch.bfloat16).float().numpy()).mean() > 0.9
