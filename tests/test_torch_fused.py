"""Fused scan+select in the port against the JAX package.

The port's plain PyTorch version of the kernel (what a CPU tensor takes)
is held against the JAX Pallas kernel, run here through the Pallas
interpreter as ``tests/test_fused.py`` runs it, and against the JAX
pure-jnp oracle ``reference_binned_candidates``.

Tolerances: candidate values within 1e-5 absolute. Both sides multiply
the same bf16-rounded inputs exactly in float32 and differ only in the
order of the float32 sums (measured differences are under 1e-6 at these
sizes). Ids must be equal: random normal data leaves no near-ties. The
cases at other widths scale the catalog's entries by sqrt(16 / D), so that
the scores keep the spread of the D=16 cases the tolerance was stated for
(a float32 sum's order changes it by about eps times the sum of the
magnitudes of its terms, which grows with D at a fixed entry scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import fused as jfused
from esrecsys_tpu_torch.kernels import fused_scan as tkernel
from esrecsys_tpu_torch.retrieval import fused as tfused

ATOL = 1e-5


def _data(seed=0, b=5, d=16, m=3000):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _wide_data(seed, b, d, m):
    """_data at width d with the catalog scaled by sqrt(16 / d)."""
    q, items = _data(seed=seed, b=b, d=d, m=m)
    return q, (items * np.float32(np.sqrt(16 / d))).astype(np.float32)


def _assert_candidates(tv, ti, jv, ji):
    tv, jv = tv.numpy(), np.asarray(jv)
    np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# (B, M, L, valid_count, with_mask): ragged M, B not a multiple of 8,
# a valid-count bound, an eligibility mask, one block, many blocks
CASES = [
    (5, 3000, 128, None, False),
    (5, 3000, 128, 2900, True),
    (3, 1000, 256, None, True),
    (11, 2049, 128, 1500, False),
    (1, 200, 128, None, False),
    (8, 777, 384, 700, True),
    # the card's kernel runs these as one full cluster of eight query
    # tiles, and as two clusters with the last one holding one tile
    (64, 3000, 128, 2900, True),
    (65, 2049, 256, None, False),
]


@pytest.mark.parametrize("b,m,bins,valid,with_mask", CASES)
def test_plain_candidates_match_jax_kernel(b, m, bins, valid, with_mask):
    q, items = _data(seed=m, b=b, m=m)
    mask = np.random.default_rng(1).random(m) > 0.4 if with_mask else None
    jv, ji = jfused.binned_candidates(
        jnp.asarray(q), jfused.pack_catalog(jnp.asarray(items), bins), m,
        num_bins=bins,
        valid_count=None if valid is None else jnp.int32(valid),
        item_mask=None if mask is None else jnp.asarray(mask))
    tv, ti = tfused.binned_candidates(
        torch.from_numpy(q), tfused.pack_catalog(torch.from_numpy(items), bins),
        m, num_bins=bins, valid_count=valid,
        item_mask=None if mask is None else torch.from_numpy(mask))
    _assert_candidates(tv, ti, jv, ji)


# widths the tuned kernels lack (on the card the generic kernel runs
# them): ragged (8, 24, 100), a multiple of 16 (48) and the playlist
# catalog's 2 x 128 (256)
WIDTHS = [8, 24, 48, 100, 256]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,m,bins,valid,with_mask",
                         [(5, 3000, 128, 2900, True),
                          (13, 2049, 256, None, False)])
def test_plain_candidates_match_jax_kernel_at_any_width(d, b, m, bins,
                                                        valid, with_mask):
    q, items = _wide_data(m + d, b, d, m)
    mask = np.random.default_rng(1).random(m) > 0.4 if with_mask else None
    jv, ji = jfused.binned_candidates(
        jnp.asarray(q), jfused.pack_catalog(jnp.asarray(items), bins), m,
        num_bins=bins,
        valid_count=None if valid is None else jnp.int32(valid),
        item_mask=None if mask is None else jnp.asarray(mask))
    tv, ti = tfused.binned_candidates(
        torch.from_numpy(q), tfused.pack_catalog(torch.from_numpy(items), bins),
        m, num_bins=bins, valid_count=valid,
        item_mask=None if mask is None else torch.from_numpy(mask))
    _assert_candidates(tv, ti, jv, ji)


@pytest.mark.parametrize("b,m,bins,valid,with_mask", CASES[:3])
def test_plain_candidates_match_jax_oracle(b, m, bins, valid, with_mask):
    q, items = _data(seed=m + 1, b=b, m=m)
    mask = np.random.default_rng(2).random(m) > 0.4 if with_mask else None
    jv, ji = jfused.reference_binned_candidates(
        jnp.asarray(q), jnp.asarray(items), bins,
        valid_count=None if valid is None else jnp.int32(valid),
        item_mask=None if mask is None else jnp.asarray(mask))
    tv, ti = tfused.binned_candidates(
        torch.from_numpy(q), tfused.pack_catalog(torch.from_numpy(items), bins),
        m, num_bins=bins, valid_count=valid,
        item_mask=None if mask is None else torch.from_numpy(mask))
    _assert_candidates(tv, ti, jv, ji)


def test_duplicate_items_earlier_block_wins():
    # item 5 and its copies at 5 + L, 5 + 3L all land in bin 5 with the
    # same score; the strict > keeps the earliest block's id
    q, items = _data(b=8, m=1024)
    L = 128
    first, second, third = 5 + L, 5 + 3 * L, 5 + 5 * L
    items[second] = items[third] = items[first]
    jv, ji = jfused.binned_candidates(
        jnp.asarray(q), jfused.pack_catalog(jnp.asarray(items), L), 1024,
        num_bins=L)
    tv, ti = tfused.binned_candidates(
        torch.from_numpy(q), tfused.pack_catalog(torch.from_numpy(items), L),
        1024, num_bins=L)
    _assert_candidates(tv, ti, jv, ji)
    best, runner_up = ti[:, 5], ti[:, L + 5]
    assert (best == first).any()               # the copies lead some bins
    assert not (best == third).any() and not (runner_up == third).any()
    assert (best != second).all()
    # the fold is path-dependent on ties, and the port follows it: after
    # (v@first, v@second) a later winner pushes v@first down, which does
    # not beat the equal v@second already in the runner-up slot
    assert (runner_up == second).any()


@pytest.mark.parametrize("d", WIDTHS)
def test_duplicate_items_earlier_block_wins_at_any_width(d):
    # copies of one vector at g + L, g + 3L, g + 5L score bit-equal at
    # every width: the earliest copy leads, the next is runner-up
    q, items = _wide_data(d, 8, d, 1024)
    L = 128
    g = np.arange(0, L, 2)
    items[g + L] *= 3
    items[g + 3 * L] = items[g + 5 * L] = items[g + L]
    jv, ji = jfused.binned_candidates(
        jnp.asarray(q), jfused.pack_catalog(jnp.asarray(items), L), 1024,
        num_bins=L)
    tv, ti = tfused.binned_candidates(
        torch.from_numpy(q), tfused.pack_catalog(torch.from_numpy(items), L),
        1024, num_bins=L)
    _assert_candidates(tv, ti, jv, ji)
    ties = (tv[:, :L] == tv[:, L:]) & torch.isfinite(tv[:, L:])
    assert bool(ties.any())
    assert bool((ti[:, :L][ties] < ti[:, L:][ties]).all())


def test_variant_is_tuned_at_the_tuned_dims_only():
    for d in tkernel.SUPPORTED_DIMS:
        assert tkernel.variant(d) == "tuned"
    for d in (1, 8, 24, 48, 96, 100, 256, 300, 768, 6100):
        assert tkernel.variant(d) == "generic"
    with pytest.raises(ValueError):
        tkernel.variant(0)


def test_generic_queries_pad_to_sixteen_columns():
    from esrecsys_tpu_torch.kernels import fused_generic as gen

    assert [gen.padded_dim(d) for d in (1, 8, 16, 24, 100, 256, 300)] == \
        [16, 16, 16, 32, 112, 256, 304]
    q = torch.randn(3, 5, 24).to(torch.bfloat16)
    qp = gen.pad_queries(q)
    assert qp.shape == (3, 5, 32) and qp.is_contiguous()
    assert torch.equal(qp[..., :24], q) and not qp[..., 24:].any()
    whole = torch.randn(4, 32).to(torch.bfloat16)
    if whole.data_ptr() % 16 == 0:
        assert gen.pad_queries(whole) is whole   # nothing to pad
    # the padded scan scores what the unpadded one does, exactly
    items = torch.randn(256, 24)
    packed = tfused.pack_catalog(items, 128)
    wide = torch.zeros(32, 256, dtype=torch.bfloat16)
    wide[:24] = packed
    a = tkernel.fused_scan_plain(q[:, 0], packed, 128, 256)
    b = tkernel.fused_scan_plain(gen.pad_queries(q[:, 0]), wide, 128, 256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("k,m,bins", [(50, 3000, 128), (7, 300, 512),
                                      (64, 50, 128), (500, 2000, 128)])
def test_binned_topk_matches_jax(k, m, bins):
    q, items = _data(seed=k, b=6, m=m)
    jv, ji = jfused.binned_topk_over_matrix(jnp.asarray(q), jnp.asarray(items),
                                            k, num_bins=bins)
    tv, ti = tfused.binned_topk_over_matrix(torch.from_numpy(q),
                                            torch.from_numpy(items), k,
                                            num_bins=bins)
    assert tv.shape == (6, k) and ti.shape == (6, k)
    np.testing.assert_array_equal(np.isfinite(tv.numpy()),
                                  np.isfinite(np.asarray(jv)))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_k_exceeds_catalog_pads_like_reference():
    q, items = _data(m=50)
    tv, ti = tfused.binned_topk_over_matrix(torch.from_numpy(q),
                                            torch.from_numpy(items), 64,
                                            num_bins=128)
    assert tv.shape == (5, 64)
    assert not torch.isfinite(tv[:, 50:]).any()
    assert (ti[:, 50:] == 0).all()


def test_masked_and_bounded_topk_matches_jax():
    q, items = _data(m=1000)
    mask = np.random.default_rng(3).random(1000) > 0.5
    jv, ji = jfused.binned_topk_over_matrix(
        jnp.asarray(q), jnp.asarray(items), 20, num_bins=128,
        valid_count=jnp.int32(700), item_mask=jnp.asarray(mask))
    tv, ti = tfused.binned_topk_over_matrix(
        torch.from_numpy(q), torch.from_numpy(items), 20, num_bins=128,
        valid_count=700, item_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti < 700).all() and mask[ti.numpy()].all()


@pytest.mark.parametrize("m,bins", [(1000, 128), (1000, 100), (4096, 4096),
                                    (300, 512)])
def test_pack_catalog_layout_matches_jax(m, bins):
    _, items = _data(m=m)
    jp = np.asarray(jfused.pack_catalog(jnp.asarray(items),
                                        bins).astype(jnp.float32))
    tp = tfused.pack_catalog(torch.from_numpy(items), bins)
    assert tp.dtype == torch.bfloat16 and tp.is_contiguous()
    assert tuple(tp.shape) == jp.shape
    np.testing.assert_array_equal(tp.float().numpy(), jp)


def test_shape_mismatch_raises_like_reference():
    q, items = _data(m=1000)
    tp = tfused.pack_catalog(torch.from_numpy(items), 128)  # Mp = 1024
    with pytest.raises(ValueError):  # 1024 is not a multiple of 384
        tfused.binned_candidates(torch.from_numpy(q), tp, 1000, num_bins=384)
    with pytest.raises(ValueError):
        jfused.binned_candidates(
            jnp.asarray(q), jfused.pack_catalog(jnp.asarray(items), 128),
            1000, num_bins=384)


def test_validate_fused_bins_errors():
    tfused.validate_fused_bins(4096, 64, use_mask=True)
    # the plain version takes any dim, and so do the card's kernels: the
    # tuned ones at their four dims, the generic one at every other
    tfused.validate_fused_bins(4096, 48)
    tfused.validate_fused_bins(4096, 48, device=torch.device("cpu"))
    tfused.validate_fused_bins(4096, 64, device="cuda")
    for dim in (1, 8, 24, 48, 100, 256, 300, 768):
        tfused.validate_fused_bins(4096, dim, device="cuda")
        tfused.validate_fused_bins(4096, dim, use_scales=True,
                                   device="cuda")
    with pytest.raises(ValueError, match="positive"):
        tfused.validate_fused_bins(0, 64)
    with pytest.raises(ValueError, match="positive"):
        tfused.validate_fused_bins(0, 48, device="cuda")
    with pytest.raises(ValueError, match="positive"):
        tfused.validate_fused_bins(4096, 0, use_scales=True, device="cuda")


def test_pad_mask_pads_once():
    m = torch.tensor([True, False, True])
    padded = tfused.pad_mask(m, 128)
    assert padded.shape == (128,) and padded.dtype == torch.bool
    assert padded[:3].tolist() == [True, False, True] and not padded[3:].any()
    assert tfused.pad_mask(padded, 128) is padded  # already (Mp,): no copy


def test_plain_version_checks_its_inputs():
    q = torch.zeros((2, 16), dtype=torch.bfloat16)
    packed = torch.zeros((16, 256), dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tkernel.fused_scan(q.float(), packed, 128, 256)
    with pytest.raises(ValueError):
        tkernel.fused_scan(q, packed, 128, 300)   # bound past Mp
    with pytest.raises(ValueError):
        tkernel.fused_scan(q, packed, 128, 256,
                           torch.zeros(100, dtype=torch.bool))


def test_non_cpu_tensors_never_take_the_plain_version():
    # a tensor off the CPU goes to the kernel wrapper, which refuses what
    # is not on a CUDA device; nothing falls back to the plain version
    q = torch.zeros((2, 16), dtype=torch.bfloat16, device="meta")
    packed = torch.zeros((16, 256), dtype=torch.bfloat16, device="meta")
    before = tkernel.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_scan(q, packed, 128, 256)
    assert tkernel.LAUNCHES.count == before


def test_cuda_requested_without_cuda_raises():
    from esrecsys_tpu_torch.core.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)  # the default is the card
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("bins", [128, 4096])
@pytest.mark.parametrize("case", ["better", "masked", "bounded"])
def test_runner_up_follows_the_sequential_fold(case, bins):
    # bins 3, 5 and L-1 hold v in blocks 0 and 1 and 2v (strictly better
    # for every query) in block 2: the fold keeps 2v first and the block-1
    # copy of v second; with 2v masked out or past the bound, block 0's v
    # leads and block 1's follows
    L = bins
    rng = np.random.default_rng(7)
    m = 3 * L
    items = rng.normal(size=(m, 16)).astype(np.float32)
    v = rng.normal(size=16).astype(np.float32)
    q = (v + 0.1 * rng.normal(size=(4, 16))).astype(np.float32)
    planted = [3, 5, L - 1]
    for j in planted:
        items[j] = items[j + L] = v
        items[j + 2 * L] = 2 * v
    mask, bound = None, m
    if case == "masked":
        mask = np.ones(m, bool)
        mask[[j + 2 * L for j in planted]] = False
    elif case == "bounded":
        bound = 2 * L + 3
    jv, ji = jfused.binned_candidates(
        jnp.asarray(q), jfused.pack_catalog(jnp.asarray(items), L), m,
        num_bins=L, valid_count=None if bound == m else jnp.int32(bound),
        item_mask=None if mask is None else jnp.asarray(mask))
    tv, ti = tkernel.fused_scan_plain(
        torch.from_numpy(q).to(torch.bfloat16),
        tfused.pack_catalog(torch.from_numpy(items), L), L, bound,
        None if mask is None else torch.from_numpy(mask))
    _assert_candidates(tv, ti, jv, ji)
    for j in planted:
        lead = j + 2 * L if case == "better" else j
        assert (ti[:, j] == lead).all() and (ti[:, L + j] == j + L).all()


@pytest.mark.parametrize("bins", [128, 4096])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 16, 57, 63, 64, 65, 128, 200,
                               256, 513])
def test_launch_plan_covers_each_query_once(b, bins):
    plan = tkernel.launch_plan(b, bins)
    c, (gx, gy) = plan.cluster, plan.grid
    assert 1 <= c <= 8 and gx % c == 0 and gy == bins // 32
    if b <= 8:
        assert c == 1
    # each cluster reads the catalog once for up to 64 queries
    assert plan.passes == -(-b // 64) == gx // c
    # CTA x holds queries 8x..8x+7 below B: each query in exactly one CTA
    # of each bin tile, and only the last cluster holds CTAs without one
    held = [q for x in range(gx) for q in range(8 * x, min(8 * x + 8, b))]
    assert held == list(range(b))
    empty = [x for x in range(gx) if 8 * x >= b]
    assert all(x // c == plan.passes - 1 for x in empty)


@pytest.mark.parametrize("b,bins", [(0, 128), (8, 0), (8, 100)])
def test_launch_plan_refuses_what_no_grid_holds(b, bins):
    with pytest.raises(ValueError):
        tkernel.launch_plan(b, bins)
