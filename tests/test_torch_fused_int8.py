"""The int8 fused scan (quantized serving's scan copy) in the port against
the JAX package: ``pack_catalog_codes`` / ``pack_catalog_int8``, the int8
branch of ``binned_candidates`` (the JAX Pallas kernel through its
interpreter, as ``tests/test_fused.py`` runs it; the port's plain version
of ``kernels/fused_scan.py``'s int8 kernel), and ``binned_topk_over_matrix``
with ``item_scales`` and ``rescore_scales``.

Tolerances: candidate values within 1e-5 absolute and relative. Both sides
multiply the same bf16 query by the same int8 codes exactly, sum in float32
in another order, then multiply by the same float32 scale. Ids equal, except
in slots whose two competing items score within that tolerance (a near-tie
the two summation orders may break apart). Top-k values after the float32
rescore within 1e-5 relative, ids equal except near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.retrieval import fused as jfused
from esrecsys_tpu.retrieval import mips as jmips
from esrecsys_tpu_torch.kernels import fused_scan as tkernel
from esrecsys_tpu_torch.retrieval import fused as tfused
from esrecsys_tpu_torch.retrieval import mips as tmips

TOL = 1e-5


def _data(seed=0, b=5, d=16, m=3000):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _int8_score(q, codes, scales, g):
    """float32 score of queries q (n, D) against catalog columns g (n,)."""
    qb = torch.from_numpy(q).to(torch.bfloat16).float()
    return (qb * codes[:, g].T.float()).sum(-1) * scales[g]


def _assert_candidates(q, codes, scales, tv, ti, jv, ji):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tvn, tin = tv.numpy(), ti.numpy()
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tvn), fin)
    np.testing.assert_allclose(tvn[fin], jv[fin], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tin[~fin], ji[~fin])
    diff = (tin != ji) & fin
    if diff.any():
        b, _ = np.nonzero(diff)
        gap = (_int8_score(q[b], codes, scales, torch.from_numpy(tin[diff]))
               - _int8_score(q[b], codes, scales, torch.from_numpy(ji[diff])))
        assert bool((gap.abs() <= TOL).all()), f"{int(diff.sum())} ids differ"


@pytest.mark.parametrize("m,bins", [(300, 128), (1000, 128), (4096, 4096),
                                    (777, 384)])
def test_pack_catalog_codes_matches_jax(m, bins):
    _, items = _data(m=m)
    q8, s8 = jmips.quantize_rows(jnp.asarray(items))
    jcodes, jbinned = jfused.pack_catalog_codes(q8, s8, num_bins=bins)
    tcodes, tflat = tfused.pack_catalog_codes(
        torch.from_numpy(np.array(q8)), torch.from_numpy(np.array(s8)),
        num_bins=bins)
    assert tcodes.dtype == torch.int8 and tcodes.is_contiguous()
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    # flat scales: the reference's (ceil8(Mp/L), L) rows, reshaped
    mp = tcodes.shape[1]
    assert tflat.shape == (mp,) and tflat.dtype == torch.float32
    np.testing.assert_array_equal(tflat.numpy(),
                                  np.asarray(jbinned).reshape(-1)[:mp])
    assert not tflat[m:].any() and not tcodes[:, m:].any()   # padding is 0
    pc, ps = tfused.pack_catalog_int8(torch.from_numpy(items), num_bins=bins)
    assert torch.equal(pc, tcodes) and torch.equal(ps, tflat)


# (B, M, L, valid_count, with_mask): ragged M, B not a multiple of 8, a
# valid-count bound, an eligibility mask, one block, many blocks
CASES = [
    (5, 3000, 128, None, False),
    (5, 3000, 128, 2900, True),
    (3, 1000, 256, None, True),
    (11, 2049, 128, 1500, False),
    (1, 200, 128, None, False),
    (8, 777, 384, 700, True),
]


@pytest.mark.parametrize("b,m,bins,valid,with_mask", CASES)
def test_int8_candidates_match_jax_kernel(b, m, bins, valid, with_mask):
    q, items = _data(seed=m + b, b=b, m=m)
    mask = np.random.default_rng(1).random(m) > 0.4 if with_mask else None
    jcodes, jscales = jfused.pack_catalog_int8(jnp.asarray(items), bins)
    jv, ji = jfused.binned_candidates(
        jnp.asarray(q), jcodes, m, num_bins=bins, item_scales=jscales,
        valid_count=None if valid is None else jnp.int32(valid),
        item_mask=None if mask is None else jnp.asarray(mask))
    codes, scales = tfused.pack_catalog_int8(torch.from_numpy(items), bins)
    before = tkernel.LAUNCHES_INT8.count
    tv, ti = tfused.binned_candidates(
        torch.from_numpy(q), codes, m, num_bins=bins, valid_count=valid,
        item_scales=scales,
        item_mask=None if mask is None else torch.from_numpy(mask))
    assert tkernel.LAUNCHES_INT8.count == before   # the CPU takes the plain
    assert tv.shape == (b, 2 * bins) and ti.dtype == torch.int32
    _assert_candidates(q, codes, scales, tv, ti, jv, ji)


def test_int8_duplicate_items_earlier_block_wins():
    q, items = _data(b=8, m=1024)
    L = 128
    first, second, third = 5 + L, 5 + 3 * L, 5 + 5 * L
    items[first] *= 3
    items[second] = items[third] = items[first]
    jcodes, jscales = jfused.pack_catalog_int8(jnp.asarray(items), L)
    jv, ji = jfused.binned_candidates(jnp.asarray(q), jcodes, 1024,
                                      num_bins=L, item_scales=jscales)
    codes, scales = tfused.pack_catalog_int8(torch.from_numpy(items), L)
    tv, ti = tfused.binned_candidates(torch.from_numpy(q), codes, 1024,
                                      num_bins=L, item_scales=scales)
    _assert_candidates(q, codes, scales, tv, ti, jv, ji)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    best, runner_up = ti[:, 5], ti[:, L + 5]
    assert (best == first).any()
    assert not (best == third).any() and not (runner_up == third).any()


@pytest.mark.parametrize("k,m,bins,r8", [(10, 200, 256, False),
                                         (20, 1000, 128, False),
                                         (50, 3000, 128, True),
                                         (64, 50, 128, True),
                                         (500, 2000, 256, False)])
def test_int8_binned_topk_matches_jax(k, m, bins, r8):
    q, items = _data(seed=k, b=6, m=m)
    jcodes, jscales = jfused.pack_catalog_int8(jnp.asarray(items), bins)
    q8, s8 = jmips.quantize_rows(jnp.asarray(items))
    jv, ji = jfused.binned_topk_over_matrix(
        jnp.asarray(q), q8 if r8 else jnp.asarray(items), k, num_bins=bins,
        items_packed=jcodes, item_scales=jscales,
        rescore_scales=s8 if r8 else None)
    t8, ts = tmips.quantize_rows(torch.from_numpy(items))
    codes, scales = tfused.pack_catalog_codes(t8, ts, bins)
    tv, ti = tfused.binned_topk_over_matrix(
        torch.from_numpy(q), t8 if r8 else torch.from_numpy(items), k,
        num_bins=bins, items_packed=codes, item_scales=scales,
        rescore_scales=ts if r8 else None)
    assert tv.shape == (6, k) and ti.dtype == torch.int64
    jv, ji = np.asarray(jv), np.asarray(ji)
    tvn, tin = tv.numpy(), ti.numpy()
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tvn), fin)
    np.testing.assert_allclose(tvn[fin], jv[fin], rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(tin[~fin], 0)
    rows = (t8.float() * ts[:, None]).numpy() if r8 else items
    diff = (tin != ji) & fin
    b, _ = np.nonzero(diff)
    s_t = (rows[tin[diff]] * q[b]).sum(-1)
    s_j = (rows[ji[diff]] * q[b]).sum(-1)
    assert np.all(np.abs(s_t - s_j) <= TOL * np.abs(s_j) + 1e-6)


def test_int8_composes_with_mask_and_valid_count():
    q, items = _data(m=500)
    rng = np.random.default_rng(3)
    mask = rng.random(500) < 0.5
    jcodes, jscales = jfused.pack_catalog_int8(jnp.asarray(items), 512)
    jv, ji = jfused.binned_topk_over_matrix(
        jnp.asarray(q), jnp.asarray(items), 10, num_bins=512,
        items_packed=jcodes, item_scales=jscales,
        item_mask=jnp.asarray(mask), valid_count=jnp.int32(400))
    codes, scales = tfused.pack_catalog_int8(torch.from_numpy(items), 512)
    tv, ti = tfused.binned_topk_over_matrix(
        torch.from_numpy(q), torch.from_numpy(items), 10, num_bins=512,
        items_packed=codes, item_scales=scales,
        item_mask=torch.from_numpy(mask), valid_count=400)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for v, i in zip(tv.numpy().ravel(), ti.numpy().ravel()):
        if np.isfinite(v):
            assert mask[i] and i < 400


def test_int8_rescore_requires_scales_like_reference():
    q, items = _data(m=200)
    codes, scales = tfused.pack_catalog_int8(torch.from_numpy(items), 256)
    q8 = torch.from_numpy(np.clip(items * 10, -127, 127).astype(np.int8))
    with pytest.raises(ValueError, match="rescore_scales"):
        tfused.binned_topk_over_matrix(torch.from_numpy(q), q8, 10,
                                       num_bins=256, items_packed=codes,
                                       item_scales=scales)
    with pytest.raises(ValueError, match="int8"):
        tfused.binned_topk_over_matrix(
            torch.from_numpy(q), torch.from_numpy(items), 10, num_bins=256,
            items_packed=codes, item_scales=scales,
            rescore_scales=torch.ones(200))


def test_int8_layout_validation_like_reference():
    q, items = _data()
    m = items.shape[0]
    codes, scales = tfused.pack_catalog_int8(torch.from_numpy(items), 128)
    packed_f = tfused.pack_catalog(torch.from_numpy(items), 128)
    with pytest.raises(ValueError, match="int8"):   # scales need int8 codes
        tfused.binned_candidates(torch.from_numpy(q), packed_f, m,
                                 num_bins=128, item_scales=scales)
    with pytest.raises(ValueError, match="item_scales"):   # wrong length
        tfused.binned_candidates(torch.from_numpy(q), codes, m,
                                 num_bins=128, item_scales=scales[:64])
    with pytest.raises(ValueError, match="item_scales"):   # codes, no scales
        tfused.binned_candidates(torch.from_numpy(q), codes, m, num_bins=128)


def test_int8_plain_version_checks_its_inputs():
    q = torch.zeros((2, 16), dtype=torch.bfloat16)
    codes = torch.zeros((16, 256), dtype=torch.int8)
    scales = torch.zeros(256)
    with pytest.raises(TypeError):
        tkernel.fused_scan_int8(q, codes.to(torch.bfloat16), scales, 128, 256)
    with pytest.raises(ValueError, match="scales"):
        tkernel.fused_scan_int8(q, codes, torch.zeros(255), 128, 256)
    with pytest.raises(ValueError, match="scales"):
        tkernel.fused_scan_int8(q, codes, scales.double(), 128, 256)
    vals, ids = tkernel.fused_scan_int8(q, codes, scales, 128, 0)
    assert not torch.isfinite(vals).any() and not ids.any()


def test_int8_non_cpu_tensors_never_take_the_plain_version():
    q = torch.zeros((2, 16), dtype=torch.bfloat16, device="meta")
    codes = torch.zeros((16, 256), dtype=torch.int8, device="meta")
    scales = torch.zeros(256, device="meta")
    before = tkernel.LAUNCHES_INT8.count
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.fused_scan_int8(q, codes, scales, 128, 256)
    assert tkernel.LAUNCHES_INT8.count == before
