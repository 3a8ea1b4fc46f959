"""Row gather and pooled lookup in the port against the JAX Pallas kernel.

The JAX side runs ``_pool_kernel`` through the Pallas interpreter, as
``tests/test_pallas_lookup.py`` runs it (``gather_rows(..., interpret=True)``
and ``fused_lookup_pool_interpret``); its backward is the reference's
``_fused_bwd``. The port runs its plain PyTorch version (the CPU path of
``kernels/gather_pool.py``).

Tolerances: a K=1 gather copies rows, so it is EXACTLY equal. Pooled sums
and means of K=5 float32 rows may add in another order: 1e-6 relative and
absolute. The backward scatter-adds per-slot gradients, duplicates summed
in another order: 1e-6.

The launch plan (``kernels/gather_pool.py`` ``launch_plan``) is checked
by walking its grid in Python as ``csrc/gather_pool.cu`` walks it: every
(CTA, warp, lane, row slot) to the (row, piece) it reads and writes,
each output piece exactly once, at batches around a warp's pass and at
the flagship step's 76,288 ids, on 132 and on 16 SMs.

Clamped ids are compared at D=128 only: at D < 128 the TPU kernel reads a
128-lane physical row and picks the id's lane slot, so an out-of-range id
lands on another logical row there; the port clamps the logical id, which
is the behaviour the reference states (``ops/lookup.py:66-69``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.ops import lookup as jlookup
from esrecsys_tpu_torch.kernels import gather_pool as tkernel
from esrecsys_tpu_torch.ops import lookup as tlookup


def _table(rows, d, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32)


@pytest.mark.parametrize("d", [32, 128])
def test_gather_rows_exact(d):
    table = _table(96, d)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 96, 50).astype(np.int32)
    ids[:6] = [5, 5, 5, 0, 95, 95]  # duplicates and both ends
    want = np.asarray(jlookup.gather_rows(jnp.asarray(table),
                                          jnp.asarray(ids), block_b=8,
                                          interpret=True))
    got = tlookup.gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_gather_rows_masks_minus_one_and_clamps():
    table = _table(64, 128)
    ids = np.array([-1, 3, 64, 1000, -7, 63], np.int32)
    want = np.asarray(jlookup.gather_rows(jnp.asarray(table),
                                          jnp.asarray(ids), block_b=8,
                                          interpret=True))
    got = tlookup.gather_rows(torch.from_numpy(table),
                              torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.zeros(128, np.float32))
    np.testing.assert_array_equal(got[2], table[63])  # clamped high
    np.testing.assert_array_equal(got[4], table[0])   # clamped low


@pytest.mark.parametrize("pool", ["sum", "mean"])
@pytest.mark.parametrize("d,clamped", [(32, False), (128, True)])
def test_pool_matches_jax_kernel(pool, d, clamped):
    table = _table(96, d, seed=2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 96, (16, 5)).astype(np.int32)
    ids[0] = [7, 7, 7, 0, 0]        # duplicates and masked slots
    ids[1] = [0, 0, 0, 0, 0]        # every slot masked: count 0
    if clamped:
        ids[2] = [-4, 96, 500, 1, 2]
    want = np.asarray(jlookup.fused_lookup_pool_interpret(
        jnp.asarray(table), jnp.asarray(ids), pool=pool, mask_id=0))
    got = tlookup.fused_lookup_pool(torch.from_numpy(table),
                                    torch.from_numpy(ids), pool=pool,
                                    mask_id=0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], np.zeros(d, np.float32))


@pytest.mark.parametrize("pool", ["sum", "mean"])
def test_pool_backward_matches_fused_bwd(pool):
    table = _table(40, 16, seed=4)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 40, (12, 4)).astype(np.int32)
    ids[0] = [9, 9, 0, 9]           # duplicates beside a masked slot
    g = rng.normal(size=(12, 16)).astype(np.float32)
    want, _ = jlookup._fused_bwd(pool, 0, 8, ((40, 16), jnp.asarray(ids)),
                                 jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    out = tlookup.fused_lookup_pool(t, torch.from_numpy(ids), pool=pool,
                                    mask_id=0)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gather_rows_backward_scatters_duplicates():
    table = torch.zeros(10, 4, requires_grad=True)
    ids = torch.tensor([3, 3, 7, -1], dtype=torch.int32)
    out = tlookup.gather_rows(table, ids)
    out.backward(torch.ones(4, 4))
    want = torch.zeros(10, 4)
    want[3] = 2.0
    want[7] = 1.0   # the masked -1 slot adds nothing
    assert torch.equal(table.grad, want)


def test_plain_is_taken_on_cpu_without_launch():
    before = tkernel.LAUNCHES.count
    tkernel.gather_pool(torch.ones(4, 8), torch.zeros(3, 1,
                                                      dtype=torch.int32))
    assert tkernel.LAUNCHES.count == before


def test_empty_batch_and_no_slots():
    table = torch.ones(5, 8)
    assert tkernel.gather_pool(table, torch.zeros(0, 1, dtype=torch.int32)
                               ).shape == (0, 8)
    out = tkernel.gather_pool(table, torch.zeros(3, 0, dtype=torch.int32),
                              mean=True)
    assert torch.equal(out, torch.zeros(3, 8))


def test_check_rejects_bad_inputs():
    with pytest.raises(TypeError):
        tkernel.gather_pool(torch.ones(4, 8, dtype=torch.float64),
                            torch.zeros(2, 1, dtype=torch.int32))
    with pytest.raises(TypeError):
        tkernel.gather_pool(torch.ones(4, 8), torch.zeros(2, 1))
    with pytest.raises(ValueError):
        tkernel.gather_pool(torch.ones(4, 8), torch.zeros(2,
                                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="pool"):
        tlookup.fused_lookup_pool(torch.ones(4, 8),
                                  torch.zeros(2, 1, dtype=torch.int32),
                                  pool="max")


# ---- the launch plan: a walk of its grid as the kernel walks it

PLAN_BATCHES = (1, 31, 32, 33, 777, 76_288)
PLAN_DIMS = (1, 4, 8, 32, 64, 128, 256)
PLAN_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _walk(plan, batch):
    """Per output piece (row * pieces + piece), how many lanes of the
    plan's grid write it, following csrc/gather_pool.cu: warp w = CTA c's
    warp i at c * warps_per_cta + i takes pass w if w < passes; lane l's
    u-th virtual row of pass p is v = p * rows_per_pass + u * groups +
    l // lanes, its piece (v % segments) * lanes + l % lanes of row
    v // segments. Also checks that a shared id's source lane lies in the
    pass's one coalesced load of 32 ids."""
    wpc = plan.threads // 32
    cta = np.arange(plan.ctas)[:, None]
    warp = np.arange(wpc)[None, :]
    p = (cta * wpc + warp).reshape(-1)
    p = p[p < plan.passes].astype(np.int64)
    lane = np.arange(32)
    grp, pl = lane // plan.lanes, lane % plan.lanes
    u = np.arange(plan.rows_per_lane)
    v = (p[:, None, None] * plan.rows_per_pass
         + u[None, :, None] * plan.groups + grp[None, None, :])
    row, seg = v // plan.segments, v % plan.segments
    piece = seg * plan.lanes + pl[None, None, :]
    live = ((grp < plan.groups)[None, None, :] & (v < batch * plan.segments)
            & (piece < plan.pieces))
    if plan.groups < 32:  # one coalesced load of the pass's ids
        row0 = (p * plan.rows_per_pass) // plan.segments
        src = row - row0[:, None, None]
        assert ((src >= 0) & (src < 32))[live].all()
    flat = row[live] * plan.pieces + piece[live]
    return np.bincount(flat, minlength=batch * plan.pieces)


def _plan_checks(plan, batch):
    wpc = plan.threads // 32
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.rows_per_lane in (1, 2, 4, 8)
    assert plan.groups == 32 or plan.groups * plan.rows_per_lane <= 32
    # a warp for every pass, and a pass for every CTA
    assert plan.ctas * wpc >= plan.passes
    assert (plan.ctas - 1) * wpc < plan.passes
    assert plan.passes * plan.rows_per_pass >= batch * plan.segments


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("dim", PLAN_DIMS)
@pytest.mark.parametrize("batch", PLAN_BATCHES)
def test_launch_plan_covers_every_piece_once(batch, dim, dtype, sms):
    plan = tkernel.launch_plan(dim, PLAN_DTYPES[dtype], 1 << 20, batch, 1,
                               sms)
    _plan_checks(plan, batch)
    counts = _walk(plan, batch)
    assert counts.shape == (batch * plan.pieces,)
    assert (counts == 1).all()


@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("dim", [1, 3, 32, 36, 256])
@pytest.mark.parametrize("batch", [1, 33, 777])
def test_pooled_launch_plan_covers_every_piece_once(batch, dim, dtype):
    # K != 1 takes one row a lane; dims 3 and 36 take the narrow kind
    plan = tkernel.launch_plan(dim, PLAN_DTYPES[dtype], 1 << 20, batch, 5,
                               132)
    assert plan.rows_per_lane == 1
    _plan_checks(plan, batch)
    assert (_walk(plan, batch) == 1).all()


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("dim", PLAN_DIMS)
@pytest.mark.parametrize("batch", [1, 31, 33, 99, 192, 777])
def test_small_launch_spans_the_promised_ctas(batch, dim, sms):
    plan = tkernel.launch_plan(dim, torch.float32, 1 << 20, batch, 1, sms)
    # warps the launch needs at one row a lane
    needed = -(-(batch * plan.segments) // plan.groups)
    assert plan.ctas >= min(needed, sms)
    if plan.passes < sms:
        assert plan.threads == 32 and plan.ctas == plan.passes
        assert plan.rows_per_lane == 1 or needed < sms


def test_small_launch_at_the_url_shard_spreads_over_the_card():
    # 192 ids of 64 floats: 12 CTAs of 256 threads in the previous design
    plan = tkernel.launch_plan(64, torch.float32, 1 << 20, 192, 1, 132)
    assert plan.ctas >= 48 and plan.threads == 32


def test_large_launch_gives_each_warp_one_pass():
    # the IVF probe's 3,924,480 rows of 64 floats: 16 rows a pass (two a
    # warp instruction, U = 8), eight warps a CTA, one pass each
    plan = tkernel.launch_plan(64, torch.float32, 1 << 20, 3_924_480, 1,
                               132)
    assert (plan.threads, plan.rows_per_lane) == (256, 8)
    assert plan.passes == 3_924_480 // 16
    assert plan.ctas == plan.passes // 8


# (dim, dtype, rows a lane): 32 rows a pass for rows of 128 bytes or
# more, 16 under, one a lane for rows of one piece
@pytest.mark.parametrize("dim,dtype,u", [
    (32, "f32", 8), (64, "f32", 8), (256, "f32", 8), (16, "f32", 2),
    (4, "f32", 1), (32, "bf16", 2), (64, "bf16", 8), (8, "bf16", 1),
    (1, "f32", 1), (3, "bf16", 1), (12, "f32", 1)])
def test_rows_in_flight_by_row_width(dim, dtype, u):
    plan = tkernel.launch_plan(dim, PLAN_DTYPES[dtype], 1 << 20, 1 << 20,
                               1, 132)
    assert plan.rows_per_lane == u


def test_instantiation_numbers_and_names_unchanged():
    assert (tkernel.F32X4, tkernel.BF16X8, tkernel.NARROW_F32,
            tkernel.NARROW_BF16) == (0, 1, 2, 3)
    assert tkernel.INSTANTIATIONS == {0: "f32x4", 1: "bf16x8",
                                      2: "narrow_f32", 3: "narrow_bf16"}


def test_launch_plan_is_pure_and_refuses_empty_launches():
    args = (32, torch.float32, 1 << 20, 76_288, 1, 132)
    assert tkernel.launch_plan(*args) == tkernel.launch_plan(*args)
    with pytest.raises(ValueError):
        tkernel.launch_plan(32, torch.float32, 1 << 20, 0)
