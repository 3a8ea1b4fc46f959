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
