"""Row scatter-add in the port against the JAX package.

The JAX side is ``scatter_add_rows(..., precision="f32", interpret=True)``
(the Pallas kernel through its interpreter, as ``tests/test_scatter.py``
runs it) and XLA's ``table.at[ids].add``. The port runs its plain PyTorch
version (the CPU path of ``kernels/scatter_add.py``).

Tolerances: against ``at[].add``, 1e-6 relative and absolute for random
ids (at most a few duplicates per row, summed in another order). Against
the Pallas kernel, 1e-5: its "f32" mode splits each update into three bf16
terms whose products it sums, each rounded on its own. The pile-up case adds
450 unit normals into one row; partial sums reach about 20, so orders of
summation may differ by about 1e-4: 2e-4 against XLA, 1e-3 against the
kernel (the tolerance of ``tests/test_scatter.py:22``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.ops.scatter import scatter_add_rows as jax_scatter
from esrecsys_tpu_torch.kernels import scatter_add as tkernel
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows


def _case(R, N, dim, seed, ids=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, dim)).astype(np.float32)
    if ids is None:
        ids = rng.integers(0, R, N).astype(np.int32)
    upd = rng.normal(size=(len(ids), dim)).astype(np.float32)
    return table, np.asarray(ids, np.int32), upd


def _port(table, ids, upd):
    return scatter_add_rows(torch.from_numpy(table.copy()),
                            torch.from_numpy(ids),
                            torch.from_numpy(upd)).numpy()


@pytest.mark.parametrize("dim,blk", [(32, 16), (64, 32), (128, 64)])
def test_matches_jax_kernel_and_xla(dim, blk):
    table, ids, upd = _case(700, 900, dim, seed=dim)
    got = _port(table, ids, upd)
    xla = np.asarray(jnp.asarray(table).at[ids].add(upd))
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    kern = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(upd), block_rows=blk,
                                  precision="f32", interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


def test_duplicate_pileup():
    table, ids, upd = _case(300, 450, 32, seed=1, ids=[5] * 450)
    got = _port(table, ids, upd)
    xla = np.asarray(jnp.asarray(table).at[ids].add(upd))
    np.testing.assert_allclose(got, xla, rtol=2e-4, atol=2e-4)
    kern = np.asarray(jax_scatter(jnp.asarray(table), jnp.asarray(ids),
                                  jnp.asarray(upd), block_rows=16,
                                  precision="f32", interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(np.delete(got, 5, 0),
                                  np.delete(table, 5, 0))


def test_updates_in_place_and_drops_out_of_range_ids():
    table = torch.zeros(6, 4)
    ids = torch.tensor([1, 1, -1, 6, 100, 5], dtype=torch.int32)
    upd = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    out = scatter_add_rows(table, ids, upd)
    assert out is table
    want = torch.zeros(6, 4)
    want[1] = upd[0] + upd[1]
    want[5] = upd[5]
    assert torch.equal(table, want)


def test_plain_is_taken_on_cpu_without_launch():
    before = tkernel.LAUNCHES.count
    tkernel.scatter_add(torch.zeros(4, 8), torch.zeros(2, dtype=torch.int32),
                        torch.ones(2, 8))
    assert tkernel.LAUNCHES.count == before


def test_check_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tkernel.scatter_add(torch.zeros(4, 8),
                            torch.zeros(2, dtype=torch.int32),
                            torch.ones(3, 8))
    with pytest.raises(TypeError):
        tkernel.scatter_add(torch.zeros(4, 8), torch.zeros(2),
                            torch.ones(2, 8))
    with pytest.raises(TypeError):
        tkernel.scatter_add(torch.zeros(4, 8, dtype=torch.float64),
                            torch.zeros(2, dtype=torch.int32),
                            torch.ones(2, 8, dtype=torch.float64))
