"""Row scatter-add in the port against the JAX package.

The JAX side is ``scatter_add_rows(..., precision="f32", interpret=True)``
(the Pallas kernel through its interpreter, as ``tests/test_scatter.py``
runs it) and XLA's ``table.at[ids].add``. The port runs its plain PyTorch
version (the CPU path of ``kernels/scatter_add.py``).

At D=4 and D=6, the widths the kernel's generic instantiation takes, the
JAX side is the Pallas kernel in interpret mode (4 divides 128) and XLA's
``at[].add``, which ``scatter_add_rows`` takes itself when D does not
divide 128. The launch plan (which instantiation for which width and
pointer alignment, and the grid) is pure Python and is tested here; the
instantiations themselves run on the card only, in ``chip_smoke.py``.

Tolerances: against ``at[].add``, 1e-6 relative and absolute for random
ids (at most a few duplicates per row, summed in another order). Against
the Pallas kernel, 1e-5: its "f32" mode splits each update into three bf16
terms whose products it sums, each rounded on its own. The pile-up case adds
450 unit normals into one row; partial sums reach about 20, so orders of
summation may differ by about 1e-4: 2e-4 against XLA, 1e-3 against the
kernel (the tolerance of ``tests/test_scatter.py:22``).

``vmem_scatter_add`` (the port of ``vmem_scatter_add_phys``, through the
plain version of ``kernels/smem_scatter.py``) is held against the JAX
Pallas kernel in interpret mode, as ``tests/test_scatter.py:75`` runs it,
within the same 1e-5: both add unit-normal rows into a unit-normal table,
one serially, one in PyTorch's order. Its CTA-edge inputs put ids at both
edges of the CTA row ranges of the kernel's H100 plan (H100 figures apply
on the CPU): each id once, where both versions compute ``table + u`` and
the port must equal ``np.add.at`` bit for bit, and three times, the
duplicates of the rows on both sides of a boundary summed in other orders
(1e-5 as above). On the CPU these run the plain version, which knows
nothing of CTA ranges: the kernel's own binning and write-back at those
edges are checked on the card only, by ``chip_smoke.py``'s
``check_smem_scatter``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrecsys_tpu.ops.scatter import scatter_add_rows as jax_scatter
from esrecsys_tpu.ops.scatter import vmem_scatter_add_phys
from esrecsys_tpu_torch.kernels import scatter_add as tkernel
from esrecsys_tpu_torch.kernels import smem_scatter as tsmem
from esrecsys_tpu_torch.ops.scatter import scatter_add_rows, vmem_scatter_add


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


@pytest.mark.parametrize("dim,blk", [(32, 16), (64, 32), (128, 64), (4, 16),
                                     (6, 16)])
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


# (width, table and updates pointers) -> the instantiation; 0 is generic
@pytest.mark.parametrize("dim,table_ptr,upd_ptr,width", [
    (32, 1 << 20, 2 << 20, 32), (64, 512, 1024, 64), (128, 16, 48, 128),
    (32, 1 << 20, (2 << 20) + 4, 0), (64, (1 << 20) + 8, 1 << 21, 0),
    (4, 1 << 20, 2 << 20, 0), (6, 1 << 20, 2 << 20, 0),
    (16, 1 << 20, 2 << 20, 0), (256, 1 << 20, 2 << 20, 0)],
    ids=["d32", "d64", "d128", "d32_updates_off_16", "d64_table_off_16",
         "d4", "d6", "d16", "d256"])
def test_launch_plan_picks_the_instantiation(dim, table_ptr, upd_ptr, width):
    assert tkernel.launch_plan(777, dim, table_ptr, upd_ptr)[0] == width


# (n, width, CTAs): 8 warps a CTA, 8 rows (vector) or floats (generic) a
# lane; the step's 76,288 rows of 32 floats take 298 CTAs of 256 rows
@pytest.mark.parametrize("n,dim,blocks", [
    (76_288, 32, 298), (1, 32, 1), (256, 32, 1), (257, 32, 2),
    (777, 64, 7), (10_000, 128, 157), (777, 4, 2), (10_000, 6, 30),
    (1, 6, 1)])
def test_launch_plan_grid_gives_each_warp_one_pass(n, dim, blocks):
    width, got = tkernel.launch_plan(n, dim, 0, 0)
    assert got == blocks
    per_cta = (tkernel.THREADS // 32 * (32 // (dim // 4)) * tkernel.PER_LANE
               if width else tkernel.THREADS * tkernel.PER_LANE)
    work = n if width else n * dim
    assert (blocks - 1) * per_cta < work <= blocks * per_cta


def test_scatter_add_non_cpu_tensors_never_take_the_plain_version():
    before = tkernel.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.scatter_add(torch.zeros(4, 8, device="meta"),
                            torch.zeros(2, dtype=torch.int32, device="meta"),
                            torch.ones(2, 8, device="meta"))
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


# the H100 plan of a (1004, 32) table: 126 CTAs of 8 rows, the last 4
EDGE_ROWS = 1004


def _plan_edge_ids(R, dim, step, dup):
    """Each id ``dup`` times, shuffled: the first and last rows of every
    ``step``-th CTA of the H100 plan and of its last, and the row before
    each first."""
    ctas, per = tsmem.smem_plan(R, dim, tsmem.H100_SMS,
                                tsmem.H100_SMEM_PER_BLOCK)
    assert (ctas, per) == (126, 8) and R - (ctas - 1) * per == 4
    owners = sorted(set(range(0, ctas, step)) | {ctas - 1})
    edges = sorted({e for c in owners
                    for e in (c * per - 1, c * per, min(R, c * per + per) - 1)
                    if e >= 0})
    ids = np.random.default_rng(step * 10 + dup).permutation(edges * dup)
    if step > 1:  # some CTAs get no id
        assert len(set((ids // per).tolist())) < ctas
    return ids.astype(np.int32)


# (rows, ids): 700 random ids, then ids at the H100 plan's CTA edges
@pytest.mark.parametrize("R,edges", [
    (512, None), (EDGE_ROWS, (1, 1)), (EDGE_ROWS, (1, 3)),
    (EDGE_ROWS, (3, 1)), (EDGE_ROWS, (10_000, 1))],
    ids=["random", "every_edge", "duplicates_across_edges", "empty_owners",
         "ragged_last"])
def test_vmem_scatter_matches_jax_interpret(R, edges):
    dim = 32
    ids = None if edges is None else _plan_edge_ids(R, dim, *edges)
    table, ids, upd = _case(R, 700, dim, seed=3, ids=ids)
    pack = 128 // dim
    want = np.asarray(vmem_scatter_add_phys(
        jnp.asarray(table).reshape(R // pack, 128), jnp.asarray(ids),
        jnp.asarray(upd), dim, chunk=256, interpret=True)).reshape(R, dim)
    t = torch.from_numpy(table.copy())
    before = tsmem.LAUNCHES.count
    out = vmem_scatter_add(t, torch.from_numpy(ids), torch.from_numpy(upd))
    assert out is t and tsmem.LAUNCHES.count == before
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    if edges is not None and edges[1] == 1:
        exact = table.copy()
        np.add.at(exact, ids, upd)
        np.testing.assert_array_equal(out.numpy(), exact)


def test_smem_scratch_holds_pairs_and_per_chunk_counts():
    ctas, _ = tsmem.smem_plan(100_096, 32, tsmem.H100_SMS,
                              tsmem.H100_SMEM_PER_BLOCK)
    # two int32 per id, a count and an offset per (owner, chunk)
    assert tsmem.scratch_size(76_288, ctas) == 2 * 76_288 + 2 * ctas * ctas
    # about 0.75 MB at the train step's shape
    assert tsmem.scratch_size(76_288, ctas) * 4 < 800_000


@pytest.mark.parametrize("rows,dim", [(295_936, 32), (40_000, 256)])
def test_vmem_scatter_rejects_tables_past_shared_memory(rows, dim):
    # the flagship artist table, and the reference's rejected (40,000, 128)
    # physical table at twice its width: neither fits 132 x 232,448 B
    with pytest.raises(ValueError, match="shared memory"):
        vmem_scatter_add(torch.zeros(rows, dim),
                         torch.zeros(8, dtype=torch.int32),
                         torch.zeros(8, dim))


def test_smem_plan_holds_the_album_table_in_one_wave():
    ctas, per_cta = tsmem.smem_plan(100_096, 32, tsmem.H100_SMS,
                                    tsmem.H100_SMEM_PER_BLOCK)
    assert ctas <= tsmem.H100_SMS and ctas * per_cta >= 100_096
    assert per_cta * 32 * 4 <= tsmem.H100_SMEM_PER_BLOCK
    assert tsmem.smem_budget(torch.device("cpu")) == (132, 232_448)


# the plans chip_smoke.py's CTA-edge checks run on the card: (rows, dim,
# CTAs, rows per CTA, rows of the ragged last CTA)
@pytest.mark.parametrize("rows,dim,ctas,per,last", [
    (50_003, 3, 132, 379, 354), (100_096, 32, 132, 759, 667),
    (50_003, 64, 132, 379, 354)])
def test_smem_plan_cuts_each_row_to_one_cta(rows, dim, ctas, per, last):
    assert tsmem.smem_plan(rows, dim, tsmem.H100_SMS,
                           tsmem.H100_SMEM_PER_BLOCK) == (ctas, per)
    # every CTA's range is whole but the last, which is ragged, not empty
    assert rows - (ctas - 1) * per == last and 0 < last < per


def test_vmem_scatter_drops_out_of_range_ids():
    table = torch.zeros(6, 4)
    ids = torch.tensor([1, 1, -1, 6, 100, 5], dtype=torch.int64)
    upd = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    vmem_scatter_add(table, ids, upd)
    want = torch.zeros(6, 4)
    want[1] = upd[0] + upd[1]
    want[5] = upd[5]
    assert torch.equal(table, want)


def test_vmem_scatter_pileup_matches_xla():
    table, ids, upd = _case(300, 450, 32, seed=1, ids=[5] * 450)
    got = vmem_scatter_add(torch.from_numpy(table.copy()),
                           torch.from_numpy(ids),
                           torch.from_numpy(upd)).numpy()
    xla = np.asarray(jnp.asarray(table).at[ids].add(upd))
    np.testing.assert_allclose(got, xla, rtol=2e-4, atol=2e-4)


def test_smem_scatter_non_cpu_tensors_never_take_the_plain_version():
    before = tsmem.LAUNCHES.count
    with pytest.raises(ValueError, match="CUDA"):
        tsmem.smem_scatter(torch.zeros(4, 8, device="meta"),
                           torch.zeros(2, dtype=torch.int32, device="meta"),
                           torch.ones(2, 8, device="meta"))
    assert tsmem.LAUNCHES.count == before


def test_scatter_attempt_tool_needs_a_card(monkeypatch):
    from esrecsys_tpu_torch.tools import scatter_attempt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        scatter_attempt.main(["--iters", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        scatter_attempt.measure(512, 1)

