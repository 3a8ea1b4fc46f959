"""The port's ``(data, model)`` grid (``core/mesh.py``) and row-sharded
tables (``parallel/table.py``, ``parallel/sharding.py``) on gloo ranks,
against the JAX package's mesh and tables.

The multi-rank cases run 2 ranks (a 1x2 grid) and 4 ranks (2x2) in
worker processes (``tests/torch_dist_workers.py``, joined with a deadline)
and hold them against the JAX package in this process, on a virtual CPU
mesh of the same shape from ``conftest.py``'s 8 devices: the same table
(drawn by JAX, given to the ranks whole, each keeping its shard), the
same ids and cotangents from numpy seeds.

Tolerance: lookups are exact (one shard contributes each row, the others
add zeros). Pooled sums of at most 5 rows: 1e-6 relative and absolute
(the two packages may add the K rows in another order, and a sum that
nearly cancels keeps little relative precision). The gradients are sums
of at most a few cotangent rows per table row: 1e-6 relative and
absolute.
"""

import os

import numpy as np
import pytest
import torch

from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.parallel import sharding
from esrecsys_tpu_torch.parallel import table as ptable

from torch_dist_workers import spawn

RTOL = ATOL = 1e-6


# ------------------------------------------------ one process (no group)

def test_mesh_arithmetic_on_one_process():
    assert not mesh_lib.is_initialized()
    m = mesh_lib.make_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert (m.data_index, m.model_index, m.rank) == (0, 0, 0)
    assert m.model_group is None and m.data_group is None
    assert list(m.row_range(6)) == list(range(6))
    t = torch.arange(3.0)
    assert m.sum_model(t) is t and m.gather_model(t) is t
    assert mesh_lib.single_device_mesh().shape == {"data": 1, "model": 1}
    assert mesh_lib.make_mesh_for_batch(4).shape == {"data": 1, "model": 1}
    assert mesh_lib.pad_to_multiple(10, 4) == 12
    assert mesh_lib.round_up_rows(10, m) == 10
    assert mesh_lib.local_batch(8, m) == 8
    assert mesh_lib.process_local_batch(6) == 6
    assert mesh_lib.process_local_files(["b", "a"]) == ["a", "b"]
    assert mesh_lib.shard_files_for_process(["b", "a", "c"]) == ["a", "b",
                                                                 "c"]
    assert mesh_lib.process_local_slice([3, 1]) == [3, 1]


@pytest.mark.parametrize("kw,match", [
    (dict(n_model=2), "1 ranks not divisible by n_model=2"),
    (dict(n_data=2, n_model=1), r"mesh 2x1 != 1 ranks"),
    (dict(n_data=1, n_model=1, ranks=[3]), "rank 0 is not in"),
])
def test_make_mesh_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        mesh_lib.make_mesh(**kw)


def test_owned_ids_and_row_range():
    m = mesh_lib.Mesh(n_data=2, n_model=3, ranks=tuple(range(6)), rank=4)
    assert (m.data_index, m.model_index) == (1, 1)
    assert m.row_range(12) == range(4, 8)
    assert m.model_peer(2) == 5
    ids = torch.tensor([0, 3, 4, 7, 8, 11])
    assert m.owned(ids, 4).tolist() == [-1, -1, 0, 3, -1, -1]
    assert m.owned(ids, 4).dtype == torch.int32
    with pytest.raises(ValueError, match="do not divide"):
        m.row_range(10)


@pytest.mark.parametrize("env,match", [
    ({"WORLD_SIZE": "2"}, "partial distributed coordinates"),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "1"},
     "partial distributed coordinates"),
    ({"RANK": "0", "WORLD_SIZE": "2"}, "partial distributed coordinates"),
])
def test_distributed_init_refuses_partial_coordinates(monkeypatch, env,
                                                      match):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        mesh_lib.distributed_init_if_needed(device="cpu")
    assert not mesh_lib.is_initialized()


def test_distributed_init_is_a_no_op_without_coordinates(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_lib.distributed_init_if_needed(device="cpu") is False
    assert not mesh_lib.is_initialized()
    assert mesh_lib.backend_for(torch.device("cpu")) == "gloo"
    assert mesh_lib.backend_for(torch.device("cuda")) == "nccl"


def test_model_groups_spanning_hosts_warn(caplog):
    assert not mesh_lib.warn_if_model_axis_spans_slices(
        np.array([["a", "a"], ["b", "b"]]))
    assert mesh_lib.warn_if_model_axis_spans_slices(
        np.array([["a", "b"], ["b", "b"]]))
    assert "spans hosts on 1/2 data rows" in caplog.text


def test_partition_rules_match_the_reference():
    from esrecsys_tpu.parallel import sharding as jsharding
    from jax.tree_util import DictKey

    leaves = {"album_embed/embedding": np.zeros((4, 2)),
              "token_table": np.zeros((4, 2)), "dense/kernel": np.zeros((4, 2)),
              "bias": np.zeros(4), "Embed_0/embedding": np.zeros((4, 2, 2))}
    for name, leaf in leaves.items():
        path = tuple(DictKey(p) for p in name.split("/"))
        want = tuple(jsharding.partition_spec_for(path, leaf))
        assert sharding.partition_spec_for(name, leaf) == want, name
        assert sharding.partition_spec_for(name.replace("/", "."),
                                           leaf) == want


def test_shard_tree_takes_the_rank_rows():
    m = mesh_lib.Mesh(n_data=1, n_model=2, ranks=(0, 1), rank=1)
    tree = {"album_embed": {"embedding": np.arange(8.0).reshape(4, 2)},
            "dense": {"kernel": np.ones((4, 2))}}
    out = sharding.shard_tree(tree, m)
    np.testing.assert_array_equal(out["album_embed"]["embedding"],
                                  [[4.0, 5.0], [6.0, 7.0]])
    assert out["dense"]["kernel"].shape == (4, 2)
    one = mesh_lib.make_mesh()
    t = {"x_table": torch.ones(2, 2)}
    assert sharding.gather_tree(t, one)["x_table"] is t["x_table"]


def test_lookup_without_a_mesh_and_its_guard():
    t = torch.arange(12.0).reshape(6, 2)
    ids = torch.tensor([[1, 5], [0, 0]])
    np.testing.assert_array_equal(ptable.lookup(t, ids).numpy(),
                                  t[ids].numpy())
    np.testing.assert_array_equal(
        ptable.lookup_pooled(t, ids, pool="mean").numpy(),
        np.stack([t[[1, 5]].mean(0).numpy(), np.zeros(2)]))
    with pytest.raises(ValueError, match="unknown strategy"):
        ptable.lookup(t, ids, strategy="gspmd")
    st = ptable.ShardedTable("t", num_rows=5, dim=3)
    assert st.padded_rows(None) == 5
    g = torch.Generator().manual_seed(0)
    assert st.init(g).shape == (5, 3)
    from esrecsys_tpu_torch.ops import guards

    guards.set_mode("error")
    try:
        with pytest.raises(ValueError, match="sharded_table"):
            ptable.lookup(t, torch.tensor([6]))
    finally:
        guards.set_mode("off")


# ------------------------------------------------ ranks: the grid itself

@pytest.mark.parametrize("world,n_model", [(2, 2), (4, 2)],
                         ids=["1x2", "2x2"])
def test_grid_collectives_on_gloo_ranks(tmp_path, world, n_model):
    outs = spawn("job_mesh", world, str(tmp_path),
                 {"n_model": n_model, "files": 3}, timeout=60)
    n_data = world // n_model
    for r, o in enumerate(outs):
        d, m = divmod(r, n_model)
        assert o["shape"] == {"data": n_data, "model": n_model}
        assert (o["data_index"], o["model_index"]) == (d, m)
        assert o["rows"] == list(range(8 * m, 8 * m + 8))
        row = [d * n_model + j for j in range(n_model)]
        col = [i * n_model + m for i in range(n_data)]
        assert o["sum_model"] == [float(sum(row))] * 2
        assert o["sum_data"] == [float(sum(col))] * 2
        assert o["mean_data"] == [sum(col) / n_data] * 2
        assert o["gather_model"] == [float(x) for x in row]
        assert o["gather_data"] == [float(x) for x in col]
        assert o["placed"] == [[x, 0] for x in row]
        assert o["local_batch"] == 8
        # files p::n, and the starvation guard when there are too few
        want = [f"f{i}" for i in range(3)][r::world] or [f"f{i}" for i in
                                                         range(3)]
        assert o["files"] == want
        assert o["slice"] == (list(range(3))[r::world] or [0, 1, 2])
        assert "does not divide over" in o["for_batch"]
        assert o["for_batch_ok"] == {"data": n_data, "model": n_model}


# ------------------------------------------------ ranks: table lookups

def _jax_lookups(n_data, n_model, table, ids, cot, cot_pooled):
    import jax
    import jax.numpy as jnp

    from esrecsys_tpu.core import mesh as jmesh
    from esrecsys_tpu.parallel import table as jtable
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmesh.make_mesh(n_data=n_data, n_model=n_model,
                           devices=jax.devices()[:n_data * n_model])
    jt = jax.device_put(jnp.asarray(table),
                        NamedSharding(mesh, P(jmesh.MODEL_AXIS, None)))
    jids = jnp.asarray(ids)
    out = {}
    for strategy in ("auto", "shard_map"):
        for pool in (None, "sum", "mean", "max"):
            if pool is None:
                f = lambda t: jtable.lookup(t, jids, mesh=mesh,  # noqa: E731
                                            strategy=strategy)
                c = jnp.asarray(cot)
            else:
                f = lambda t, p=pool: jtable.lookup_pooled(  # noqa: E731
                    t, jids, pool=p, mesh=mesh, strategy=strategy)
                c = jnp.asarray(cot_pooled)
            y, vjp = jax.vjp(f, jt)
            out[(strategy, pool)] = (np.asarray(y), np.asarray(vjp(c)[0]))
    return out


@pytest.mark.parametrize("world,n_model", [(2, 2), (4, 2)],
                         ids=["1x2", "2x2"])
def test_sharded_lookups_and_gradients_equal_the_jax_package(
        tmp_path, world, n_model):
    import jax

    from esrecsys_tpu.parallel import table as jtable

    n_data = world // n_model
    rng = np.random.default_rng(world)
    rows, dim, b, k = 700, 8, 32, 5
    table = np.asarray(jtable.init_table(jax.random.PRNGKey(3), rows, dim))
    ids = rng.integers(0, rows, (b, k)).astype(np.int32)
    ids[0, :] = ids[0, 0]            # duplicates within a row
    ids[1] = 0                        # the masked id for the pooled lookups
    ids[2, 0] = rows - 1              # the last row, on the last shard
    cot = rng.normal(size=(b, k, dim)).astype(np.float32)
    cot_pooled = rng.normal(size=(b, dim)).astype(np.float32)
    want = _jax_lookups(n_data, n_model, table, ids, cot, cot_pooled)
    outs = spawn("job_lookup", world, str(tmp_path / "ranks"),
                 {"n_model": n_model, "table": table, "ids": ids,
                  "cot": cot, "cot_pooled": cot_pooled}, timeout=60)
    per = rows // n_model
    for key, (wy, wg) in want.items():
        for o in outs:
            y, g = o[key]
            d, m = o["data_index"], o["model_index"]
            rb = b // n_data
            if key[1] is None:
                np.testing.assert_array_equal(y, wy[d * rb:(d + 1) * rb])
            np.testing.assert_allclose(y, wy[d * rb:(d + 1) * rb],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=str(key))
            np.testing.assert_allclose(g, wg[m * per:(m + 1) * per],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"grad {key}")
