"""The port's scaling study (``esrecsys_tpu_torch/tools/scaling_study.py``)
and the mesh's collective byte counter (``core/mesh.py``).

  * ``efficiency_bound`` equals the JAX package's (the same float64
    arithmetic: equal outright).
  * ``--mode collectives`` on 2 and 4 gloo ranks counts exactly the bytes
    worked out by hand from the sharded step's shapes for the (2, 1) and
    (2, 2) meshes (integers: equal outright).
  * ``--mode measure --device cpu`` runs the fixed-shape step on 1 and 2
    gloo ranks and reports per-step ms and examples/s per process.
"""

import json

import pytest

from esrecsys_tpu.tools import scaling_study as jss
from esrecsys_tpu_torch.core import mesh as mesh_lib
from esrecsys_tpu_torch.tools import scaling_study as tss

# a small shape of the flagship step: B=64 global, C=5, M=8, N=32 shared
# negatives, D=32
SHAPE = dict(batch_size=64, feature_size=32, album_buckets=1000,
             num_artists=500, num_negatives=32, context_size=5, max_next=8,
             corpus=4096, albums_raw=5000)


@pytest.mark.parametrize("args", [(1e6, 2.77e-3, 200e9), (0.0, 1e-3, 1e9),
                                  (5e8, 1e-2, 3.1e9), (3.5e7, 6.8e-3, 450e9)])
def test_efficiency_bound_equals_jax(args):
    assert tss.efficiency_bound(*args) == jss.efficiency_bound(*args)


def test_collective_bytes_counted_by_hand(tmp_path):
    """Per step and data row: b = 64 / n_data playlists, so n = b (5 + 8)
    + 32 ids per table. (2, 1): no model sums; the data group gathers each
    table's ids (2 x n x 4 bytes) and row gradients (2 x n x 32 x 4), and
    averages four float32 metrics. (2, 2): the same, plus each table's
    rows summed over the model group (n x 32 x 4)."""
    n = 32 * 13 + 32                    # 448 ids a table and data row
    gathers = 2 * (2 * n * 4 + 2 * n * 32 * 4)
    want = {
        (2, 1): {"all-gather": {"count": 4, "bytes": gathers},
                 "all-reduce": {"count": 4, "bytes": 16}},
        (2, 2): {"all-gather": {"count": 4, "bytes": gathers},
                 "all-reduce": {"count": 6, "bytes": 16 + 2 * n * 32 * 4}},
    }
    out = tmp_path / "collectives.json"
    report = tss.run_collectives_mode(1.0, str(out), shape=SHAPE,
                                      meshes=list(want), device="cpu")
    assert json.loads(out.read_text()) == report
    assert [tuple(r["mesh"].values()) for r in report["topologies"]] == \
        list(want)
    for row in report["topologies"]:
        mesh = (row["mesh"]["data"], row["mesh"]["model"])
        assert row["collectives"] == want[mesh]
        total = sum(v["bytes"] for v in want[mesh].values())
        assert row["total_collective_bytes_per_step"] == total
        assert row["nvlink"] == tss.efficiency_bound(
            total, 1e-3, tss.NVLINK_BYTES_PER_SEC)
        assert row["nic"] == tss.efficiency_bound(
            total, 1e-3, tss.NIC_BYTES_PER_SEC_PER_CARD)
    assert report["step_ms_given"] == 1.0


def test_collectives_mode_needs_a_step_time_on_the_cpu():
    with pytest.raises(ValueError, match="step_ms is required"):
        tss.run_collectives_mode(None, None, shape=SHAPE, meshes=[(2, 1)],
                                 device="cpu")


def test_measure_mode_runs_one_and_two_ranks(tmp_path):
    report = tss.run_measure_mode(2, str(tmp_path / "m.json"), device="cpu")
    assert [r["processes"] for r in report["rows"]] == [1, 2]
    for row in report["rows"]:
        assert [p["process"] for p in row["per_process"]] == \
            list(range(row["processes"]))
        for p in row["per_process"]:
            assert p["processes"] == row["processes"]
            assert p["step_ms"] > 0 and p["global_examples_per_s"] > 0
    assert report["weak_scaling_step_ratio_1p_over_2p"] > 0


def test_counter_skips_collectives_of_one_rank():
    """A mesh without groups, or a group of one rank, moves no bytes."""
    import torch

    mesh_lib.COLLECTIVE_BYTES.reset()
    m = mesh_lib.Mesh(1, 1, (0,), 0)
    t = torch.ones(4)
    m.sum_model(t), m.sum_data(t), m.mean_data(t), m.gather_model(t)
    m.gather_data(t), m.broadcast_model(t), m.min_model(t)
    assert mesh_lib.COLLECTIVE_BYTES.bytes == {}
    mesh_lib.COLLECTIVE_BYTES.add("all-reduce", 8)
    mesh_lib.COLLECTIVE_BYTES.add("all-reduce", 8)
    assert mesh_lib.COLLECTIVE_BYTES.bytes == {"all-reduce": 16}
    assert mesh_lib.COLLECTIVE_BYTES.count == {"all-reduce": 2}
    mesh_lib.COLLECTIVE_BYTES.reset()
    assert mesh_lib.COLLECTIVE_BYTES.bytes == {}


def test_cli_collectives_on_the_cpu(capsys):
    tss.main(["--mode", "collectives", "--device", "cpu", "--step_ms", "2.0",
              "--meshes", "2x1"] + [x for k, v in SHAPE.items()
                                    for x in (f"--{k}", str(v))])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["topologies"][0]["mesh"] == {"data": 2, "model": 1}
    assert report["topologies"][0]["total_collective_bytes_per_step"] == \
        2 * (2 * 448 * 4 + 2 * 448 * 32 * 4) + 16
