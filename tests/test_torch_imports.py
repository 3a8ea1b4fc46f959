"""The PyTorch port stands alone: no file of ``esrecsys_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, its libraries, TensorFlow, protobuf, or
the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "esrecsys_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "esrecsys_tpu",
             "tensorflow", "google.protobuf")
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_has_the_slice_modules():
    for rel in ("core/device.py", "ops/guards.py", "models/layers.py",
                "models/playlist.py", "train/export.py", "convert.py",
                "retrieval/index.py", "retrieval/mips.py",
                "retrieval/fused.py", "kernels/build.py",
                "kernels/fused_scan.py", "csrc/fused_scan.cu",
                "serving/server.py", "tools/full_scale_run.py",
                "ops/losses.py", "ops/negatives.py", "ops/lookup.py",
                "ops/scatter.py", "ops/optim.py", "ops/metrics.py",
                "kernels/gather_pool.py", "csrc/gather_pool.cu",
                "kernels/scatter_add.py", "csrc/scatter_add.cu",
                "kernels/fused_affinity.py", "csrc/fused_affinity.cu",
                "train/state.py", "train/loop.py", "workloads/playlist.py",
                "kernels/smem_scatter.py", "csrc/smem_scatter.cu",
                "tools/scatter_attempt.py", "core/config.py",
                "core/tracking.py", "core/profiling.py", "data/vocab.py",
                "data/tfrecord.py", "data/pipelines.py", "data/prefetch.py",
                "train/checkpoint.py", "train/preemption.py",
                "etl/playlists.py", "tools/serving_bench.py",
                "retrieval/ivf.py", "retrieval/pq.py",
                "tools/retrieval_quality_study.py", "data/recordio.py",
                "data/protos.py", "models/glove.py", "workloads/glove.py"):
        assert (PORT / rel).is_file(), rel


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_or_reference_import(rel):
    bad = [m for m in _imported_modules(ROOT / rel) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, esrecsys_tpu_torch.serving.server, "
            "esrecsys_tpu_torch.tools.full_scale_run, "
            "esrecsys_tpu_torch.convert, "
            "esrecsys_tpu_torch.workloads.playlist, "
            "esrecsys_tpu_torch.train.loop, esrecsys_tpu_torch.ops.lookup, "
            "esrecsys_tpu_torch.ops.scatter, "
            "esrecsys_tpu_torch.kernels.fused_affinity, "
            "esrecsys_tpu_torch.kernels.smem_scatter, "
            "esrecsys_tpu_torch.tools.scatter_attempt, "
            "esrecsys_tpu_torch.etl.playlists, "
            "esrecsys_tpu_torch.data.pipelines, "
            "esrecsys_tpu_torch.train.checkpoint, "
            "esrecsys_tpu_torch.retrieval.ivf, "
            "esrecsys_tpu_torch.retrieval.pq, "
            "esrecsys_tpu_torch.tools.retrieval_quality_study, "
            "esrecsys_tpu_torch.data.recordio, "
            "esrecsys_tpu_torch.data.protos, "
            "esrecsys_tpu_torch.data.vocab, "
            "esrecsys_tpu_torch.models.glove, "
            "esrecsys_tpu_torch.workloads.glove, "
            "esrecsys_tpu_torch.tools.scale_table; "
            "print(sorted(m for m in sys.modules if any(m == f or "
            f"m.startswith(f + '.') for f in {FORBIDDEN!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
