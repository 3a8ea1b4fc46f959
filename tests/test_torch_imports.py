"""The PyTorch port stands alone: no file of ``esrecsys_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, its libraries, TensorFlow, protobuf, an
image library (PIL, OpenCV, imageio, torchvision: the card's machine has
none), a YAML library (it has none either), or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "esrecsys_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "esrecsys_tpu",
             "tensorflow", "google.protobuf", "PIL", "cv2", "imageio",
             "torchvision", "yaml")
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
                "data/protos.py", "models/glove.py", "workloads/glove.py",
                "native/__init__.py", "native/cooccur.cc", "native/text.cc",
                "etl/wiki.py", "etl/dictionary.py", "etl/cooccurrence.py",
                "etl/sparse_docs.py", "tools/codex.py",
                "tools/dump_correlates.py", "models/txt2url.py",
                "workloads/txt2url.py", "native/jpeg.cc", "data/jpeg.py",
                "data/images.py", "models/cnn.py", "workloads/stl.py",
                "retrieval/html.py", "tools/random_recommender.py",
                "etl/fetch_images.py", "serving/encoders.py",
                "core/mesh.py", "parallel/table.py",
                "parallel/sharding.py", "tools/mesh_check.py",
                "kernels/fused_generic.py", "csrc/fused_generic.cu"):
        assert (PORT / rel).is_file(), rel


@pytest.mark.parametrize("name", ["test_torch_wiki_etl.py",
                                  "test_torch_txt2url.py",
                                  "test_torch_jpeg.py", "test_torch_stl.py",
                                  "test_torch_encoders.py",
                                  "test_torch_mesh.py",
                                  "test_torch_sharded.py",
                                  "test_torch_sharded_serving.py",
                                  "test_torch_mesh_workloads.py"])
def test_the_wikipedia_slice_has_its_parity_tests(name):
    """The ETL chain's, txt2url's, the Shop-the-Look pipeline's, the
    encoders', the mesh's, the sharded playlist's, sharded serving's and
    the mesh workloads' parity tests stand beside the modules they hold
    against the JAX package."""
    text = (ROOT / "tests" / name).read_text()
    assert "import esrecsys_tpu" in text or "from esrecsys_tpu." in text
    assert "from esrecsys_tpu_torch" in text


TOOLS = ("tools/sweep.py", "tools/retrieval_autotune.py",
         "tools/parity_runs.py", "tools/playlist_parity_sweep.py",
         "tools/scaling_study.py")


@pytest.mark.parametrize("rel", TOOLS)
def test_the_tools_are_checked(rel):
    """The last tools ported (sweeps, the retrieval autotuner, the parity
    runs and the scaling study) are among the checked sources, beside
    their parity tests, and read no spec file through a YAML library."""
    assert f"esrecsys_tpu_torch/{rel}" in SOURCES
    name = rel.split("/")[1][:-3]
    test = {"sweep": "sweep", "retrieval_autotune": "autotune",
            "parity_runs": "parity_runs",
            "playlist_parity_sweep": "parity_runs",
            "scaling_study": "scaling"}[name]
    text = (ROOT / "tests" / f"test_torch_{test}.py").read_text()
    assert f"esrecsys_tpu_torch.tools import {name}" in text or \
        f"esrecsys_tpu_torch.tools.{name}" in text


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
            "esrecsys_tpu_torch.core.mesh, esrecsys_tpu_torch.parallel.table, "
            "esrecsys_tpu_torch.parallel.sharding, "
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
            "esrecsys_tpu_torch.tools.scale_table, "
            "esrecsys_tpu_torch.native, esrecsys_tpu_torch.etl.wiki, "
            "esrecsys_tpu_torch.etl.dictionary, "
            "esrecsys_tpu_torch.etl.cooccurrence, "
            "esrecsys_tpu_torch.etl.sparse_docs, "
            "esrecsys_tpu_torch.tools.codex, "
            "esrecsys_tpu_torch.tools.dump_correlates, "
            "esrecsys_tpu_torch.models.txt2url, "
            "esrecsys_tpu_torch.workloads.txt2url, "
            "esrecsys_tpu_torch.data.jpeg, esrecsys_tpu_torch.data.images, "
            "esrecsys_tpu_torch.models.cnn, "
            "esrecsys_tpu_torch.workloads.stl, "
            "esrecsys_tpu_torch.retrieval.html, "
            "esrecsys_tpu_torch.tools.random_recommender, "
            "esrecsys_tpu_torch.etl.fetch_images, "
            "esrecsys_tpu_torch.serving.encoders, "
            "esrecsys_tpu_torch.tools.sweep, "
            "esrecsys_tpu_torch.tools.retrieval_autotune, "
            "esrecsys_tpu_torch.tools.parity_runs, "
            "esrecsys_tpu_torch.tools.playlist_parity_sweep, "
            "esrecsys_tpu_torch.tools.scaling_study; "
            "print(sorted(m for m in sys.modules if any(m == f or "
            f"m.startswith(f + '.') for f in {FORBIDDEN!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
