"""The PyTorch port stands alone: no file of ``esrecsys_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, its libraries, or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "esrecsys_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "esrecsys_tpu")
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


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
                "serving/server.py", "tools/full_scale_run.py"):
        assert (PORT / rel).is_file(), rel


@pytest.mark.parametrize("rel", SOURCES)
def test_no_jax_or_reference_import(rel):
    bad = [m for m in _imported_modules(ROOT / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, esrecsys_tpu_torch.serving.server, "
            "esrecsys_tpu_torch.tools.full_scale_run, "
            "esrecsys_tpu_torch.convert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
